"""Geometry function catalog (≙ ``geomesa_tpu.geom``).

`oracle` — exact f64 numpy semantics of the st_* functions over point,
line and polygon features. `catalog` — the device catalog: packed
features through the ``geom_unary``, ``geom_dist`` and ``geom_pred``
kernels (the planner's default route for st_* residuals,
GEOMESA_TPU_GEOM_KERNELS). `functions` — binds the filter IR's st_* nodes
and projections to both. `join` — single-process spatial joins (the
cluster's half is ROADMAP.md Queue 1, item 14).
"""
