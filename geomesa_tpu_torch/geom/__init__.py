"""Geometry function catalog (≙ ``geomesa_tpu.geom``) for point layers.

`oracle` — exact f64 numpy semantics of the st_* functions on point
features. `functions` — binds the filter IR's st_* nodes to them.
The device catalog (``geom/catalog.py``) and the joins are ROADMAP.md
Queue 1, item 13.
"""
