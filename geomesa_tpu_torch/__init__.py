"""geomesa-tpu on PyTorch and CUDA: the port of ``geomesa_tpu`` to an
NVIDIA H100.

The JAX package ``geomesa_tpu`` stays unchanged beside this one as the
reference; each module here mirrors its counterpart's path and public names
(``geomesa_tpu_torch/index/compiled.py`` ↔ ``geomesa_tpu/index/compiled.py``)
and imports neither JAX nor the reference. Host layers are numpy copies;
device code is PyTorch, with every TPU kernel of the ported path rewritten
by hand in CUDA for Hopper (``kernels/``).

Ported so far: the Z3 point path — ECQL ``BBOX``/``INTERSECTS(POLYGON)`` +
``DURING`` + attribute predicates, answered as counts, selected rows or
density heat maps by the fused program, or by the staged scan path
(``ScanKernels`` over a range-pruned block cover) for the plans the fused
program does not take, plans without a box among them; and the serving
path: prepared queries with the recipe cache (``planner.prepare``) and the
micro-batching scheduler (``serve/``) behind the store's ``count_many``,
``count_future`` and ``count_coalesced``; the write path (the LSM delta
tier and the merge build); and the Z2, XZ2 and XZ3 indexes of point,
line and polygon layers, with the segment certainty band of
single-segment line layers. See ROADMAP.md for what remains.
"""

__version__ = "0.1.0"

from geomesa_tpu_torch.features.sft import SimpleFeatureType  # noqa: F401
from geomesa_tpu_torch.datastore import DataStoreFinder  # noqa: F401
