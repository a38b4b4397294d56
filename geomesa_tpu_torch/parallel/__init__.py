"""Joins on one device (≙ ``geomesa_tpu.parallel``, its single-device half).

  - ``join``        — the point-in-polygon join: ``PackedPolygons``,
                      ``SpatialJoin`` (``counts``, ``assign``) on the
                      ``pip_join`` kernel
  - ``pair_kernel`` — the extent×extent pair refine: padded segment tables,
                      ``prepare_refine``/``device_refine`` on the
                      ``pair_band`` kernel
  - ``extent_join`` — grid-partitioned extent×extent join + exact refine

The reference shards these over a device mesh (``mesh.ShardedTable``,
``create_mesh``, ``dist``, ``SpatialJoin(..., sharded=)``,
``pair_kernel.mesh_join_pairs``). That half comes with multi-GPU
(ROADMAP.md Queue 1, item 14): the sharded entry points raise naming it,
and ``ShardedTable``/``create_mesh`` are not exported yet.
"""

from geomesa_tpu_torch.parallel.extent_join import (extent_join,
                                                    extent_join_partitioned)

__all__ = ["extent_join", "extent_join_partitioned"]
