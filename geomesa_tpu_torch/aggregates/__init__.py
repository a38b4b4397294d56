"""Server-side aggregations (≙ ``geomesa_tpu.aggregates``): the density
heat map, a masked scatter-add over the scan mask the planner produces, and
the device-side codecs its readback goes through."""

from geomesa_tpu_torch.aggregates.density import DensityGrid, density

__all__ = ["DensityGrid", "density"]
