"""Space-filling curves and binned time (≙ geomesa-z3), host numpy copies
of the reference package's ``curves`` modules that the Z3 point path reads."""

from geomesa_tpu_torch.curves.binnedtime import (  # noqa: F401
    TimePeriod, max_offset, time_to_binned_time)
from geomesa_tpu_torch.curves.normalize import (  # noqa: F401
    BitNormalizedDimension, NormalizedLat, NormalizedLon, NormalizedTime)
from geomesa_tpu_torch.curves.sfc import Z3SFC  # noqa: F401
