"""Analytic processes over the query engine.

Copied from ``geomesa_tpu.process``
(host-only) with its imports pointed at this package.

≙ reference `geomesa-process` (SURVEY.md §2.9): the WPS surface re-shaped as
plain functions against a planner — KNN, proximity/route search, tube
(space-time corridor) select, point2point track building, unique values,
hash/date-offset utilities. Density, sampling, stats and BIN conversion
live in `geomesa_tpu_torch.aggregates` (they are scan hints, as in the
reference).
"""

from geomesa_tpu_torch.process.geo import (haversine_m,
                                           point_segment_distance_m)
from geomesa_tpu_torch.process.knn import knn
from geomesa_tpu_torch.process.misc import (date_offset, hash_attribute,
                                            point2point, unique_values)
from geomesa_tpu_torch.process.proximity import proximity_search, route_search
from geomesa_tpu_torch.process.tube import tube_select

__all__ = ["date_offset", "hash_attribute", "haversine_m", "knn",
           "point2point", "point_segment_distance_m", "proximity_search",
           "route_search", "tube_select", "unique_values"]
