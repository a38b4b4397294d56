"""Stats subsystem: sketches, DSL, estimation, exact scans.

Copied from ``geomesa_tpu.stats``
(host-only) with its imports pointed at this package.

≙ reference `geomesa-utils/stats` + `geomesa-index-api/stats` (SURVEY.md
§2.5): the Stat sketch family with a parse-able DSL, cached per-type
summaries maintained on write, selectivity estimation for cost-based query
planning, and exact stat computation driven through the scan engine.
"""

from geomesa_tpu_torch.stats.dsl import observe_table, parse_stat
from geomesa_tpu_torch.stats.estimator import StatsBasedEstimator
from geomesa_tpu_torch.stats.sketches import (
    CountStat, DescriptiveStat, EnumerationStat, FrequencyStat, GroupByStat,
    HistogramStat, HyperLogLog, MinMaxStat, SeqStat, Stat, TopKStat,
    Z2HistogramStat, Z3HistogramStat, from_dict,
)
from geomesa_tpu_torch.stats.store import GeoMesaStats, default_stat_specs

__all__ = [
    "CountStat", "DescriptiveStat", "EnumerationStat", "FrequencyStat",
    "GeoMesaStats", "GroupByStat", "HistogramStat", "HyperLogLog",
    "MinMaxStat", "SeqStat", "Stat", "StatsBasedEstimator", "TopKStat",
    "Z2HistogramStat", "Z3HistogramStat", "default_stat_specs", "from_dict",
    "observe_table", "parse_stat",
]
