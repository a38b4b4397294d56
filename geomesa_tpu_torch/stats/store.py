"""GeoMesaStats facade: cached sketches + exact stat scans.

Copied from ``geomesa_tpu.stats.store`` (host-only) with its imports pointed
at this package; ``update`` observes the battery's sketches concurrently
(each into its own sketch, inserted in the specs' order), ``defer`` leaves
that to the first read of ``cached`` or to ``observe_in_background``'s
thread (which a degraded count starts instead of waiting), ``carry`` takes
a merge build's pre-flush battery over without waiting for it, and the
exact path's device reductions are ``aggregates.stats_scan``'s
``masked_hist`` kernel.

≙ reference `GeoMesaStats` API (geomesa-index-api/.../stats/
GeoMesaStats.scala:30,51-160 — getCount/getBounds/getMinMax/getFrequency/
getTopK/getHistogram with exact|estimated modes) and `MetadataBackedStats`
(MetadataBackedStats.scala:36 — sketches recomputed on write and persisted
with the catalog). Here the durable copy is the JSON-safe ``to_dict`` form
(checkpointed with the catalog); the exact path runs the query engine's
device scan to select rows, then bulk-observes the survivors with vectorized
numpy — the filter *is* the expensive part and it runs on the TPU.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
from geomesa_tpu_torch.features.geometry import GeometryArray
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.stats import sketches as sk
from geomesa_tpu_torch.stats.dsl import observe_table, parse_stat
from geomesa_tpu_torch.stats.estimator import StatsBasedEstimator

_NUMERIC = {"Int", "Integer", "Long", "Float", "Double"}
# tables past this many rows observe the battery's sketches side by side
_SIDE_BY_SIDE = 1 << 20


def default_stat_specs(sft) -> List[str]:
    """The per-type sketch battery computed on write (≙ the stats that
    MetadataBackedStats.writeStat maintains: count, bounds, histograms,
    frequencies for indexed attributes)."""
    specs = ["Count()"]
    geom = sft.geometry_attribute
    dtg = sft.dtg_attribute
    if geom is not None:
        specs.append(f'MinMax("{geom.name}")')
        specs.append(f'Z2Histogram("{geom.name}",5)')
    if dtg is not None:
        specs.append(f'MinMax("{dtg.name}")')
        specs.append(f'Z3Histogram("{dtg.name}","{sft.z3_interval}")')
    for a in sft.attributes:
        if a.is_geometry or (dtg is not None and a.name == dtg.name):
            continue
        specs.append(f'MinMax("{a.name}")')
        if a.type_name == "String":
            specs.append(f'Frequency("{a.name}",12)')
            specs.append(f'TopK("{a.name}")')
    return specs


class GeoMesaStats:
    """Per-feature-type stats: cached estimates + exact scans."""

    def __init__(self, sft, planner=None):
        self.sft = sft
        self.planner = planner  # set by the datastore after index build
        self._cached: Dict[str, sk.Stat] = {}
        # (table, rows): the battery still to observe over the table's
        # first ``rows`` rows at the first read of ``cached`` (``defer``,
        # ``carry``); None once observed
        self._pending: Optional[Tuple[FeatureTable, int]] = None
        self._observe_lock = threading.Lock()
        self._start_lock = threading.Lock()
        self._observer: Optional[threading.Thread] = None
        self.update_s = 0.0     # seconds the last ``update`` took
        self.update_split_s: Dict[str, float] = {}   # by spec (overlapping)

    @property
    def cached(self) -> Dict[str, sk.Stat]:
        """The battery's sketches by spec; a deferred battery is observed
        here at its first read, or by ``observe_in_background``'s thread
        (a reader waits for it on the same lock)."""
        if self._pending is not None:
            with self._observe_lock:
                if self._pending is not None:
                    table, rows = self._pending
                    if rows != len(table):
                        table = table.take(np.arange(rows))
                    self.update(table)
        return self._cached

    @cached.setter
    def cached(self, value: Dict[str, sk.Stat]) -> None:
        self._cached = value
        self._pending = None

    @property
    def observed(self) -> bool:
        """False while the battery waits to be observed. Never blocks."""
        return self._pending is None

    def defer(self, table: FeatureTable, rows: Optional[int] = None) -> None:
        """Observe the battery over ``table``'s first ``rows`` rows (all by
        default) at the first read of ``cached`` instead of now: the same
        sketches, since every observe depends only on the multiset of
        values, with the build no longer paying for them."""
        self._pending = (table, len(table) if rows is None else rows)

    def carry(self, other: "GeoMesaStats", table: FeatureTable) -> None:
        """Take over ``other``'s battery for ``table``, whose leading rows
        are the ones ``other`` describes (a merge build's main table then
        delta): its sketches, or its deferred observe, now over ``table``'s
        same leading rows. Reads ``other`` without its lock, so it never
        waits for ``other``'s observe (at worst both observe once), and
        keeps no reference to ``other``, its planner or its table."""
        pending = other._pending
        if pending is None:
            self.cached = other._cached
        else:
            self.defer(table, pending[1])

    def observe_in_background(self) -> None:
        """Start observing a deferred battery on a daemon thread, once (a
        reader meanwhile waits for it on the same lock); nothing when it is
        observed already."""
        with self._start_lock:
            if self._pending is None or self._observer is not None:
                return
            self._observer = threading.Thread(
                target=lambda: self.cached, name="battery-observe",
                daemon=True)
            self._observer.start()

    # -- write path (≙ statUpdater.add + flush) ------------------------------

    def update(self, table: FeatureTable) -> None:
        """Recompute the default sketch battery over the full table (called
        on writer flush; bulk recompute replaces the reference's incremental
        observe since the columnar build is itself a bulk operation)."""
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        specs = default_stat_specs(self.sft)
        stats = [parse_stat(spec) for spec in specs]

        def observe(stat) -> float:
            t = time.perf_counter()
            observe_table(stat, table)
            return time.perf_counter() - t
        if len(table) <= _SIDE_BY_SIDE:
            took = [observe(stat) for stat in stats]
        else:
            # numpy leaves the GIL in its loops: the sketches observe side
            # by side (their chunked observes use a pool of their own)
            with ThreadPoolExecutor(max_workers=len(stats),
                                    thread_name_prefix="battery") as ex:
                took = list(ex.map(observe, stats))
        self.cached = dict(zip(specs, stats))
        self.update_s = time.perf_counter() - t0
        self.update_split_s = dict(zip(specs, took))

    # -- estimation ----------------------------------------------------------

    @property
    def total(self) -> int:
        c = self.cached.get("Count()")
        return c.count if isinstance(c, sk.CountStat) else 0

    @property
    def estimator(self) -> StatsBasedEstimator:
        return StatsBasedEstimator(self.sft, self.cached, self.total)

    # -- GeoMesaStats API ----------------------------------------------------

    def get_count(self, f: Union[str, ir.Filter, None] = None,
                  exact: bool = False) -> int:
        f = self._filter(f)
        if isinstance(f, ir.Include) and not exact:
            return self.total
        if exact:
            return self.planner.count(f)
        return self.estimator.estimate_count(f)

    def get_bounds(self, f=None, exact: bool = False):
        """(xmin, ymin, xmax, ymax) of the geometry attribute."""
        geom = self.sft.geometry_attribute
        if geom is None:
            return None
        if not exact:
            mm = self._cached_minmax(geom.name)
            if mm is not None and not mm.is_empty:
                return (mm.min[0], mm.min[1], mm.max[0], mm.max[1])
        stat = self.run_stat(f'MinMax("{geom.name}")', f)
        if stat.is_empty:
            return None
        return (stat.min[0], stat.min[1], stat.max[0], stat.max[1])

    def get_min_max(self, attr: str, f=None, exact: bool = False) -> Optional[sk.MinMaxStat]:
        if not exact:
            mm = self._cached_minmax(attr)
            if mm is not None:
                return mm
        return self.run_stat(f'MinMax("{attr}")', f)

    def get_frequency(self, attr: str, f=None, exact: bool = False):
        if not exact:
            fr = self._find_cached("frequency", attr)
            if fr is not None:
                return fr
        return self.run_stat(f'Frequency("{attr}",12)', f)

    def get_top_k(self, attr: str, f=None, exact: bool = False):
        if not exact:
            tk = self._find_cached("topk", attr)
            if tk is not None:
                return tk
        return self.run_stat(f'TopK("{attr}")', f)

    def get_enumeration(self, attr: str, f=None):
        return self.run_stat(f'Enumeration("{attr}")', f)

    def get_histogram(self, attr: str, bins: int = 20, f=None) -> Optional[sk.HistogramStat]:
        """Always an exact scan — endpoints come from the cached MinMax."""
        mm = self.get_min_max(attr, exact=False)
        if mm is None or mm.is_empty or mm.geometric \
                or not isinstance(mm.min, (int, float)):
            return None  # only numeric/date attributes are binnable
        lo, hi = float(mm.min), float(mm.max)
        if hi <= lo:
            hi = lo + 1.0
        return self.run_stat(f'Histogram("{attr}",{bins},{lo},{hi})', f)

    # -- exact stat scans (≙ StatsScan) --------------------------------------

    def run_stat(self, spec: str, f=None, auths=None) -> sk.Stat:
        """Compute a stat over rows matching ``f`` (≙ StatsScan): device
        reductions where the sketch kind supports them, select+observe for
        the rest (see aggregates.stats_scan). ``auths`` restricts to visible
        rows via the device visibility mask."""
        from geomesa_tpu_torch.aggregates.stats_scan import run_stat as _run
        if self.planner is None:
            raise ValueError("stats not attached to a planner")
        return _run(self.planner, spec, self._filter(f), auths=auths)

    # -- helpers -------------------------------------------------------------

    def _filter(self, f) -> ir.Filter:
        if f is None:
            return ir.Include()
        if isinstance(f, str):
            return parse_ecql(f)
        return f

    def _cached_minmax(self, attr: str) -> Optional[sk.MinMaxStat]:
        return self._find_cached("minmax", attr)

    def _find_cached(self, kind: str, attr: str):
        return sk.find_stat(self.cached.values(), kind, attr)

    # -- persistence (checkpointed with the catalog) -------------------------

    def to_dict(self) -> dict:
        return {spec: stat.to_dict() for spec, stat in self.cached.items()}

    @classmethod
    def from_dict(cls, sft, d: dict, planner=None) -> "GeoMesaStats":
        out = cls(sft, planner)
        out.cached = {spec: sk.from_dict(sd) for spec, sd in d.items()}
        return out
