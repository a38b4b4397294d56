"""In-process data store over the port (≙ ``geomesa_tpu.datastore``).

    store = DataStoreFinder.get_data_store(type="torch", device="cuda")
    store.create_schema("gdelt", "name:String,val:Int,dtg:Date,*geom:Point;"
                        "geomesa.z3.interval=week")
    store.load("gdelt", FeatureTable.build(sft, columns))
    store.load("gdelt", more)             # lands in the LSM delta tier
    with store.get_writer("gdelt") as w:  # row appends, the same path
        w.write(name="a", val=1, dtg=..., geom="POINT (1 2)",
                vis="admin&(user|ops)")
    store.count("gdelt", "BBOX(geom, ...) AND dtg DURING ...")
    store.query("gdelt", "INTERSECTS(geom, POLYGON(...)) AND ...").indices
    store.query("gdelt", "dtg DURING ...", hints={"density": {
        "bbox": (-60, -30, 60, 30), "width": 64, "height": 64}}).weights
    store.count("gdelt", "IN ('gdelt.1', 'gdelt.7')", auths=["admin"])
    store.query("gdelt", "BBOX(...)", hints={"sort": ["-val", "dtg"],
        "limit": 1000, "transform": ["val", "geom"], "crs": "EPSG:3857"})
    store.query("gdelt", "BBOX(...)", hints={"stats": 'Count();MinMax("val")'})
    store.query("gdelt", "BBOX(...)", hints={"bin": {"track": "name"}})
    store.query("gdelt", "BBOX(...)", hints={"sample": {"n": 10, "by": "name"}})
    store.stats("gdelt").get_count("BBOX(...)")   # estimated from sketches
    knn(store.planner("gdelt"), 2.0, 48.0, 10)    # geomesa_tpu_torch.process
    store.flush("gdelt")                  # merge the delta into the index
    store.upsert("gdelt", batch)          # put by fid
    store.remove_features("gdelt", "val = 7")
    store.update_features("gdelt", "val < 10", {"val": 0})
    store.age_off("gdelt", now_ms)        # geomesa.feature.expiry
    store.explain("gdelt", "name = 'a' AND BBOX(...)", analyze=True)
    store.add_interceptor("gdelt", FullTableScanGuard())
    store.reindex("gdelt"); store.reindex_status("gdelt")
    store.update_schema("gdelt", "extra:Int")
    store.remove_schema("gdelt")

    # the serving path: concurrent counts coalesce into batched dispatches
    store.count_many("gdelt", [f1, f2, ...])
    store.count_future("gdelt", f1).result(timeout=30)

The device is ``cuda`` unless the caller passes another (``device="cpu"``
runs every kernel's plain version); asking for ``cuda`` without a card
raises. Each type holds a main table in its spatial index on the device
— Z3 for points with a date, XZ3 for lines and polygons with a date, Z2
and XZ2 without one, S3 and S2 where ``geomesa.indices`` names them, the
first that ``geomesa.indices`` names when it names some, the full-scan
index when none applies — plus an attribute
index an indexed attribute (``index=true``, or ``attr:<name>`` in
``geomesa.indices``), each a sorted copy of the table on the device; and
an LSM delta tier: small appends land in a host-side delta run that counts,
selects and density grids merge in exactly; a flush (explicit, past the
threshold, or before ``planner()`` hands out a planner) merges the delta
into the index by the incremental merge build
(``BaseSpatialIndex.merge_from``, the ``merge_scatter`` CUDA kernel; a type
with an attribute index rebuilds in full, as in the reference), and the
destructive mutations rebuild it. Features carry visibility labels (the
writer's ``vis``, ``FeatureTable.build(..., visibilities=...)``), and every
read takes the caller's ``auths``; feature-id filters, the shaping hints
(sort, limit, transform, crs) and the aggregation hints (stats, bin,
sample) answer as the reference's. Every full build gives the type a
fresh sketch battery, observed at its first read (``store.stats(type)``:
cached estimates, exact stat scans through the ``masked_hist`` kernel),
which a merge build carries over and the planner prices plans by where
several indexes plan; ``geomesa_tpu_torch.process`` (KNN through the
``topk_nearest`` kernel, proximity, tube, ...) runs on ``store.planner``.
Interceptors and guards (``index/guards.py``) attach a type at a time,
``reindex`` rebuilds a type's indexes off the lock and swaps them in, and
``update_schema``/``remove_schema`` evolve and drop types. Every other
store feature (``open``'s durability, ``cluster_scan``) raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch import trace as _trace
from geomesa_tpu_torch.aggregates.bin import bin_records
from geomesa_tpu_torch.aggregates.density import DensityGrid, density, host_grid
from geomesa_tpu_torch.aggregates.sampling import sample_rows
from geomesa_tpu_torch.features.geometry import GeometryArray
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.evaluate import evaluate
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.index.api import QueryResult, not_ported
from geomesa_tpu_torch.index.attribute import AttributeIndex, indexed_attributes
from geomesa_tpu_torch.index.device import resolve
from geomesa_tpu_torch.index.planner import QueryPlanner
from geomesa_tpu_torch.index.shaping import (reproject_table, shape_local,
                                             shape_rows, transform_table)
from geomesa_tpu_torch.index.spatial import (FullScanIndex,
                                             spatial_index_class)
from geomesa_tpu_torch.metrics import REGISTRY as _metrics
from geomesa_tpu_torch.security.visibility import allowed_codes
from geomesa_tpu_torch.serve.resilience import deadline as _rdl
from geomesa_tpu_torch.stats.store import GeoMesaStats

# store incarnations: every store (and every bare-planner scheduler
# binding) draws a process-unique epoch that salts the scheduler's cache
# keys, so two incarnations with equal generation counters never alias
_EPOCHS = itertools.count(1)


def _next_epoch() -> str:
    return f"{os.getpid():x}d{next(_EPOCHS)}"


def _timeout_ms(sft) -> Optional[float]:
    """The schema's ``geomesa.query.timeout`` (ms) for its planners, as the
    reference's full and merge builds read it; None when unset."""
    timeout = sft.user_data.get("geomesa.query.timeout")
    return float(timeout) if timeout else None


class FeatureWriter:
    """Batch appender (≙ ``geomesa_tpu/datastore.py:50``): collects rows on
    the host; ``flush`` (or leaving the ``with`` block) builds one columnar
    batch and appends it through the store's LSM path."""

    def __init__(self, store: "TorchDataStore", type_name: str):
        self.store = store
        self.type_name = type_name
        self.sft = store.schemas[type_name]
        self._rows: List[dict] = []
        self._fids: List[Optional[str]] = []
        self._vis: List[str] = []

    def write(self, fid: Optional[str] = None, vis: str = "",
              **attributes) -> str:
        """Buffer one feature; returns its fid (``<type>.<n>`` when none is
        given). ``vis``: the feature's visibility expression ('' = public;
        ≙ ``geomesa_tpu/datastore.py:65-67``)."""
        missing = [a.name for a in self.sft.attributes
                   if a.name not in attributes]
        if missing:
            raise ValueError(f"Missing attributes {missing}")
        self._rows.append(attributes)
        if fid is None:
            fid = f"{self.type_name}.{self.store._fid_counter(self.type_name)}"
        self._fids.append(fid)
        self._vis.append(vis)
        return fid

    def flush(self) -> None:
        if not self._rows:
            return
        cols: Dict[str, object] = {}
        for a in self.sft.attributes:
            vals = [row[a.name] for row in self._rows]
            cols[a.name] = GeometryArray.from_rows(vals) \
                if a.is_geometry else vals
        vis = self._vis if any(self._vis) else None
        batch = FeatureTable.build(self.sft, cols, fids=self._fids,
                                   visibilities=vis)
        self.store._append(self.type_name, batch)
        self._rows, self._fids, self._vis = [], [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.flush()


class TorchDataStore:
    """Schemas, tables, LSM deltas and their planners, on one device.

    Concurrency (≙ the reference's): mutators serialize on the store lock
    and build-then-swap — new tables and planners are built fully before a
    shared reference is reassigned, and no FeatureTable or QueryPlanner is
    mutated in place. Readers take one consistent (planner, delta) pair
    under a brief lock (``_snapshot``) and run on the captured objects."""

    def __init__(self, params: Optional[dict] = None):
        self.params = dict(params or {})
        if self.params.get("durability"):
            raise not_ported("durability (the write-ahead log, snapshots "
                             "and recovery)", 15)
        self.device = resolve(self.params.get("device"))
        self.schemas: Dict[str, SimpleFeatureType] = {}
        self.tables: Dict[str, Optional[FeatureTable]] = {}
        self.planners: Dict[str, QueryPlanner] = {}
        # per-type sketch battery (≙ the reference's ``_stats``): a fresh
        # GeoMesaStats with every full build (observed at its first read),
        # carried over by a merge build
        self._stats: Dict[str, GeoMesaStats] = {}
        # LSM delta tier: recent appends held as a small host-side run that
        # queries merge in exactly; flushed into the device-indexed main
        # table past the flush threshold (≙ the Lambda store's hot tier)
        self.deltas: Dict[str, Optional[FeatureTable]] = {}
        self._counters: Dict[str, int] = {}
        self._lock = threading.RLock()
        # per-type mutation generation: the serving caches' invalidation
        # token (a plan or cover cached against generation g is
        # unreachable once a mutation bumps it)
        self._generations: Dict[str, int] = {}
        self.epoch = _next_epoch()
        self._scheduler = None
        # per-type query interceptors and guards, shared by every planner
        # of the type (``add_interceptor``)
        self._interceptors: Dict[str, list] = {}
        # background reindex: the worker thread and the status a type
        self._reindex_threads: Dict[str, threading.Thread] = {}
        self._reindex_status: Dict[str, dict] = {}

    # -- factory SPI ---------------------------------------------------------

    @classmethod
    def can_process(cls, params: dict) -> bool:
        return params.get("type") == "torch"

    @classmethod
    def create(cls, params: dict) -> "TorchDataStore":
        return cls(params)

    @classmethod
    def open(cls, path: str, params: Optional[dict] = None):
        """A durable store at ``path`` (≙ ``geomesa_tpu/datastore.py:185``):
        the write-ahead log, snapshots and recovery are not ported."""
        raise not_ported("durability (TorchDataStore.open: the write-ahead "
                         "log, snapshots and recovery)", 15)

    def cluster_scan(self, type_name: str):
        """The multi-process cluster scan (≙ ``geomesa_tpu/datastore.py
        :882``): the cluster runtime is not ported."""
        raise not_ported("cluster_scan (the multi-process cluster runtime)",
                         14)

    # -- schema lifecycle ----------------------------------------------------

    def create_schema(self, sft: Union[SimpleFeatureType, str],
                      spec: Optional[str] = None) -> SimpleFeatureType:
        if isinstance(sft, str):
            sft = SimpleFeatureType.from_spec(sft, spec or "")
        sft.feature_expiry  # validate up front, not on the first write
        spatial_index_class(sft)   # a configured S2/S3 index raises
        with self._lock:
            if sft.name in self.schemas:
                raise ValueError(f"Schema {sft.name} already exists")
            self.schemas[sft.name] = sft
            self.tables[sft.name] = None
            self._bump_generation(sft.name)
        return sft

    def get_schema(self, type_name: str) -> SimpleFeatureType:
        return self.schemas[type_name]

    def get_type_names(self) -> List[str]:
        return list(self.schemas)

    def remove_schema(self, type_name: str) -> None:
        """Drop a type (≙ ``geomesa_tpu/datastore.py:252-266``): its schema,
        tables, planners, battery, delta, fid counter and interceptors, so a
        type re-created under the name starts fresh; its generation is
        bumped, not dropped, so no cached plan survives."""
        with self._lock:
            self._bump_generation(type_name)
            for d in (self.schemas, self.tables, self.planners, self._stats,
                      self.deltas, self._counters, self._interceptors):
                d.pop(type_name, None)

    def update_schema(self, type_name: str, add_attributes: str = "",
                      new_name: Optional[str] = None) -> SimpleFeatureType:
        """Schema evolution (≙ ``geomesa_tpu/datastore.py:1162-1222``,
        MetadataBackedDataStore.updateSchema): append attributes (spec
        syntax; existing rows take the type's zero or empty value) and/or
        rename the type; a pending delta flushes first, and the indexes and
        battery rebuild over the evolved schema."""
        with self._lock:
            sft = self.schemas[type_name]
            spec = sft.to_spec()
            if add_attributes:
                body = spec.split(";")[0]
                spec = body + "," + add_attributes + spec[len(body):]
            out = SimpleFeatureType.from_spec(new_name or type_name, spec)
            old_names = {a.name for a in sft.attributes}
            for attr in out.attributes:
                if attr.is_geometry and attr.name not in old_names:
                    raise ValueError("Cannot add a geometry attribute")
            spatial_index_class(out)
            table = self.tables.get(type_name)
            if table is not None:
                self.flush(type_name)
                table = self.tables[type_name]
                n = len(table)
                cols: Dict[str, object] = dict(table.columns)
                for attr in out.attributes:
                    if attr.name in cols:
                        continue
                    if attr.type_name == "String":
                        cols[attr.name] = StringColumn(
                            np.zeros(n, np.int32), [""])
                    else:
                        cols[attr.name] = np.zeros(n, dtype=attr.binding)
                new_table = FeatureTable(out, cols, _n=n, _fids=table._fids,
                                         visibility=table.visibility)
            final = new_name or type_name
            if new_name is not None and new_name != type_name:
                if new_name in self.schemas:
                    raise ValueError(f"Schema {new_name} already exists")
                self.remove_schema(type_name)
            self._bump_generation(final)
            self.schemas[final] = out
            self._stats.pop(final, None)
            if table is not None:
                self.tables[final] = new_table
                self.deltas[final] = None
                self._rebuild_indexes(final)
            else:
                self.tables[final] = None
            return out

    def add_interceptor(self, type_name: str, interceptor) -> None:
        """Attach a query interceptor or guard to a type (≙
        ``geomesa_tpu/datastore.py:1069``, the geomesa.query.interceptors
        SPI): every planner of the type, built before or after, rewrites
        and vetoes through it. The type's generation advances, so no plan
        cached before the interceptor came skips it."""
        with self._lock:
            self._interceptors.setdefault(type_name, []).append(interceptor)
            self._bump_generation(type_name)

    # -- writes --------------------------------------------------------------

    def get_writer(self, type_name: str) -> FeatureWriter:
        if type_name not in self.schemas:
            raise KeyError(type_name)
        return FeatureWriter(self, type_name)

    def load(self, type_name: str, table: FeatureTable,
             stats_cached: Optional[dict] = None) -> None:
        """Append a prebuilt columnar table: the first load builds the
        type's spatial index on the device, later ones take the LSM append
        path. ``stats_cached`` (a ``GeoMesaStats.cached`` of sketches, the
        reference's ``from_dict`` ones too) restores a checkpointed battery
        instead of re-observing: a later load carrying one flushes through
        (≙ ``geomesa_tpu/datastore.py:274-279``)."""
        self._append(type_name, table, stats_cached)

    def _append(self, type_name: str, batch: FeatureTable,
                stats_cached: Optional[dict] = None) -> None:
        with self._lock:
            self._append_apply(type_name, batch, stats_cached)

    def _append_apply(self, type_name: str, batch: FeatureTable,
                      stats_cached: Optional[dict] = None) -> None:
        """The LSM append (≙ ``geomesa_tpu/datastore.py:274-349``): a batch
        lands in the host-side delta run while the run stays within
        ``max(50_000, LSM_MAX_FRACTION × main rows)``; past it (or with a
        ``stats_cached`` battery to land) the delta flushes through with
        the batch. Callers hold the lock."""
        _metrics.inc("ingest.features", len(batch))
        self._bump_generation(type_name)
        # already-expired incoming rows never land
        batch, _ = self._apply_age_off(type_name, batch)
        current = self.tables.get(type_name)
        if current is None:
            self.tables[type_name] = batch
            self.deltas[type_name] = None
            with _trace.span("ingest.index_build", kind="aggregate"):
                self._rebuild_indexes(type_name, stats_cached)
            return
        delta = self.deltas.get(type_name)
        merged_delta = batch if delta is None \
            else FeatureTable.concat([delta, batch])
        threshold = max(50_000, int(config.LSM_MAX_FRACTION.get()
                                    * len(current)))
        if stats_cached is not None or len(merged_delta) > threshold:
            _metrics.inc("ingest.flushes")
            self.deltas[type_name] = None
            self._merge_in(type_name, current, merged_delta, stats_cached)
        else:
            # the battery stays main-table-only while a delta is pending
            # (as the reference's); the next flush carries or re-observes it
            _metrics.inc("ingest.delta_appends")
            self.deltas[type_name] = merged_delta

    def _merge_in(self, type_name: str, current: FeatureTable,
                  delta: FeatureTable,
                  stats_cached: Optional[dict] = None) -> None:
        """Main table + delta, aged off, installed: by the incremental merge
        build when nothing aged off, else by a full rebuild."""
        n_old = len(current)
        merged = FeatureTable.concat([current, delta])
        merged, n_exp = self._apply_age_off(type_name, merged)
        if n_exp:
            # checkpointed sketches describe rows age-off just dropped
            stats_cached = None
        with _trace.span("ingest.index_build", kind="aggregate"):
            # age-off drops invalidate the resident sorted run's row
            # identity — only a clean append merges incrementally
            if n_exp or not self._merge_rebuild(type_name, merged, n_old,
                                                stats_cached):
                self.tables[type_name] = merged
                self._rebuild_indexes(type_name, stats_cached)

    def flush(self, type_name: str) -> None:
        """Merge the delta run into the main device index (≙
        ``geomesa_tpu/datastore.py:351``). No-op when the delta is empty."""
        with self._lock:
            delta = self.deltas.get(type_name)
            if delta is None:
                return
            with _trace.span("ingest.flush", kind="aggregate",
                             type=type_name):
                self._bump_generation(type_name)
                self.deltas[type_name] = None
                self._merge_in(type_name, self.tables[type_name], delta)

    def upsert(self, type_name: str, batch: FeatureTable) -> int:
        """Atomic put-by-fid (≙ ``geomesa_tpu/datastore.py:375-431``):
        rows whose fids collide with the batch's are removed, then the
        batch appends — one mutation under one lock hold, idempotent.
        Without a main-table collision the batch rides the LSM append path.
        Returns the rows written."""
        if type_name not in self.schemas:
            raise KeyError(type_name)
        with self._lock, _trace.span("ingest.upsert", kind="aggregate",
                                     type=type_name):
            self._upsert_locked(type_name, batch)
        return len(batch)

    def _upsert_locked(self, type_name: str, batch: FeatureTable) -> None:
        _metrics.inc("ingest.upserts")
        batch_fids = batch.fids
        delta = self.deltas.get(type_name)
        if delta is not None:
            ddup = delta.fid_runs.isin(batch_fids)
            if ddup.any():
                keep = np.flatnonzero(~ddup)
                self.deltas[type_name] = delta.take(keep) if len(keep) \
                    else None
        current = self.tables.get(type_name)
        main_dup = None
        if current is not None and len(current):
            main_dup = current.fid_runs.isin(batch_fids)
            if not main_dup.any():
                main_dup = None
        if main_dup is None:
            self._append_apply(type_name, batch)
            return
        self._bump_generation(type_name)
        current = current.take(np.flatnonzero(~main_dup))
        delta = self.deltas.get(type_name)
        if delta is not None:
            current = FeatureTable.concat([current, delta])
            self.deltas[type_name] = None
        merged = FeatureTable.concat([current, batch]) \
            if len(current) else batch
        merged, _ = self._apply_age_off(type_name, merged)
        self.tables[type_name] = merged
        self._rebuild_indexes(type_name)

    def _apply_age_off(self, type_name: str, table: Optional[FeatureTable],
                       now_ms: Optional[int] = None):
        """(surviving table, n_expired) under the type's
        ``geomesa.feature.expiry`` TTL; no-op without one. Null dates
        (int64 min) never expire."""
        exp = self.schemas[type_name].feature_expiry
        if exp is None or table is None or len(table) == 0:
            return table, 0
        attr, ttl_ms = exp
        now = int(time.time() * 1000) if now_ms is None else int(now_ms)
        vals = np.asarray(table.columns[attr], dtype=np.int64)
        keep = (vals > now - ttl_ms) | (vals == np.iinfo(np.int64).min)
        n_exp = int(len(keep) - keep.sum())
        if n_exp == 0:
            return table, 0
        _metrics.inc("ingest.aged_off", n_exp)
        return table.take(np.flatnonzero(keep)), n_exp

    def age_off(self, type_name: str, now_ms: Optional[int] = None) -> int:
        """Age-off compaction of the main table and the delta (≙
        ``geomesa_tpu/datastore.py:433-482``): drops every row whose TTL
        lapsed at ``now_ms`` (default: now) and rebuilds the index when
        anything dropped or a delta was pending. Returns the rows removed,
        delta rows included."""
        now = int(time.time() * 1000) if now_ms is None else int(now_ms)
        with self._lock, _trace.span("ingest.age_off", kind="aggregate",
                                     type=type_name):
            table = self.tables.get(type_name)
            delta = self.deltas.get(type_name)
            if delta is not None:
                table = FeatureTable.concat([table, delta])
            table2, n = self._apply_age_off(type_name, table, now)
            if n or delta is not None:
                self._bump_generation(type_name)
                self.deltas[type_name] = None
                self.tables[type_name] = table2
                self._rebuild_indexes(type_name)
        return n

    def update_features(self, type_name: str, f: Union[str, ir.Filter],
                        updates: Dict[str, object]) -> int:
        """Set attributes of the matching features and rebuild the index (≙
        ``geomesa_tpu/datastore.py:1076-1160``). ``updates``: attr → a
        scalar, an array (one value a match) or a callable of the matching
        sub-table. Build-then-swap: the patched columns land in a new
        FeatureTable. Returns the rows updated."""
        with self._lock:
            planner = self.planner(type_name)  # flushes any delta first
            rows = planner.select_indices(f)
            if len(rows) == 0:
                return 0
            table = planner.table
            cols: Dict[str, object] = dict(table.columns)
            sub = None
            for name, val in updates.items():
                attr = self.schemas[type_name].attribute(name)
                if callable(val):
                    sub = sub if sub is not None else table.take(rows)
                    val = val(sub)
                col = table.columns[name]
                if isinstance(col, GeometryArray):
                    new = val if isinstance(val, GeometryArray) \
                        else GeometryArray.from_rows(
                            [val] * len(rows) if isinstance(val, str)
                            else list(val))
                    cols[name] = col.replace_rows(rows, new)
                elif isinstance(col, StringColumn):
                    values = np.asarray(col.vocab, dtype=object)[col.codes]
                    values[rows] = val if isinstance(val, str) \
                        else np.asarray([str(v) for v in val], dtype=object)
                    cols[name] = StringColumn.encode(values)
                else:
                    # copy-on-write: loaded tables may alias caller arrays
                    arr = np.array(col, copy=True)
                    if attr.type_name == "Date":
                        v = np.asarray(val)
                        if v.dtype.kind in "MUS":
                            val = v.astype("datetime64[ms]").astype(np.int64)
                    arr[rows] = val
                    cols[name] = arr
            self._bump_generation(type_name)
            self.tables[type_name] = FeatureTable(
                table.sft, cols, _n=len(table), _fids=table._fids,
                visibility=table.visibility)
            self._rebuild_indexes(type_name)
            return int(len(rows))

    def remove_features(self, type_name: str,
                        f: Union[str, ir.Filter]) -> int:
        """Delete the matching features and rebuild the index over the
        survivors (≙ ``geomesa_tpu/datastore.py:1224``). Returns the rows
        removed."""
        with self._lock:
            planner = self.planner(type_name)
            rows = planner.select_indices(f)
            if len(rows) == 0:
                return 0
            keep = np.ones(len(planner.table), dtype=bool)
            keep[rows] = False
            self._bump_generation(type_name)
            self.tables[type_name] = planner.table.take(np.flatnonzero(keep))
            self._rebuild_indexes(type_name)
            return int(len(rows))

    def _fid_counter(self, type_name: str) -> int:
        with self._lock:  # two writers must never share a fid
            c = self._counters.get(type_name, 0)
            self._counters[type_name] = c + 1
            return c

    # -- online build-then-swap reindex ----------------------------------------

    def reindex(self, type_name: str, background: bool = True) -> dict:
        """Rebuild the type's indexes off the serving path and swap the new
        generation in (≙ ``geomesa_tpu/datastore.py:650-759``): readers keep
        the old planner until the install, and the generation bump
        invalidates every serving cache keyed on it. ``background`` returns
        at once with the status (the worker is
        ``_reindex_threads[type_name]``); else it runs here. The
        reference's flight-recorder events and progress phases wait for
        ROADMAP.md Queue 1 item 15."""
        if type_name not in self.schemas:
            raise KeyError(type_name)
        if not background:
            self._reindex_run(type_name)
            return self.reindex_status(type_name)
        with self._lock:
            t = self._reindex_threads.get(type_name)
            if t is not None and t.is_alive():
                return self.reindex_status(type_name)   # already running
            self._reindex_status[type_name] = {"state": "running",
                                               "attempts": 0}
            t = threading.Thread(target=self._reindex_run, args=(type_name,),
                                 name=f"reindex-{type_name}", daemon=True)
            self._reindex_threads[type_name] = t
        t.start()
        return self.reindex_status(type_name)

    def reindex_status(self, type_name: str) -> dict:
        """The type's reindex: ``state`` (idle, running, installed, aborted,
        failed), ``attempts``, and once installed its ``generation``,
        ``rows`` and ``seconds``; ``running`` while the worker lives."""
        with self._lock:
            st = dict(self._reindex_status.get(type_name, {"state": "idle"}))
            t = self._reindex_threads.get(type_name)
            st["running"] = bool(t is not None and t.is_alive())
            return st

    def _reindex_run(self, type_name: str, max_retries: int = 3) -> None:
        """Flush, build a planner off the lock against the captured table,
        and install it if the table is still that one (else retry, up to
        ``max_retries`` attempts). The reference's throttle between the
        stages (``GEOMESA_TPU_REINDEX_THROTTLE_MS``, 0 by default) is left
        out: the build runs flat out."""
        status = {"state": "running", "attempts": 0}
        with self._lock:
            self._reindex_status[type_name] = status
        t0 = time.perf_counter()
        try:
            for attempt in range(1, max_retries + 1):
                status["attempts"] = attempt
                # land a pending delta first, so the rebuilt generation
                # holds every row readers can see
                self.flush(type_name)
                with self._lock:
                    base_table = self.tables.get(type_name)
                if base_table is None:
                    status.update(state="failed", error="no table")
                    return
                planner, stats = self._build_planner(type_name, base_table)
                with self._lock:
                    if self.tables.get(type_name) is not base_table:
                        # a concurrent mutation swapped the table while this
                        # generation built: it describes stale rows
                        _metrics.inc("reindex.aborts")
                        _metrics.inc(f"reindex.aborts.{type_name}")
                        continue
                    self._stats[type_name] = stats
                    self.planners[type_name] = planner
                    self._bump_generation(type_name)
                    gen = self._generations.get(type_name, 0)
                status.update(state="installed", generation=gen,
                              rows=len(base_table),
                              seconds=round(time.perf_counter() - t0, 3))
                _metrics.inc("reindex.installs")
                return
            status.update(state="aborted",
                          seconds=round(time.perf_counter() - t0, 3))
        except Exception as e:  # noqa: BLE001 - surfaced via the status
            status.update(state="failed", error=f"{type(e).__name__}: {e}",
                          seconds=round(time.perf_counter() - t0, 3))
            _metrics.inc("reindex.failures")
            _metrics.inc(f"reindex.failures.{type_name}")

    # -- index builds --------------------------------------------------------

    def _build_planner(self, type_name: str, table: FeatureTable,
                       stats_cached: Optional[dict] = None):
        """A fresh (planner, battery) over ``table``, touching no store
        state — the build half of build-then-swap, safe off the lock (≙
        ``geomesa_tpu/datastore.py:519-555``). The indexes: the spatial one
        (``spatial_index_class``: the first of Z3, XZ3, Z2, XZ2 that
        supports the schema and that ``geomesa.indices`` names), an
        ``AttributeIndex`` an indexed attribute (built from the spatial
        index's device planes), and the full-scan index where no spatial
        index applies or where the spatial index prices its cover above
        the rows (S2/S3's ``cover_slop``: there the reference's
        always-present fallback wins a plan that the cover leaves
        unconstrained, as the reference's planner picks it; beside a Z or
        XZ index it never wins, so the port leaves it out)."""
        sft = self.schemas[type_name]
        indexes: List[object] = []
        c = spatial_index_class(sft)
        if c is not None:
            indexes.append(c(sft, table, self.device))
        base = indexes[0] if indexes else None
        for attr in indexed_attributes(sft):
            indexes.append(AttributeIndex(sft, table, attr, self.device,
                                          base=base))
        if c is None or getattr(c, "cover_slop", 1.0) > 1.0:
            indexes.append(FullScanIndex(sft, table, self.device))
        stats = GeoMesaStats(sft)
        planner = QueryPlanner(
            sft, table, indexes, timeout_ms=_timeout_ms(sft), stats=stats,
            interceptors=self._interceptors.setdefault(type_name, []))
        self._install_battery(stats, planner, table, stats_cached, None)
        return planner, stats

    def _rebuild_indexes(self, type_name: str,
                         stats_cached: Optional[dict] = None) -> None:
        """Full build of the type's indexes over its main table and a fresh
        sketch battery over it (observed at its first read, or
        ``stats_cached`` restored), swapped in once built (callers hold the
        lock)."""
        planner, stats = self._build_planner(type_name, self.tables[type_name],
                                             stats_cached)
        self._stats[type_name] = stats
        self.planners[type_name] = planner

    @staticmethod
    def _install_battery(stats: GeoMesaStats, planner: QueryPlanner,
                         table: FeatureTable, stats_cached: Optional[dict],
                         carried: Optional[GeoMesaStats]) -> None:
        """Fill a new planner's battery: a checkpoint's sketches restored,
        else a merge build's pre-flush battery carried over (it
        under-describes only the delta rows, the drift readers accept while
        a delta is pending), else the whole table's, observed at its first
        read (``GeoMesaStats.defer``) so that the build does not wait on
        it; a degraded count that finds it unobserved declines and starts
        that observe on a thread (``degrade.eligible``)."""
        stats.planner = planner
        if stats_cached is not None:
            stats.cached = stats_cached
        elif carried is not None:
            stats.carry(carried, table)
        else:
            stats.defer(table)

    def _merge_rebuild(self, type_name: str, merged: FeatureTable,
                       n_old: int,
                       stats_cached: Optional[dict] = None) -> bool:
        """Incremental flush (≙ ``geomesa_tpu/datastore.py:574-647``): merge
        the freshly sorted delta run into each resident index
        (``BaseSpatialIndex.merge_from``: S3, S2, Z3, XZ3, Z2, XZ2 and the
        full-scan index) instead of re-sorting the whole table. False when
        ineligible (``MERGE_BUILD`` off, a type with an indexed attribute —
        an attribute index sorts by value, so a suffix delta is no sorted
        run for it, as in the reference, ``geomesa_tpu/datastore.py
        :608-612`` — an empty side, a delta over ``MERGE_MAX_FRACTION`` of
        the main table — counted in ``ingest.merge_fraction_breaches`` — or
        a stale planner): the caller then rebuilds. Callers hold the lock
        and have not installed ``merged`` yet."""
        if not config.MERGE_BUILD.get():
            return False
        n_delta = len(merged) - n_old
        if n_old <= 0 or n_delta <= 0:
            return False
        if n_delta > config.MERGE_MAX_FRACTION.get() * max(1, n_old):
            _metrics.inc("ingest.merge_fraction_breaches")
            _metrics.inc(f"ingest.merge_fraction_breaches.{type_name}")
            return False
        old_planner = self.planners.get(type_name)
        current = self.tables.get(type_name)
        if old_planner is None or current is None or len(current) != n_old \
                or any(idx.table is not current
                       for idx in old_planner.indexes):
            return False
        if indexed_attributes(self.schemas[type_name]):
            return False
        with _trace.span("ingest.merge_build", kind="aggregate",
                         type=type_name):
            indexes = [type(idx).merge_from(idx, merged, n_old)
                       for idx in old_planner.indexes]
            stats = GeoMesaStats(self.schemas[type_name])
            planner = QueryPlanner(self.schemas[type_name], merged, indexes,
                                   timeout_ms=_timeout_ms(
                                       self.schemas[type_name]),
                                   stats=stats,
                                   interceptors=self._interceptors.setdefault(
                                       type_name, []))
            self._install_battery(stats, planner, merged, stats_cached,
                                  self._stats.get(type_name))
            self.tables[type_name] = merged
            self._stats[type_name] = stats
            self.planners[type_name] = planner
        _metrics.inc("ingest.merge_builds")
        return True

    # -- reads ---------------------------------------------------------------

    def planner(self, type_name: str) -> QueryPlanner:
        """The type's QueryPlanner over a fully merged view: a pending delta
        flushes first (≙ ``geomesa_tpu/datastore.py:867-874``). The store's
        own count and query merge the delta inline and never flush."""
        with self._lock:
            self.flush(type_name)
            return self._main_planner(type_name)

    def _main_planner(self, type_name: str) -> QueryPlanner:
        if type_name not in self.planners:
            raise ValueError(f"No data written to {type_name}")
        return self.planners[type_name]

    def stats(self, type_name: str) -> GeoMesaStats:
        """The type's sketch battery and exact stat scans (≙
        ``geomesa_tpu/datastore.py:1064``, GeoMesaDataStore.stats); a
        pending delta flushes first, as ``planner()`` does."""
        self.planner(type_name)
        return self._stats[type_name]

    def _snapshot(self, type_name: str):
        """One consistent (planner, delta) pair, captured under the lock;
        the query then runs lock-free on the captured objects."""
        with self._lock:
            return self._main_planner(type_name), self.deltas.get(type_name)

    def _delta_rows(self, delta: Optional[FeatureTable], f,
                    auths) -> np.ndarray:
        """Matching rows of a snapshotted delta run, evaluated on the host
        in f64 (the delta is bounded small, so brute force is exact), and
        visible to ``auths`` (≙ ``geomesa_tpu/datastore.py:495-517``)."""
        if delta is None:
            return np.empty(0, dtype=np.int64)
        fir = parse_ecql(f) if isinstance(f, str) else f
        rows = np.flatnonzero(evaluate(fir, delta))
        if auths is not None and delta.visibility is not None and len(rows):
            allowed = allowed_codes(delta.visibility.vocab, auths)
            rows = rows[np.isin(delta.visibility.codes[rows], allowed)]
        return rows

    def count(self, type_name: str, f: Union[str, ir.Filter] = "INCLUDE",
              auths: Optional[list] = None,
              deadline_ms: Optional[float] = None) -> int:
        """The direct count over main table and delta; ``deadline_ms``
        bounds it as the ambient request deadline the planner's stages
        check."""
        with _rdl.scope(deadline_ms):
            planner, delta = self._snapshot(type_name)
            c = planner.count(f, auths=auths)
            if delta is not None:
                c += len(self._delta_rows(delta, f, auths))
            return c

    def explain(self, type_name: str, f: Union[str, ir.Filter],
                analyze: bool = False, auths: Optional[list] = None) -> dict:
        """The planner's ``explain`` over the main table, with the pending
        delta's rows (``delta_rows``) and, under ``analyze``, its matches
        merged into the counts as ``count`` merges them (≙
        ``geomesa_tpu/datastore.py:1030-1062``; the live scheduler's cache
        provenance waits for ROADMAP.md Queue 1 item 15)."""
        planner, delta = self._snapshot(type_name)
        out = planner.explain(f, analyze=analyze, auths=auths)
        if delta is not None:
            out["delta_rows"] = len(delta)
            if analyze and "analyze" in out:
                d = int(len(self._delta_rows(delta, f, auths)))
                out["analyze"]["rows_matched"] += d
                out["analyze"]["rows_scanned"] += len(delta)
                out["analyze"]["delta_rows_matched"] = d
        return out

    # -- the serving path ----------------------------------------------------

    def _bump_generation(self, type_name: str) -> None:
        """Advance the type's mutation generation (callers hold the lock)."""
        self._generations[type_name] = self._generations.get(type_name, 0) + 1

    def generation(self, type_name: str) -> int:
        """Current mutation generation — the serving caches' invalidation
        token."""
        with self._lock:
            return self._generations.get(type_name, 0)

    def _sched_snapshot(self, type_name: str):
        """(planner, delta, generation, epoch) captured atomically for the
        query scheduler — the scheduler-side twin of ``_snapshot``; the
        epoch salts its cache keys per store incarnation."""
        with self._lock:
            return (self._main_planner(type_name),
                    self.deltas.get(type_name),
                    self._generations.get(type_name, 0), self.epoch)

    def scheduler(self):
        """The store's micro-batching query scheduler (lazily started; one
        per store). Concurrent counts submitted here coalesce into batched
        device dispatches — see serve/scheduler.py. A scheduler whose
        worker threads died is replaced with a fresh one on next access
        (its outstanding futures were already failed with a structured
        error)."""
        from geomesa_tpu_torch.serve.scheduler import (QueryScheduler,
                                                       StoreBinding)
        with self._lock:
            if self._scheduler is not None and not self._scheduler.healthy():
                _metrics.inc("scheduler.restarts")
                self._scheduler.shutdown(timeout=0.1)
                self._scheduler = None
            if self._scheduler is None:
                self._scheduler = QueryScheduler(StoreBinding(self))
            return self._scheduler

    def count_many(self, type_name: str, filters,
                   auths: Optional[list] = None,
                   deadline_ms: Optional[float] = None,
                   priority: str = "interactive",
                   tenant: Optional[str] = None) -> List[int]:
        """Counts for many filters through the scheduler: compatible queries
        fuse into single batched device dispatches; repeated filters hit
        the plan/cover caches. Order-preserving. ``deadline_ms`` bounds
        every count in the set; ``priority`` classes the work for admission
        control ('interactive' | 'batch'); ``tenant`` labels it for the
        admission's fair share."""
        return self.scheduler().count_many(type_name, filters, auths=auths,
                                           deadline_ms=deadline_ms,
                                           priority=priority, tenant=tenant)

    def count_future(self, type_name: str,
                     f: Union[str, ir.Filter] = "INCLUDE",
                     auths: Optional[list] = None,
                     deadline_ms: Optional[float] = None,
                     priority: str = "interactive"):
        """Async count: submit to the scheduler and return the Request
        handle (``.result()`` blocks; ``.future`` is a concurrent.futures
        Future)."""
        return self.scheduler().submit(type_name, f, auths=auths,
                                       deadline_ms=deadline_ms,
                                       priority=priority)

    def count_coalesced(self, type_name: str,
                        f: Union[str, ir.Filter] = "INCLUDE",
                        auths: Optional[list] = None,
                        deadline_ms: Optional[float] = None,
                        priority: str = "interactive",
                        tenant: Optional[str] = None) -> int:
        """Count via the scheduler when serving coalescing is enabled
        (``GEOMESA_TPU_SCHEDULER``, on by default); otherwise the direct
        per-request path, under the same deadline."""
        if not config.SCHED_ENABLED.get():
            return self.count(type_name, f, auths=auths,
                              deadline_ms=deadline_ms)
        return self.scheduler().count(type_name, f, auths=auths,
                                      deadline_ms=deadline_ms,
                                      priority=priority, tenant=tenant)

    def close(self) -> None:
        """Stop the store's scheduler (its outstanding requests fail with
        SchedulerShutdown)."""
        with self._lock:
            if self._scheduler is not None:
                self._scheduler.shutdown()
                self._scheduler = None

    def query(self, type_name: str, f: Union[str, ir.Filter] = "INCLUDE",
              hints: Optional[dict] = None, auths: Optional[list] = None,
              deadline_ms: Optional[float] = None
              ) -> Union[QueryResult, DensityGrid]:
        """Rows of a filter visible to ``auths`` as a QueryResult; hints
        switch the result form as the reference's (≙
        ``geomesa_tpu/datastore.py:900-1027``):

          hints["density"]   = {"bbox", "width", "height", "weight"}
                               → DensityGrid (width/height 256, weight None
                               by default)
          hints["bin"]       = {"track": attr, "label": attr?, "sort": bool}
                               → packed BIN records
          hints["stats"]     = stat spec string → Stat sketch
          hints["sample"]    = n | {"n": n, "by": attr?} → sampled
                               QueryResult
          hints["sort"]      = attr | "-attr" | [specs] (stable, major-first)
          hints["limit"]     = n (applied before hydration)
          hints["transform"] = ["attr", "out=expr(...)"] (projected type)
          hints["crs"]       = "EPSG:3857" (output reprojection)

        The shaping hints (sort, limit, transform, crs) compose. A pending
        delta merges in inline: its rows stack above the main table's
        (``indices`` past ``len(main table)``), a density adds the
        delta's host grid onto the device grid, and shaping sorts and
        limits main and delta rows together. ``bin``, ``stats`` and
        ``sample`` read ``planner()``, which flushes a pending delta
        first (≙ ``geomesa_tpu/datastore.py:994-1011``); with them the
        shaping hints are ignored, as the reference's."""
        with _rdl.scope(deadline_ms):
            return self._query_impl(type_name, f, hints or {}, auths)

    def _query_impl(self, type_name, f, hints, auths):
        shaping = {"sort", "limit", "transform", "crs"}
        unknown = set(hints) - shaping - {"density", "bin", "stats", "sample"}
        if unknown:
            raise ValueError(f"Unknown hints: {sorted(unknown)}")
        if hints and not shaping.issuperset(hints) and "density" not in hints:
            return self._aggregate(type_name, f, hints, auths)
        planner, delta = self._snapshot(type_name)
        if "density" in hints:
            d = dict(hints["density"])
            grid = density(planner, f, d["bbox"], d.get("width", 256),
                           d.get("height", 256), d.get("weight"),
                           auths=auths)
            if delta is not None:
                grid.weights = grid.weights + host_grid(
                    delta, self._delta_rows(delta, f, auths), d["bbox"],
                    grid.width, grid.height, d.get("weight"))
            return grid
        if hints:
            return self._shaped(planner, delta, f, hints, auths)
        res = planner.query(f, auths=auths)
        if delta is None:
            return res
        drows = self._delta_rows(delta, f, auths)
        n_main = len(planner.table)
        rows = np.concatenate([res.indices, drows + n_main])
        sub = FeatureTable.concat([res.table, delta.take(drows)]) \
            if len(drows) else res.table
        if res.plan is not None:
            res.plan.explain["stacked_rows_base"] = n_main
        return QueryResult(rows, sub, res.plan)

    def _aggregate(self, type_name, f, hints, auths):
        """The ``bin``, ``stats`` and ``sample`` hints (≙
        ``geomesa_tpu/datastore.py:994-1011``), over the merged state."""
        planner = self.planner(type_name)
        if "bin" in hints:
            b = dict(hints["bin"])
            return bin_records(planner, f, b["track"], b.get("label"),
                               b.get("sort", False), auths=auths)
        if "stats" in hints:
            return self.stats(type_name).run_stat(hints["stats"], f,
                                                  auths=auths)
        s = hints["sample"]
        s = {"n": s} if isinstance(s, int) else dict(s)
        plan = planner.plan(f)
        rows = sample_rows(planner, f, s["n"], s.get("by"), plan=plan,
                           auths=auths)
        return QueryResult(rows, planner.table.take(rows), plan)

    def _shaped(self, planner, delta, f, hints, auths) -> QueryResult:
        """The shaping hints (≙ ``geomesa_tpu/datastore.py:948-973``): sort
        and limit on row indices before hydration, over main and delta
        rows together when a delta is pending (merged inline, no flush),
        then the transform and the reprojection of the hydrated rows."""
        plan = planner.plan(f)
        rows = planner.select_indices(f, plan=plan, auths=auths)
        if delta is None:
            rows = shape_rows(planner.table, rows, hints.get("sort"),
                              hints.get("limit"))
            sub = planner.table.take(rows)
        else:
            drows = self._delta_rows(delta, f, auths)
            sub = FeatureTable.concat(
                [planner.table.take(rows), delta.take(drows)])
            rows = np.concatenate([rows, drows + len(planner.table)])
            local = shape_local(sub, hints.get("sort"), hints.get("limit"))
            rows = rows[local]
            sub = sub.take(local)
        if "transform" in hints:
            sub = transform_table(sub, hints["transform"])
        if "crs" in hints:
            sub = reproject_table(sub, hints["crs"])
        return QueryResult(rows, sub, plan)


class DataStoreFinder:
    """Data store lookup by params (≙ DataStoreFactorySpi discovery,
    ``geomesa_tpu/datastore.py:1250-1270``); ``type="torch"`` selects this
    port's store, and ``register`` adds a factory (a class with
    ``can_process(params)`` and ``create(params)``)."""

    _factories: List[type] = [TorchDataStore]

    @classmethod
    def register(cls, factory: type) -> None:
        if factory not in cls._factories:
            cls._factories.append(factory)

    @classmethod
    def get_data_store(cls, **params):
        for factory in cls._factories:
            if factory.can_process(params):
                return factory.create(params)
        raise ValueError(f"No datastore factory for params {sorted(params)}")
