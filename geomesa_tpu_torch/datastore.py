"""In-process data store over the port (≙ ``geomesa_tpu.datastore``).

    store = DataStoreFinder.get_data_store(type="torch", device="cuda")
    store.create_schema("gdelt", "name:String,val:Int,dtg:Date,*geom:Point;"
                        "geomesa.z3.interval=week")
    store.load("gdelt", FeatureTable.build(sft, columns))
    store.count("gdelt", "BBOX(geom, ...) AND dtg DURING ...")
    store.query("gdelt", "INTERSECTS(geom, POLYGON(...)) AND ...").indices
    store.query("gdelt", "dtg DURING ...", hints={"density": {
        "bbox": (-60, -30, 60, 30), "width": 64, "height": 64}}).weights

    # the serving path: concurrent counts coalesce into batched dispatches
    store.count_many("gdelt", [f1, f2, ...])
    store.count_future("gdelt", f1).result(timeout=30)

The device is ``cuda`` unless the caller passes another (``device="cpu"``
runs every kernel's plain version); asking for ``cuda`` without a card
raises. This port holds one bulk load per type in a Z3 index and answers
counts, selects and density heat maps, directly or through the store's
micro-batching scheduler (``serve/scheduler.py``); every other store
feature raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Dict, List, Optional, Union

from geomesa_tpu_torch import config

from geomesa_tpu_torch.aggregates.density import DensityGrid, density
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.features.table import FeatureTable
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.index.api import QueryResult, not_ported
from geomesa_tpu_torch.index.device import resolve
from geomesa_tpu_torch.index.planner import QueryPlanner
from geomesa_tpu_torch.index.spatial import Z3Index
from geomesa_tpu_torch.metrics import REGISTRY as _metrics
from geomesa_tpu_torch.serve.resilience import deadline as _rdl

# store incarnations: every store (and every bare-planner scheduler
# binding) draws a process-unique epoch that salts the scheduler's cache
# keys, so two incarnations with equal generation counters never alias
_EPOCHS = itertools.count(1)


def _next_epoch() -> str:
    return f"{os.getpid():x}d{next(_EPOCHS)}"


class TorchDataStore:
    """Schemas, loaded tables and their planners, on one device."""

    def __init__(self, params: Optional[dict] = None):
        self.params = dict(params or {})
        self.device = resolve(self.params.get("device"))
        self.schemas: Dict[str, SimpleFeatureType] = {}
        self.planners: Dict[str, QueryPlanner] = {}
        self._lock = threading.RLock()
        # per-type mutation generation: the serving caches' invalidation
        # token (a plan or cover cached against generation g is
        # unreachable once a mutation bumps it)
        self._generations: Dict[str, int] = {}
        self.epoch = _next_epoch()
        self._scheduler = None

    @classmethod
    def can_process(cls, params: dict) -> bool:
        return params.get("type") == "torch"

    def create_schema(self, sft: Union[SimpleFeatureType, str],
                      spec: Optional[str] = None) -> SimpleFeatureType:
        if isinstance(sft, str):
            sft = SimpleFeatureType.from_spec(sft, spec or "")
        if sft.name in self.schemas:
            raise ValueError(f"Schema {sft.name} already exists")
        if not Z3Index.supports(sft):
            raise not_ported("schemas without a Point geometry and a Date "
                             "(Z2 and the extent indexes)", 9)
        if any(a.options.get("index", "").lower() in ("true", "full", "join")
               for a in sft.attributes) or sft.user_data.get("geomesa.indices"):
            raise not_ported("attribute and configured indexes", 10)
        with self._lock:
            self.schemas[sft.name] = sft
            self._bump_generation(sft.name)
        return sft

    def load(self, type_name: str, table: FeatureTable) -> None:
        """Bulk-load a columnar table: builds the Z3 index on the device."""
        sft = self.schemas[type_name]
        if type_name in self.planners:
            raise not_ported("appends to a loaded type (the LSM delta tier)", 10)
        planner = QueryPlanner(sft, table, [Z3Index(sft, table, self.device)])
        with self._lock:
            self.planners[type_name] = planner
            self._bump_generation(type_name)

    def planner(self, type_name: str) -> QueryPlanner:
        if type_name not in self.planners:
            raise ValueError(f"No data written to {type_name}")
        return self.planners[type_name]

    def count(self, type_name: str, f: Union[str, ir.Filter] = "INCLUDE",
              auths: Optional[list] = None,
              deadline_ms: Optional[float] = None) -> int:
        """The direct count; ``deadline_ms`` bounds it as the ambient
        request deadline the planner's stages check."""
        with _rdl.scope(deadline_ms):
            return self.planner(type_name).count(f, auths=auths)

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
        """(planner, generation, epoch) captured atomically for the query
        scheduler. The reference's snapshot also carries the type's LSM
        delta, which the port does not have yet (ROADMAP.md Queue 1
        item 10)."""
        with self._lock:
            return (self.planner(type_name),
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
              hints: Optional[dict] = None
              ) -> Union[QueryResult, DensityGrid]:
        """Rows of a filter as a QueryResult; with ``hints={"density":
        {"bbox", "width", "height", "weight"}}`` a DensityGrid heat map of
        the matches instead (width/height default to 256, weight to None)."""
        hints = hints or {}
        unknown = set(hints) - {"density"}
        if unknown:
            raise not_ported(f"query hints {sorted(unknown)}", 10)
        planner = self.planner(type_name)
        if "density" in hints:
            d = dict(hints["density"])
            return density(planner, f, d["bbox"], d.get("width", 256),
                           d.get("height", 256), d.get("weight"))
        return planner.query(f)


class DataStoreFinder:
    """Data store lookup by params (≙ DataStoreFactorySpi discovery);
    ``type="torch"`` selects this port's store."""

    @classmethod
    def get_data_store(cls, **params):
        if TorchDataStore.can_process(params):
            return TorchDataStore(params)
        raise ValueError(f"No datastore factory for params {sorted(params)}")
