"""Adaptive micro-batching query scheduler + plan/cover caching (the serving
path), ported from ``geomesa_tpu.serve.scheduler``.

Concurrent count requests are grouped by compatible kernel signature (same
index kernels, primary kind, time windows, device residual, pruned or not)
and fused into a single ``counts_multi[_blocks]`` dispatch — one launch of
the ``box_count`` CUDA kernel — over the union of their candidate blocks:

  submit → [plan cache] → micro-batch window → group by kernel key →
  ONE fused device dispatch per group → completion on a second thread

An adaptive window flushes at B queries or T µs, whichever first; the
collector thread plans and dispatches batch N+1 while the completer thread
waits on batch N's readback, so host planning overlaps the device round
trip instead of summing with it. A batch's counts copy into pinned host
memory on the collector's stream right after the launch, behind a CUDA
event the completer waits on (``index.scan.Readback``): the completer never
reads a tensor another stream is still writing.

Caching in front of the batcher:

  plan cache   (epoch, type, generation, normalized filter, auths) → plan.
               A hit skips parse + planning entirely (the trace shows no
               ``plan`` span).
  cover cache  (epoch, type, generation, index, boxes, windows) → candidate
               gather blocks, so filters that differ only in residual
               share one host range decomposition.

Both invalidate through the store's per-type generation counter (bumped by
every mutation: ``create_schema``, ``load`` and the LSM appends, flushes,
upserts, updates, removals and age-offs), and the epoch salts the keys per
store incarnation. A request captures a consistent (planner, delta,
generation) snapshot at submit; the matching rows of its type's pending
LSM delta evaluate on the host and add to its count, so a mid-flush
mutation never pairs a pre-flush plan with post-flush state.

Thread model: callers submit from any thread and block on a per-request
future; one collector thread owns batching/planning/dispatch, one completer
thread owns readbacks and the single-request fallbacks (host residuals such
as the polygon refine, non-box plans, empty covers).

Resilience (``serve/resilience/``): every request may carry a Deadline —
checked at submit and when its batch reaches dispatch, so a request that
timed out in the queue is cancelled before it costs a device round trip;
admission control bounds in-flight work per priority class (interactive
requests dequeue first) and sheds the excess; the device dispatch runs
behind a circuit breaker + capped-jittered retry, and a readback failure
reaches the breaker and the caller's future; a request with (almost) no
budget left — or any count while the breaker is open — degrades to the
stats estimator where the planner has one (the port's planners have none
yet, ROADMAP.md Queue 1 item 12, so such requests run or cancel exactly).
A worker that dies fails every outstanding future with SchedulerCrashed,
and so every request submitted while or after it dies; shutdown fails
what it leaves with SchedulerShutdown.

Left out until the observability plane is ported (ROADMAP.md Queue 1
item 15): ``obs.install()``, the flight recorder's wide events, the
workload cell, kernel attribution and the hot-result cache
(``serve/cache.py``, whose admission reads the workload plane's hot
set). The reference's JAX
transfer-shape warm-up becomes ``compiled.warm_programs`` on the bound
planners' indexes.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Union

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch import trace as _trace
from geomesa_tpu_torch.durability import faults as _faults
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.index.scan import PRIMARY_FNS, Readback
from geomesa_tpu_torch.metrics import REGISTRY as _metrics
from geomesa_tpu_torch.serve.resilience import deadline as _rdl
from geomesa_tpu_torch.serve.resilience import degrade as _degrade
from geomesa_tpu_torch.serve.resilience.admission import (AdmissionController,
                                                          ShedError,
                                                          normalize_priority)
from geomesa_tpu_torch.serve.resilience.breaker import (CircuitBreaker,
                                                        retry_call)
from geomesa_tpu_torch.serve.resilience.deadline import (Deadline,
                                                         DeadlineExceeded)

_pc = time.perf_counter
_MISS = object()
_STOP = object()

# priority-queue ranks: interactive dequeues before batch; _STOP ranks last
# so a graceful shutdown serves already-queued work first
_RANKS = {"interactive": 0, "batch": 1}
_STOP_RANK = 9


def tenant_label(tenant=None, auths=None) -> str:
    """The admission controller's tenant label: the explicit tenant, else
    the first sorted auth, else ``default`` (the reference's
    ``obs.flight.tenant_label``)."""
    if tenant:
        return str(tenant)[:64]
    if auths:
        return "auth:" + sorted(str(a) for a in auths)[0][:56]
    return "default"


class SchedulerCrashed(RuntimeError):
    """A scheduler worker thread died unexpectedly; the outstanding request
    was failed (structured, promptly) rather than left to hang. ``worker``
    names the thread; ``cause`` is the error that killed it."""

    def __init__(self, worker: str, cause: BaseException):
        super().__init__(
            f"scheduler {worker} thread died ({cause!r}); "
            f"outstanding requests failed")
        self.worker = worker
        self.cause = cause


class SchedulerShutdown(RuntimeError):
    """The scheduler was shut down with this request still unresolved."""


# -- caches -------------------------------------------------------------------


class LruCache:
    """Small thread-safe LRU with hit/miss counters fed to the metrics
    registry under ``<prefix>.hits`` / ``<prefix>.misses``. ``capacity <= 0``
    disables the cache (every get misses, puts drop)."""

    def __init__(self, capacity: int, metric_prefix: str):
        self._d: "OrderedDict" = OrderedDict()
        self._cap = int(capacity)
        self._prefix = metric_prefix
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        """Cached value or the module ``_MISS`` sentinel (values may
        legitimately be None — a declined cover)."""
        with self._lock:
            if self._cap > 0 and key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                hit = True
                out = self._d[key]
            else:
                self.misses += 1
                hit = False
                out = _MISS
        _metrics.inc(f"{self._prefix}.hits" if hit else f"{self._prefix}.misses")
        return out

    def put(self, key, value) -> None:
        if self._cap <= 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"size": len(self._d), "capacity": self._cap,
                    "hits": self.hits, "misses": self.misses,
                    "hit_rate": round(self.hits / total, 4) if total else 0.0}


# -- bindings -----------------------------------------------------------------


class StoreBinding:
    """Bind a scheduler to a TorchDataStore: snapshots are (planner, delta,
    generation, epoch) captured atomically w.r.t. the store's mutations;
    delta rows evaluate on the host exactly as the store's own count
    path does."""

    def __init__(self, store):
        self.store = store

    def snapshot(self, type_name: str):
        return self.store._sched_snapshot(type_name)

    def delta_rows(self, delta, f, auths):
        return self.store._delta_rows(delta, f, auths)


class PlannerBinding:
    """Bind a scheduler to bare QueryPlanners (benchmarks and tests — no
    store, one immutable generation). Each binding gets its own epoch so
    two bindings over recycled planner dicts cannot share cache keys."""

    def __init__(self, planners: Dict[str, object]):
        from geomesa_tpu_torch.datastore import _next_epoch
        self._planners = dict(planners)
        self._epoch = _next_epoch()

    def snapshot(self, type_name: str):
        return self._planners[type_name], None, 0, self._epoch

    def delta_rows(self, delta, f, auths):
        return ()


# -- requests -----------------------------------------------------------------


class Request:
    """One in-flight scheduled query. ``result()`` blocks for the count;
    the timing fields feed the caller's trace after resolution.
    ``deadline``/``priority`` are the resilience envelope; ``cancelled`` /
    ``degraded`` say how the request resolved off the exact path."""

    __slots__ = ("type_name", "f_ir", "f_key", "auths", "auths_key",
                 "planner", "delta", "generation", "epoch", "future",
                 "t_submit",
                 "plan", "queue_wait_s", "plan_s", "scan_s", "batched",
                 "batch_size", "deadline", "priority", "tenant",
                 "cancelled", "degraded", "plan_cache_hit",
                 "cover_cache_hit", "batch_id", "rows_scanned", "retries")

    def __init__(self, type_name, f_ir, f_key, auths, auths_key, planner,
                 delta, generation, epoch,
                 deadline: Optional[Deadline] = None,
                 priority: str = "interactive",
                 tenant: Optional[str] = None):
        self.type_name = type_name
        self.f_ir = f_ir
        self.f_key = f_key
        self.auths = auths
        self.auths_key = auths_key
        self.planner = planner
        self.delta = delta
        self.generation = generation
        self.epoch = epoch
        self.future: Future = Future()
        self.t_submit = _pc()
        self.plan = None
        self.queue_wait_s: Optional[float] = None
        self.plan_s: Optional[float] = None
        self.scan_s: Optional[float] = None
        self.batched = False
        self.batch_size = 1
        self.deadline = deadline
        self.priority = priority
        self.tenant = tenant
        self.cancelled = False
        self.degraded = False
        self.plan_cache_hit: Optional[bool] = None
        self.cover_cache_hit: Optional[bool] = None
        self.batch_id: Optional[int] = None
        self.rows_scanned: Optional[int] = None
        self.retries = 0

    def result(self, timeout: Optional[float] = None) -> int:
        return self.future.result(timeout=timeout)


# -- the scheduler ------------------------------------------------------------


class QueryScheduler:
    """Micro-batching count scheduler over one store/planner binding.

    Knobs (config.py system properties; constructor args override):
      flush_size     max queries fused per dispatch (flush-at-B)
      window_us      max collection window (flush-at-T µs, adaptive cap)
      min_window_us  adaptive window floor

    The window adapts from observed batch sizes: sustained single-query
    traffic shrinks it toward the floor (don't tax lone queries with the
    full window), mid-size batches that flush on the window grow it toward
    the cap (coalesce more per round trip), and size-capped flushes leave it
    alone (arrivals already outpace the window).
    """

    def __init__(self, binding, flush_size: Optional[int] = None,
                 window_us: Optional[float] = None,
                 min_window_us: Optional[float] = None,
                 plan_cache: Optional[int] = None,
                 cover_cache: Optional[int] = None):
        from geomesa_tpu_torch.index import compiled as _compiled

        self.binding = binding
        self._flush_size = int(flush_size or config.SCHED_FLUSH_SIZE.get())
        self._max_window_us = float(window_us or config.SCHED_WINDOW_US.get())
        self._min_window_us = float(
            min_window_us or config.SCHED_MIN_WINDOW_US.get())
        self._window_us = self._max_window_us
        self._ema_batch = 1.0
        cap_p = config.SCHED_PLAN_CACHE.get() if plan_cache is None else plan_cache
        cap_c = config.SCHED_COVER_CACHE.get() if cover_cache is None else cover_cache
        self.plans = LruCache(cap_p, "scheduler.plan_cache")
        self.covers = LruCache(cap_c, "scheduler.cover_cache")
        # priority queue: (rank, seq, request) — interactive before batch,
        # FIFO within a class, _STOP after all queued work
        self._queue: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = itertools.count()
        self._batch_ids = itertools.count(1)
        self._done: "queue.Queue" = queue.Queue()
        # resilience: admission bounds + device-dispatch breaker + the
        # registry of every unresolved request (failed en masse if a worker
        # dies or shutdown leaves work behind)
        self.admission = AdmissionController()
        self.breaker = CircuitBreaker("device_dispatch")
        self._outstanding: set = set()
        self._out_lock = threading.Lock()
        self._crash_error: Optional[SchedulerCrashed] = None
        # collector-thread-only tallies (read-only elsewhere)
        self._batch_hist: Dict[int, int] = {}
        self._flush_reasons: Dict[str, int] = {"size": 0, "window": 0}
        self._n_queries = 0
        self._n_batches = 0
        self._n_fused = 0
        self._n_single = 0
        self._running = True
        _metrics.set_gauge("scheduler.queue_depth", self._queue.qsize)
        # the fused single-query path's block summaries and kernels, so a
        # cold query through the scheduler pays neither
        for p in getattr(binding, "_planners", {}).values():
            for idx in getattr(p, "indexes", ()):
                _compiled.warm_programs(idx)
        self._collector = threading.Thread(
            target=self._worker_main, args=("collector", self._collect_loop),
            name="geomesa-sched-collect", daemon=True)
        self._completer = threading.Thread(
            target=self._worker_main, args=("completer", self._complete_loop),
            name="geomesa-sched-complete", daemon=True)
        self._collector.start()
        self._completer.start()

    # -- public API ---------------------------------------------------------

    def submit(self, type_name: str, f: Union[str, ir.Filter] = "INCLUDE",
               auths: Optional[list] = None,
               deadline: Optional[Deadline] = None,
               deadline_ms: Optional[float] = None,
               priority: str = "interactive",
               tenant: Optional[str] = None) -> Request:
        """Enqueue one count; returns a Request whose ``result()`` blocks.
        Parse errors and admission sheds (ShedError) raise here, before
        anything queues. The effective deadline is the sooner of the
        explicit one and any ambient request deadline. ``tenant`` labels
        the request for admission's fair share (falls back to the first
        sorted auth, then 'default')."""
        if not self._running and self._crash_error is None:
            raise RuntimeError("scheduler is shut down")
        f_ir = parse_ecql(f) if isinstance(f, str) else f
        auths_key = None if auths is None \
            else tuple(sorted(str(a) for a in auths))
        planner, delta, gen, epoch = self.binding.snapshot(type_name)
        dl = _rdl.resolve(deadline, deadline_ms)
        req = Request(type_name, f_ir, repr(f_ir), auths, auths_key,
                      planner, delta, gen, epoch, deadline=dl,
                      priority=normalize_priority(priority),
                      tenant=tenant_label(tenant, auths))
        _metrics.inc("scheduler.queries")
        if dl is not None:
            _metrics.observe_value("deadline.remaining_ms",
                                   max(0.0, dl.remaining_ms()))
            if dl.expired:
                # dead on arrival: fail before admission/queue/dispatch
                # spend anything on it
                self._cancel(req, "submit")
                return req
        # retry_after_s > 0 means the breaker is open AND still cooling
        # down (probe-free check: allow() would consume a half-open slot)
        if self.breaker.retry_after_s() > 0 and config.BREAKER_DEGRADE.get():
            approx = _degrade.estimate(planner, f_ir, "breaker_open")
            if approx is not None:
                req.degraded = True
                _metrics.inc("scheduler.degraded")
                req.future.set_result(approx)
                return req
        try:
            cls = self.admission.admit(req.priority, tenant=req.tenant)
        except ShedError as e:
            self._fail(req, e)
            raise
        self._track(req, cls)
        self._queue.put((_RANKS[cls], next(self._seq), req))
        if self._crash_error is not None:
            # a worker died before or while this request queued (its
            # handler's sweep of the outstanding requests may have missed
            # it): no worker will resolve it, so it fails as they did
            self._fail(req, self._crash_error)
        return req

    def count(self, type_name: str, f: Union[str, ir.Filter] = "INCLUDE",
              auths: Optional[list] = None,
              timeout: Optional[float] = None,
              deadline_ms: Optional[float] = None,
              priority: str = "interactive",
              tenant: Optional[str] = None) -> int:
        """Blocking scheduled count. The caller's trace receives queue_wait
        / plan / scan leaves — a plan-cache hit shows NO plan span."""
        with _trace.trace("query.count", type=type_name, filter=str(f),
                          scheduled=True):
            req = self.submit(type_name, f, auths, deadline_ms=deadline_ms,
                              priority=priority, tenant=tenant)
            return self._finish(req, timeout)

    def count_many(self, type_name: str, filters, auths: Optional[list] = None,
                   timeout: Optional[float] = None,
                   deadline_ms: Optional[float] = None,
                   priority: str = "interactive",
                   tenant: Optional[str] = None) -> List[int]:
        """Counts for many filters, submitted together so they coalesce into
        fused dispatches. Order-preserving."""
        with _trace.trace("query.count_many", type=type_name,
                          n=len(filters), scheduled=True):
            reqs = [self.submit(type_name, f, auths, deadline_ms=deadline_ms,
                                priority=priority, tenant=tenant)
                    for f in filters]
            return [self._finish(r, timeout) for r in reqs]

    def _finish(self, req: Request, timeout: Optional[float]) -> int:
        try:
            return req.future.result(timeout=timeout)
        finally:
            if _trace.enabled():
                if req.queue_wait_s is not None:
                    _trace.record("queue_wait", "queue_wait",
                                  req.queue_wait_s)
                if req.plan_s is not None:
                    _trace.record("plan", "plan", req.plan_s)
                if req.scan_s is not None:
                    _trace.record("scan", "scan", req.scan_s)
                if req.cancelled:
                    # the trace-visible proof a timed-out query was dropped
                    # WITHOUT a device round trip: a cancel leaf and no scan
                    _trace.record("cancel", "cancel", 0.0)
                if req.degraded:
                    _trace.record("degrade", "degrade", 0.0)

    # -- resilience plumbing -------------------------------------------------

    def _track(self, req: Request, cls: str) -> None:
        """Register an admitted request as outstanding; the future's done
        callback (fires on every resolution path) releases its admission
        slot and drops it from the registry."""
        with self._out_lock:
            self._outstanding.add(req)

        def _done(_f, req=req, cls=cls):
            self.admission.release(cls, tenant=req.tenant)
            with self._out_lock:
                self._outstanding.discard(req)

        req.future.add_done_callback(_done)

    @staticmethod
    def _resolve(req: Request, value) -> None:
        try:
            req.future.set_result(value)
        except InvalidStateError:
            pass  # already failed by a crash/shutdown sweep — that wins

    @staticmethod
    def _fail(req: Request, exc: BaseException) -> None:
        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            pass

    def _cancel(self, req: Request, stage: str) -> None:
        req.cancelled = True
        _metrics.inc("scheduler.deadline_cancelled")
        overrun = -req.deadline.remaining_ms() if req.deadline else 0.0
        _metrics.observe_value("deadline.overrun_ms", max(0.0, overrun))
        self._fail(req, DeadlineExceeded(stage, max(0.0, overrun)))

    def _fail_outstanding(self, exc: BaseException) -> None:
        """Resolve EVERY unresolved future with ``exc`` — queued, batched,
        or in flight. Callers blocked in result() unblock promptly."""
        with self._out_lock:
            pending = list(self._outstanding)
        for r in pending:
            if not r.future.done():
                self._fail(r, exc)

    def _worker_main(self, which: str, loop) -> None:
        """Thread wrapper: an escaping error (InjectedCrash is a
        BaseException no inner guard may swallow) marks the scheduler
        crashed and fails all outstanding futures instead of silently
        stranding them."""
        try:
            loop()
        except BaseException as e:  # worker death — by injection or bug
            err = SchedulerCrashed(which, e)
            self._crash_error = err
            self._running = False
            _metrics.inc("scheduler.worker_deaths")
            self._fail_outstanding(err)
            # unblock the surviving worker so it can exit
            if which == "collector":
                self._done.put(_STOP)
            else:
                self._queue.put((_STOP_RANK, next(self._seq), _STOP))

    def healthy(self) -> bool:
        """True while both workers are alive and accepting work (the store
        replaces an unhealthy scheduler on next access)."""
        return (self._running and self._collector.is_alive()
                and self._completer.is_alive())

    def stats(self) -> dict:
        """Live scheduler state for the debug surfaces."""
        return {
            "queue_depth": self._queue.qsize(),
            "flush_size": self._flush_size,
            "window_us": round(self._window_us, 1),
            "window_us_max": self._max_window_us,
            "ema_batch": round(self._ema_batch, 2),
            "queries": self._n_queries,
            "batches": self._n_batches,
            "fused": self._n_fused,
            "singles": self._n_single,
            "flush_reasons": dict(self._flush_reasons),
            "batch_size_hist": {str(k): v for k, v in
                                sorted(self._batch_hist.items())},
            "plan_cache": self.plans.stats(),
            "cover_cache": self.covers.stats(),
            "healthy": self.healthy(),
            "admission": self.admission.stats(),
            "breaker": self.breaker.stats(),
        }

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop both threads. Graceful first: already-queued requests are
        served before the stop sentinel (it ranks last in the priority
        queue). Then ANY still-unresolved future — a died worker, a wedged
        device round, work the join timeout abandoned — is failed with a
        structured SchedulerShutdown, so no caller blocked in ``result()``
        ever hangs past shutdown. Idempotent."""
        if self._running:
            self._running = False
            self._queue.put((_STOP_RANK, next(self._seq), _STOP))
        self._collector.join(timeout=timeout)
        if self._completer.is_alive() and not self._collector.is_alive():
            # collector died/stalled without forwarding the sentinel
            self._done.put(_STOP)
        self._completer.join(timeout=timeout)
        self._fail_outstanding(
            self._crash_error
            or SchedulerShutdown("scheduler shut down with this request "
                                 "unresolved"))

    # -- collector thread ---------------------------------------------------

    def _collect_loop(self) -> None:
        while True:
            _, _, req = self._queue.get()
            _faults.serve_gate("sched.collect")
            if req is _STOP:
                self._done.put(_STOP)
                return
            batch = [req]
            t0 = _pc()
            reason = "window"
            stop = False
            while len(batch) < self._flush_size:
                remaining = self._window_us / 1e6 - (_pc() - t0)
                if remaining <= 0:
                    # window expired: drain whatever is ALREADY queued
                    # (no extra wait) — a backlog that arrived during this
                    # window must not fragment into the next one
                    try:
                        while len(batch) < self._flush_size:
                            _, _, nxt = self._queue.get_nowait()
                            if nxt is _STOP:
                                stop = True
                                break
                            batch.append(nxt)
                    except queue.Empty:
                        pass
                    break
                try:
                    _, _, nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            else:
                reason = "size"
            self._account(len(batch), reason)
            try:
                self._dispatch(batch)
            except Exception as e:  # never kill the loop: fail the batch
                for r in batch:
                    self._fail(r, e)
            if stop:
                self._done.put(_STOP)
                return

    def _account(self, n: int, reason: str) -> None:
        self._n_queries += n
        self._n_batches += 1
        self._flush_reasons[reason] += 1
        self._batch_hist[n] = self._batch_hist.get(n, 0) + 1
        _metrics.observe_value("scheduler.batch_size", n)
        _metrics.inc(f"scheduler.flush.{reason}")
        # adaptive window: see class docstring
        self._ema_batch = 0.8 * self._ema_batch + 0.2 * n
        if self._ema_batch <= 1.5:
            self._window_us = max(self._min_window_us, self._window_us * 0.5)
        elif reason == "window" and self._ema_batch < self._flush_size / 2:
            self._window_us = min(self._max_window_us, self._window_us * 1.5)

    def _plan_request(self, req: Request) -> None:
        """Fill ``req.plan`` via the plan cache (cover cached on the plan).
        A cache hit leaves ``req.plan_s`` None — the trace shows no plan
        stage at all."""
        pkey = (req.epoch, req.type_name, req.generation, req.f_key,
                req.auths_key)
        plan = self.plans.get(pkey)
        if plan is not _MISS:
            req.plan = plan
            req.plan_cache_hit = True
            return
        req.plan_cache_hit = False
        t0 = _pc()
        planner = req.planner
        plan = planner._apply_auths(planner.plan(req.f_ir), req.auths)
        self._fill_cover(req, plan, planner)
        req.plan_s = _pc() - t0
        req.plan = plan
        self.plans.put(pkey, plan)

    def _fill_cover(self, req: Request, plan, planner) -> None:
        """Resolve the plan's candidate-block cover through the cover cache
        (keyed purely by the device constraint arrays, so filters differing
        only in residual or auths share one range decomposition)."""
        if plan.blocks is not False:
            return  # already resolved
        if plan.empty or plan.index is None or plan.boxes_loose is None:
            return  # cover never applies; leave lazy
        ckey = (req.epoch, req.type_name, req.generation,
                type(plan.index).__name__,
                plan.boxes_loose.tobytes(),
                None if plan.windows is None else plan.windows.tobytes())
        cached = self.covers.get(ckey)
        if cached is not _MISS:
            plan.blocks = cached
            req.cover_cache_hit = True
            return
        req.cover_cache_hit = False
        blocks = planner._pruned_blocks(plan)
        self.covers.put(ckey, blocks)

    def _dispatch(self, batch: List[Request]) -> None:
        """Group a collected batch by fused-kernel compatibility and launch
        one device dispatch per group; everything else falls back to
        per-query execution on the completer thread."""
        groups: Dict[tuple, List[Request]] = {}
        degrade_floor = config.DEADLINE_DEGRADE_MS.get()
        for r in batch:
            r.queue_wait_s = _pc() - r.t_submit
            if r.deadline is not None:
                rem = r.deadline.remaining_ms()
                if rem < 0:
                    # timed out while queued: cancelled HERE, before any
                    # plan/device work is spent on it
                    self._cancel(r, "dispatch")
                    continue
                if degrade_floor and rem < degrade_floor:
                    # not enough budget for a device round trip — serve
                    # the flagged estimator answer instead (when eligible)
                    approx = _degrade.estimate(r.planner, r.f_ir, "deadline")
                    if approx is not None:
                        r.degraded = True
                        _metrics.inc("scheduler.degraded")
                        self._resolve(r, approx)
                        continue
            try:
                self._plan_request(r)
            except Exception as e:  # parse/guard/plan errors fail one query
                self._fail(r, e)
                continue
            plan = r.plan
            if (plan.device_exact and plan.primary_kind in PRIMARY_FNS
                    and plan.boxes_loose is not None
                    and plan.boxes_loose.shape == (1, 8)):
                pruned = plan.blocks is not None
                rd = plan.residual_device
                wkey = None if plan.windows is None \
                    else (plan.windows.shape[0], plan.windows.tobytes())
                rkey = (rd[0], tuple(
                    (np.asarray(p).dtype.str, np.asarray(p).shape,
                     np.asarray(p).tobytes()) for p in rd[1])) \
                    if rd else None
                gkey = (id(plan.index.kernels), plan.primary_kind,
                        wkey, rkey, pruned)
                groups.setdefault(gkey, []).append(r)
            else:
                self._n_single += 1
                _metrics.inc("scheduler.singles")
                self._done.put(("single", r))
        for gkey, grp in groups.items():
            if len(grp) == 1 and grp[0].plan.blocks is not None \
                    and len(grp[0].plan.blocks) == 0:
                # provably-empty candidate set, nothing to dispatch
                self._done.put(("single", grp[0]))
                continue
            try:
                self._dispatch_group(grp, pruned=gkey[-1])
            except Exception as e:
                for r in grp:
                    self._fail(r, e)

    def _dispatch_group(self, grp: List[Request], pruned: bool) -> None:
        """ONE fused dispatch for a compatible group: per-query boxes stack
        into a (B, 8) array; pruned groups scan the union of their
        candidate blocks (the kernel re-applies the full exact mask, so the
        union cover stays a harmless superset). The counts start their copy
        to the host here, on this thread's stream."""
        from geomesa_tpu_torch.index import prune as _prune

        self._n_fused += len(grp)
        _metrics.inc("scheduler.fused", len(grp))
        _metrics.observe_value("scheduler.fused_size", len(grp))
        lead = grp[0].plan
        kern = lead.index.kernels
        boxes = np.concatenate([r.plan.boxes_loose for r in grp], axis=0)
        batch_id = next(self._batch_ids)
        if pruned:
            nonempty = [r.plan.blocks for r in grp if len(r.plan.blocks)]
            union = np.unique(np.concatenate(nonempty)).astype(np.int32) \
                if nonempty else np.empty(0, dtype=np.int32)
            rows_scanned = int(len(union)) * _prune.BLOCK_SIZE
            disp = kern.prepare_counts_multi_blocks(
                lead.primary_kind, boxes, lead.windows, lead.residual_device,
                union, _prune.BLOCK_SIZE)
        else:
            rows_scanned = kern.n
            disp = kern.prepare_counts_multi(
                lead.primary_kind, boxes, lead.windows, lead.residual_device)
        for r in grp:
            r.batch_id = batch_id
            r.rows_scanned = rows_scanned
        attempts = [0]

        def _launch():
            attempts[0] += 1
            _faults.serve_gate("sched.dispatch")
            return disp()  # enqueue only; the completer waits for it

        t0 = _pc()
        # the device boundary runs behind the breaker + capped-jitter
        # retries: transient dispatch failures retry (and count), a sick
        # device path opens the breaker and subsequent traffic fails fast
        # or degrades instead of piling on
        out = retry_call(_launch, breaker=self.breaker)
        for r in grp:
            r.retries = attempts[0] - 1
        self._done.put(("batch", Readback(out), grp, t0))

    # -- completer thread ---------------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            item = self._done.get()
            if item is _STOP:
                return
            _faults.serve_gate("sched.complete")
            try:
                if item[0] == "batch":
                    self._complete_batch(item[1], item[2], item[3])
                else:
                    self._complete_single(item[1])
            except Exception as e:
                reqs = item[2] if item[0] == "batch" else [item[1]]
                for r in reqs:
                    self._fail(r, e)

    def _complete_batch(self, out: Readback, grp: List[Request],
                        t0: float) -> None:
        # host-side LSM-delta counts first: they overlap the in-flight
        # device round trip instead of adding to it
        extras = [len(self.binding.delta_rows(r.delta, r.f_ir, r.auths))
                  if r.delta is not None else 0 for r in grp]
        _faults.serve_gate("sched.device_wait")
        try:
            counts = out.wait()  # blocks until the batch's counts landed
        except Exception:
            # a readback failure is a device-path failure too (the dispatch
            # already consumed its retries; the breaker learns either way)
            self.breaker.record_failure()
            raise
        scan_s = _pc() - t0
        for i, r in enumerate(grp):
            r.batched = True
            r.batch_size = len(grp)
            r.scan_s = scan_s
            self._resolve(r, int(counts[i]) + extras[i])

    def _complete_single(self, r: Request) -> None:
        """Fallback execution for plans the fused kernel can't serve (host
        residuals, multi-box primaries, non-box plans, empty plans). Runs
        planner._count with the cached plan — the plan work is still
        amortized even off the fused path. The request's deadline rides
        along as the ambient deadline, so the planner's checkpoints fire
        for it too."""
        if r.deadline is not None and r.deadline.expired:
            self._cancel(r, "single")
            return
        t0 = _pc()
        try:
            _faults.serve_gate("sched.single")
            with _rdl.use(r.deadline):
                n = 0 if r.plan.empty \
                    else r.planner._count(r.plan, r.f_ir, r.auths)
                if r.delta is not None:
                    n += len(self.binding.delta_rows(r.delta, r.f_ir,
                                                     r.auths))
        except DeadlineExceeded as e:
            r.cancelled = True
            _metrics.inc("scheduler.deadline_cancelled")
            self._fail(r, e)
            return
        except Exception as e:
            self._fail(r, e)
            return
        r.scan_s = _pc() - t0
        self._resolve(r, int(n))
