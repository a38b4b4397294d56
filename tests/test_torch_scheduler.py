"""The port's serving path (geomesa_tpu_torch ``serve/``): the
micro-batching ``QueryScheduler`` and the store's ``count_many`` /
``count_future`` / ``count_coalesced``, against the JAX package's scheduler
on identical state (an 8,000-row table, gather blocks of 512 rows), plus
parity cases for the host-only modules the port copied (metrics, trace,
guards, faults, resilience), each running the reference test's inputs
through both packages.

- ``count_many`` of a mixed list (64 distinct batchable boxes, polygon
  refines, time-only, INCLUDE, an empty window) equals the reference
  scheduler's answers and ``planner.count``'s;
- batching: N requests submitted together fuse into one batch flushed by
  size, a short tail flushes by window — ``stats()`` tallies equal the
  reference's on the same sequence;
- the plan cache hits on a repeat (no ``plan`` span); the cover cache is
  shared across residuals;
- deadlines cancel at submit and at dispatch; admission sheds past its
  bound; injected dispatch errors retry, then open the breaker (which
  closes again through a half-open probe on a fake clock); a killed worker
  and ``shutdown`` fail outstanding futures with structured errors; the
  store replaces an unhealthy scheduler;
- a degraded count (breaker open at submit, a nearly spent deadline on the
  collector thread) never waits for a store's battery that is not yet
  observed: it declines, starts the observe on a thread, and the exact
  route answers; once the battery is observed it equals the reference's
  estimate.

Every thread test waits on ``future.result(timeout=...)``; none sleeps to
synchronise, and only the battery test asserts on wall-clock time (a
submit within 10 s while the battery is held back for 120 s). The port runs with
device="cpu" (the kernels' plain versions).
"""

import random
import threading
import time

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.index import prune as jprune
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

SPEC = ("name:String,age:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-12T00:00:00Z"
BOX = "BBOX(geom, -10, 5, 10, 25) AND " + DURING
N = 8000
WAIT = 30   # seconds any future may take before a test fails


def _pkg(torch_side: bool, name: str):
    import importlib
    return importlib.import_module(
        ("geomesa_tpu_torch." if torch_side else "geomesa_tpu.") + name)


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-60, 60, n)
    y = rng.uniform(-40, 40, n)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + rng.integers(0, 30 * 86400000, n)
    name = rng.choice(["alpha", "beta", "gamma", "delta"], n)
    age = rng.integers(0, 100, n).astype(np.int32)
    score = rng.uniform(0, 1, n).astype(np.float32)
    return {"name": name, "age": age, "score": score, "dtg": dtg,
            "geom": (x, y)}


@pytest.fixture(autouse=True)
def _blocks_and_faults():
    vars(jprune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
    for side in (False, True):
        _pkg(side, "durability.faults").reset()
    yield
    for side in (False, True):
        _pkg(side, "durability.faults").reset()
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()


@pytest.fixture(scope="module")
def world():
    vars(jprune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
    try:
        cols = _columns(N, 17)
        jsft = JSFT.from_spec("t", SPEC)
        jt = JTable.build(jsft, cols)
        jp = JPlanner(jsft, jt, [JZ3(jsft, jt)])
        tsft = TSFT.from_spec("t", SPEC)
        tt = TTable.build(tsft, cols)
        tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
        return jp, tp
    finally:
        for c in (jconfig, tconfig):
            c.PRUNE_BLOCK.unset()


@pytest.fixture(scope="module")
def store():
    tconfig.PRUNE_BLOCK.set(512)
    try:
        ds = DataStoreFinder.get_data_store(type="torch", device="cpu")
        sft = ds.create_schema("t", SPEC)
        ds.load("t", TTable.build(sft, _columns(N, 17)))
    finally:
        tconfig.PRUNE_BLOCK.unset()
    yield ds
    ds.close()


def _sched(torch_side: bool, planner, **kw):
    s = _pkg(torch_side, "serve.scheduler")
    if not torch_side:
        kw.setdefault("result_cache", 0)   # answers must reach the device
    return s.QueryScheduler(s.PlannerBinding({"t": planner}), **kw)


def _boxes(k: int, during: str = DURING):
    return [f"BBOX(geom, {-40 + (i % 8) * 9}, {-30 + (i // 8) * 7}, "
            f"{-25 + (i % 8) * 9 + 0.25 * i}, {-18 + (i // 8) * 7}) "
            f"AND {during}" for i in range(k)]


MIXED = (_boxes(64)
         + [f"INTERSECTS(geom, {POLY}) AND {DURING}",
            f"INTERSECTS(geom, {POLY})",
            f"{DURING} AND age > 40",
            "INCLUDE",
            "BBOX(geom, 0, 0, 20, 20) AND dtg DURING "
            "2020-01-05T00:00:00Z/2020-01-06T00:00:00Z AND dtg DURING "
            "2020-01-08T00:00:00Z/2020-01-09T00:00:00Z",
            "BBOX(geom, -20, -20, 20, 20) AND name = 'beta'"])


def test_count_many_mixed_equals_reference_and_planner(world):
    jp, tp = world
    ref = [tp.count(q) for q in MIXED]
    assert ref == [jp.count(q) for q in MIXED]
    assert ref[-2] == 0 and min(ref[:64]) >= 0 and max(ref[:64]) > 0
    js, ts = _sched(False, jp), _sched(True, tp)
    try:
        assert ts.count_many("t", MIXED, timeout=WAIT) == ref
        assert js.count_many("t", MIXED, timeout=WAIT) == ref
        st = ts.stats()
        assert st["queries"] == len(MIXED)
        assert st["fused"] >= 2 and st["singles"] >= 5
    finally:
        js.shutdown()
        ts.shutdown()


def test_batching_tallies_equal_reference(world):
    """16 compatible requests submitted together fill one batch (flush by
    size); 3 more flush when the window ends. Both packages tally the same
    batches, reasons, histogram and fused count."""
    jp, tp = world
    qs = _boxes(19, "dtg DURING 2020-01-03T00:00:00Z/2020-01-14T00:00:00Z")
    out = {}
    for side, planner in ((False, jp), (True, tp)):
        s = _sched(side, planner, flush_size=16, window_us=300_000)
        try:
            first = [s.submit("t", q) for q in qs[:16]]
            got = [r.result(timeout=WAIT) for r in first]
            tail = [s.submit("t", q) for q in qs[16:]]
            got += [r.result(timeout=WAIT) for r in tail]
            st = s.stats()
            out[side] = (got, {k: st[k] for k in (
                "queries", "batches", "fused", "singles", "flush_reasons",
                "batch_size_hist")})
            assert all(r.batched and r.batch_size == 16 for r in first)
        finally:
            s.shutdown()
    assert out[True] == out[False]
    assert out[True][1]["flush_reasons"] == {"size": 1, "window": 1}
    assert out[True][1]["batch_size_hist"] == {"16": 1, "3": 1}
    assert out[True][0] == [tp.count(q) for q in qs]


def test_concurrent_clients_coalesce_and_agree(world):
    _, tp = world
    s = _sched(True, tp, flush_size=16, window_us=2000)
    qs = _boxes(16)
    ref = {q: tp.count(q) for q in qs}
    outs, errs = [], []
    lock = threading.Lock()

    def client(i):
        try:
            for k in range(4):
                q = qs[(i + k) % len(qs)]
                n = s.count("t", q, timeout=WAIT)
                with lock:
                    outs.append(n == ref[q])
        except Exception as e:  # pragma: no cover - failure detail
            with lock:
                errs.append(e)

    try:
        ts = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        [t.start() for t in ts]
        [t.join(timeout=WAIT) for t in ts]
        assert not any(t.is_alive() for t in ts)
        assert not errs and len(outs) == 64 and all(outs)
    finally:
        s.shutdown()


def test_plan_cache_hit_skips_plan_stage_in_trace(world):
    _, tp = world
    trace = _pkg(True, "trace")
    s = _sched(True, tp, window_us=200)
    try:
        q = "BBOX(geom, -3, -3, 17, 17) AND " + DURING
        ref = tp.count(q)
        trace.RING.clear()
        assert s.count("t", q, timeout=WAIT) == ref
        assert s.count("t", q, timeout=WAIT) == ref
        second, first = trace.RING.recent(2)
        assert "plan" in first["stages_ms"]
        assert "plan" not in second["stages_ms"]
        assert {"queue_wait", "scan"} <= set(second["stages_ms"])
        assert s.plans.hits == 1
    finally:
        s.shutdown()


def test_cover_cache_shared_across_residuals(world):
    _, tp = world
    s = _sched(True, tp, window_us=200)
    try:
        box = "BBOX(geom, -8, -1, 12, 19) AND " + DURING
        qs = [box, box + " AND age > 50", box + " AND name = 'alpha'"]
        got = [s.count("t", q, timeout=WAIT) for q in qs]
        assert got == [tp.count(q) for q in qs]
        assert s.covers.misses == 1 and s.covers.hits == 2
    finally:
        s.shutdown()


def test_expired_deadline_cancelled_at_submit(world):
    _, tp = world
    from geomesa_tpu_torch.serve.resilience.deadline import DeadlineExceeded
    s = _sched(True, tp, window_us=200)
    try:
        with pytest.raises(DeadlineExceeded):
            s.count("t", BOX, deadline_ms=1e-6, timeout=WAIT)
        req = s.submit("t", BOX, deadline_ms=1e-6)
        with pytest.raises(DeadlineExceeded):
            req.result(timeout=WAIT)
        assert req.cancelled and not req.batched and req.scan_s is None
        assert s.stats()["queries"] == 0     # nothing reached the collector
    finally:
        s.shutdown()


def test_deadline_expiring_in_queue_cancels_at_dispatch(world):
    _, tp = world
    faults = _pkg(True, "durability.faults")
    from geomesa_tpu_torch.serve.resilience.deadline import DeadlineExceeded
    s = _sched(True, tp, window_us=200)
    tconfig.DEADLINE_DEGRADE_MS.set(0)
    try:
        faults.arm_serve_delay("sched.collect", seconds=0.15, n=1)
        req = s.submit("t", BOX, deadline_ms=30)
        with pytest.raises(DeadlineExceeded):
            req.result(timeout=WAIT)
        assert req.cancelled and req.plan is None   # never even planned
    finally:
        tconfig.DEADLINE_DEGRADE_MS.unset()
        s.shutdown()


def test_nearly_spent_deadline_runs_exact_without_estimator(world):
    """The degrade floor needs a stats estimator; the port's planners have
    none (as the reference's bare planners), so the request runs exactly."""
    _, tp = world
    s = _sched(True, tp, window_us=200)
    tconfig.DEADLINE_DEGRADE_MS.set(10_000)
    try:
        n = s.count("t", BOX, deadline_ms=5_000, timeout=WAIT)
        assert n == tp.count(BOX) and not getattr(n, "approximate", False)
    finally:
        tconfig.DEADLINE_DEGRADE_MS.unset()
        s.shutdown()


def test_degraded_count_never_waits_for_the_battery(monkeypatch):
    """A store's battery waits for its first read; a degraded count that
    finds it unobserved starts its observe on a thread, held back here
    (``observe_table`` waits on a gate). The first degraded count — at
    submit while the breaker is open, and on the collector thread under a
    nearly spent deadline — declines at once instead of waiting for it:
    the exact route answers (the breaker's fail-fast, then the exact
    count) and the scheduler keeps serving. Once the battery is observed,
    the degraded counts are the reference's estimates again."""
    from geomesa_tpu.datastore import TpuDataStore
    from geomesa_tpu.filter.parser import parse_ecql as jparse
    from geomesa_tpu.serve.resilience import degrade as jdegrade
    store_mod = _pkg(True, "stats.store")
    breaker = _pkg(True, "serve.resilience.breaker")
    gate = threading.Event()
    real = store_mod.observe_table

    def held(*args, **kwargs):
        assert gate.wait(120), "the battery's observe was never released"
        return real(*args, **kwargs)
    monkeypatch.setattr(store_mod, "observe_table", held)
    cols = _columns(N, 17)
    js = TpuDataStore()
    js.load("t", JTable.build(js.create_schema("t", SPEC), cols))
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.load("t", TTable.build(ts.create_schema("t", SPEC), cols))
    tp = ts.planner("t")
    battery = ts._stats["t"]
    exact = tp.count(BOX)
    s = _sched(True, tp, window_us=200)
    clk = [0.0]
    s.breaker = breaker.CircuitBreaker("device_dispatch", threshold=1,
                                       cooldown_ms=50, probes=1,
                                       clock=lambda: clk[0])
    try:
        s.breaker.record_failure()
        assert s.breaker.retry_after_s() > 0
        # at submit with the breaker open: no wait on the held battery
        t0 = time.perf_counter()
        req = s.submit("t", BOX)
        took_s = time.perf_counter() - t0
        assert took_s < 10.0 and not battery.observed and not req.degraded
        assert battery._observer is not None     # its observe has started
        with pytest.raises(breaker.CircuitOpenError):
            req.result(timeout=WAIT)
        clk[0] = 1.0                    # cooldown over: the exact route
        assert s.count("t", BOX, timeout=WAIT) == exact
        # under a nearly spent deadline, on the collector thread (a wait
        # there would outlast the result's timeout: the gate holds 120 s)
        tconfig.DEADLINE_DEGRADE_MS.set(10_000)
        n = s.count("t", BOX, deadline_ms=5_000, timeout=WAIT)
        assert n == exact and not getattr(n, "approximate", False)
        assert [s.count("t", q, timeout=WAIT) for q in _boxes(4)] \
            == [tp.count(q) for q in _boxes(4)]
        assert not battery.observed
        # observed: the degraded counts are the reference's estimates
        gate.set()
        assert battery.total == N and battery.observed
        want = jdegrade.estimate(js.planner("t"), jparse(BOX), "deadline")
        got = s.count("t", BOX, deadline_ms=5_000, timeout=WAIT)
        assert getattr(got, "approximate", False) and got.reason == "deadline"
        assert int(got) == int(want)
        clk[0] = 2.0
        s.breaker.record_failure()      # open again: degraded at submit
        req = s.submit("t", BOX)
        assert req.degraded and req.result(timeout=WAIT) == int(want)
    finally:
        gate.set()
        tconfig.DEADLINE_DEGRADE_MS.unset()
        s.shutdown()
        ts.close()


def test_admission_sheds_past_its_bound(world):
    _, tp = world
    faults = _pkg(True, "durability.faults")
    from geomesa_tpu_torch.serve.resilience.admission import ShedError
    tconfig.ADMIT_INTERACTIVE.set(2)
    s = _sched(True, tp, window_us=200)
    try:
        faults.arm_serve_delay("sched.collect", seconds=0.2, n=1)
        admitted = [s.submit("t", q) for q in _boxes(2)]
        with pytest.raises(ShedError) as ei:
            s.submit("t", BOX)
        assert ei.value.retry_after_s > 0
        assert [r.result(timeout=WAIT) for r in admitted] \
            == [tp.count(q) for q in _boxes(2)]
        assert s.admission.stats()["shed"]["interactive"] == 1
        assert s.count("t", BOX, timeout=WAIT) == tp.count(BOX)
    finally:
        tconfig.ADMIT_INTERACTIVE.unset()
        s.shutdown()


def test_injected_dispatch_errors_retry_then_succeed(world):
    _, tp = world
    faults = _pkg(True, "durability.faults")
    metrics = _pkg(True, "metrics")
    s = _sched(True, tp, window_us=200)
    try:
        c0 = metrics.REGISTRY.snapshot()["counters"].get("retry.attempts", 0)
        faults.arm_serve_error("sched.dispatch", n=2)
        assert s.count("t", BOX, timeout=WAIT) == tp.count(BOX)
        assert metrics.REGISTRY.snapshot()["counters"]["retry.attempts"] \
            >= c0 + 2
    finally:
        s.shutdown()


def test_breaker_opens_on_dispatch_failures_then_recovers(world):
    _, tp = world
    faults = _pkg(True, "durability.faults")
    breaker = _pkg(True, "serve.resilience.breaker")
    tconfig.RETRY_ATTEMPTS.set(1)       # every failure reaches the breaker
    s = _sched(True, tp, window_us=200)
    clk = [0.0]
    s.breaker = breaker.CircuitBreaker("device_dispatch", threshold=2,
                                       cooldown_ms=50, probes=1,
                                       clock=lambda: clk[0])
    try:
        ref = tp.count(BOX)
        assert s.count("t", BOX, timeout=WAIT) == ref
        faults.arm_serve_error("sched.dispatch", n=2)
        for q in _boxes(2):
            with pytest.raises(RuntimeError, match="injected"):
                s.count("t", q, timeout=WAIT)
        assert s.breaker.state == "open"
        faults.reset()
        # open and cooling down: no estimator to degrade to, so the
        # dispatch fails fast at the breaker
        with pytest.raises(breaker.CircuitOpenError):
            s.count("t", BOX, timeout=WAIT)
        clk[0] = 1.0                    # cooldown over: one half-open probe
        assert s.count("t", BOX, timeout=WAIT) == ref
        assert s.breaker.state == "closed"
    finally:
        tconfig.RETRY_ATTEMPTS.unset()
        s.shutdown()


def test_killed_collector_fails_outstanding_futures(world):
    _, tp = world
    faults = _pkg(True, "durability.faults")
    sched = _pkg(True, "serve.scheduler")
    s = _sched(True, tp, flush_size=64, window_us=50_000)
    try:
        faults.arm_serve_crash("sched.collect", at=1)
        reqs = [s.submit("t", q) for q in _boxes(4)]
        for r in reqs:
            with pytest.raises(sched.SchedulerCrashed) as ei:
                r.result(timeout=WAIT)
            assert ei.value.worker == "collector"
        assert not s.healthy()
    finally:
        s.shutdown(timeout=2)


def test_submit_after_a_worker_death_fails_with_its_crash(world):
    """A request submitted once the collector has died resolves with the
    crash (no worker is left to resolve it, and it must not hang)."""
    _, tp = world
    faults = _pkg(True, "durability.faults")
    sched = _pkg(True, "serve.scheduler")
    s = _sched(True, tp, window_us=200)
    try:
        faults.arm_serve_crash("sched.collect", at=1)
        with pytest.raises(sched.SchedulerCrashed):
            s.submit("t", BOX).result(timeout=WAIT)
        assert not s.healthy()
        late = s.submit("t", BOX)
        with pytest.raises(sched.SchedulerCrashed) as ei:
            late.result(timeout=WAIT)
        assert ei.value.worker == "collector"
    finally:
        s.shutdown(timeout=2)


def test_killed_completer_fails_outstanding_futures(world):
    _, tp = world
    faults = _pkg(True, "durability.faults")
    sched = _pkg(True, "serve.scheduler")
    s = _sched(True, tp, window_us=200)
    try:
        faults.arm_serve_crash("sched.complete", at=1)
        req = s.submit("t", BOX)
        with pytest.raises((sched.SchedulerCrashed,
                            sched.SchedulerShutdown)):
            req.result(timeout=WAIT)
        assert not s.healthy()
    finally:
        s.shutdown(timeout=2)


def test_shutdown_fails_outstanding_futures(world):
    _, tp = world
    faults = _pkg(True, "durability.faults")
    sched = _pkg(True, "serve.scheduler")
    s = _sched(True, tp, flush_size=64, window_us=50_000)
    faults.arm_serve_delay("sched.collect", seconds=0.3, n=1)
    reqs = [s.submit("t", f"age < {i}") for i in range(6)]
    s.shutdown(timeout=0.05)   # tighter than the stall: forces the sweep
    for r in reqs:
        with pytest.raises(sched.SchedulerShutdown):
            r.result(timeout=WAIT)
    s.shutdown(timeout=2)      # idempotent
    with pytest.raises(RuntimeError, match="shut down"):
        s.submit("t", BOX)


def test_store_count_many_future_and_coalesced(store):
    planner = store.planner("t")
    qs = MIXED[60:]
    ref = [planner.count(q) for q in qs]
    assert store.count_many("t", qs) == ref
    req = store.count_future("t", qs[1])
    assert req.result(timeout=WAIT) == ref[1] and req.future.done()
    assert store.count_coalesced("t", qs[2]) == ref[2]
    assert store.count_coalesced("t", qs[3], deadline_ms=60_000) == ref[3]
    tconfig.SCHED_ENABLED.set(False)
    try:
        assert store.count_coalesced("t", qs[4]) == ref[4]
    finally:
        tconfig.SCHED_ENABLED.unset()
    g = store.generation("t")
    assert g >= 2 and store._sched_snapshot("t")[1:] == (None, g,
                                                          store.epoch)
    with pytest.raises(ValueError):
        store.count_future("no_such_type", "INCLUDE")


def test_store_replaces_unhealthy_scheduler(store):
    faults = _pkg(True, "durability.faults")
    sched = _pkg(True, "serve.scheduler")
    s = store.scheduler()
    ref = s.count("t", BOX, timeout=WAIT)
    faults.arm_serve_crash("sched.collect", at=1)
    req = s.submit("t", BOX)
    with pytest.raises(sched.SchedulerCrashed):
        req.result(timeout=WAIT)
    faults.reset()
    s2 = store.scheduler()
    assert s2 is not s and s2.healthy()
    assert s2.count("t", BOX, timeout=WAIT) == ref


def test_auths_fail_one_request_naming_roadmap(world):
    """Requests with auths (once failed as ROADMAP.md Queue 1 item 10) run,
    keyed by their auths in the plan cache; over a table without
    visibility labels every auths see every row. Labelled tables:
    ``tests/test_torch_security.py``."""
    _, tp = world
    s = _sched(True, tp, window_us=200)
    try:
        req = s.submit("t", BOX, auths=["admin"])
        assert req.result(timeout=WAIT) == tp.count(BOX, auths=["admin"])
        assert s.count("t", BOX, timeout=WAIT) == tp.count(BOX)
        assert {k[-1] for k in s.plans._d} >= {("admin",), None}
    finally:
        s.shutdown()


# -- parity of the copied host-only modules -----------------------------------


@pytest.mark.parametrize("side", [False, True])
def test_lru_cache_bounded(side):
    s = _pkg(side, "serve.scheduler")
    c = s.LruCache(4, "test.cache")
    for i in range(10):
        c.put(("k", i), i)
    assert c.stats()["size"] == 4
    assert c.get(("k", 0)) is s._MISS
    assert c.get(("k", 9)) == 9


def _metrics_script(m):
    reg = m.MetricsRegistry()
    reg.inc("a.b")
    reg.inc("a.b", 3)
    for v in (1e-6, 2.5e-4, 0.001, 0.004, 0.5):
        reg.observe("op.x", v)
    reg.observe_value("batch", 7)
    reg.set_gauge("g.const", 5)
    reg.set_gauge("g.call", lambda: 11)
    idx = [m.bucket_index(m.BUCKET_BOUNDS[i]) for i in (0, 1, 17, 63)]
    h = m.Histogram()
    for _ in range(9):
        h.observe(m.BUCKET_BOUNDS[20])
    h.observe(m.BUCKET_BOUNDS[40])
    snap = reg.snapshot()
    return (idx, [h.percentile(q) for q in (0.5, 0.9, 0.99)], snap,
            reg.to_prometheus(), m.sanitize_metric_name("scheduler.x-y"))


def test_metrics_copy_equals_reference():
    assert _metrics_script(_pkg(True, "metrics")) \
        == _metrics_script(_pkg(False, "metrics"))


def _trace_script(trace):
    def shape(node):
        return (node["name"], node.get("kind"),
                [shape(c) for c in node.get("children", [])])

    trace.RING.clear()
    with trace.trace("outer", type="t"):
        with trace.trace("inner"):
            with trace.span("leaf", kind="aggregate"):
                pass
        trace.record("plan", "plan", 0.001)
        trace.device_fetch(lambda x: x, lambda: 3)
    with trace.disabled():
        with trace.trace("hidden"):
            pass
    (t,) = trace.RING.recent()
    return shape(t["root"]), sorted(t["stages_ms"])


def test_trace_copy_equals_reference():
    assert _trace_script(_pkg(True, "trace")) \
        == _trace_script(_pkg(False, "trace"))


def _guards_script(side: bool):
    g = _pkg(side, "index.guards")
    parse = _pkg(side, "filter.parser").parse_ecql
    sft = _pkg(side, "features.sft").SimpleFeatureType.from_spec("t", SPEC)
    day = 86400000
    guards = [g.FullTableScanGuard(), g.TemporalQueryGuard(2 * day),
              g.GraduatedQueryGuard([g.SizeAndDuration(100.0, 7 * day),
                                     g.SizeAndDuration(float("inf"), day)])]
    qs = ["INCLUDE", "BBOX(geom, 0, 0, 10, 10)", "age = 3",
          "BBOX(geom, 0, 0, 5, 5) AND dtg DURING "
          "2024-01-01T00:00:00Z/2024-01-06T00:00:00Z",
          "BBOX(geom, -50, -50, 50, 50) AND dtg DURING "
          "2024-01-01T00:00:00Z/2024-01-06T00:00:00Z",
          "BBOX(geom, -50, -50, 50, 50) AND dtg DURING "
          "2024-01-01T00:00:00Z/2024-01-01T12:00:00Z"]
    out = []
    for gd in guards:
        for q in qs:
            try:
                gd.rewrite(parse(q), sft)
                out.append("ok")
            except g.QueryGuardError as e:
                out.append(str(e))
    w = g.AuditWriter(keep=2)
    for i in range(3):
        w.write(g.QueryEvent(type_name="t", filter=f"f{i}", hits=i))
    out.append([e.to_dict() for e in w.events])
    with pytest.raises(g.QueryTimeout):
        d = g.Deadline(0.0)
        d.check("plan")
    return out


def test_guards_copy_equals_reference():
    assert _guards_script(True) == _guards_script(False)


def test_audit_rotation_names_roadmap(tmp_path):
    g = _pkg(True, "index.guards")
    w = g.AuditWriter(str(tmp_path / "audit.jsonl"), max_bytes=64)
    w.write(g.QueryEvent(type_name="t", filter="a" * 80))
    with pytest.raises(NotImplementedError, match="item 15"):
        w.write(g.QueryEvent(type_name="t", filter="b"))


def _faults_script(f):
    out = []
    f.reset()
    f.arm_serve_error("sched.dispatch", n=2)
    for _ in range(3):
        try:
            f.serve_gate("sched.dispatch")
            out.append("pass")
        except RuntimeError as e:
            out.append(str(e))
    f.arm_serve_crash("sched.complete", at=2)
    f.serve_gate("sched.complete")
    try:
        f.serve_gate("sched.complete")
    except f.InjectedCrash as e:
        out.append(e.point)
    with pytest.raises(ValueError):
        f.arm_serve_error("no.such.point")
    out.append(dict(f.hits()))
    out.append((f.SERVE_POINTS, f.CRASH_POINTS))
    f.reset()
    return out


def test_faults_copy_equals_reference_with_its_own_state():
    tf, jf = _pkg(True, "durability.faults"), _pkg(False, "durability.faults")
    assert _faults_script(tf) == _faults_script(jf)
    jf.arm_serve_error("sched.dispatch", n=1)
    tf.serve_gate("sched.dispatch")          # the reference's arming: no-op
    with pytest.raises(RuntimeError):
        jf.serve_gate("sched.dispatch")


def _resilience_script(side: bool):
    br = _pkg(side, "serve.resilience.breaker")
    adm = _pkg(side, "serve.resilience.admission")
    dl = _pkg(side, "serve.resilience.deadline")
    deg = _pkg(side, "serve.resilience.degrade")
    out = []
    clk = [0.0]
    b = br.CircuitBreaker("test", threshold=3, cooldown_ms=1000, probes=2,
                          clock=lambda: clk[0])
    for step in ("f", "f", "f", "allow", 0.5, "allow", 1.1, "allow",
                 "allow", "allow", "s", "s", "f", "f", "f", 2.5, "allow",
                 "f"):
        if isinstance(step, float):
            clk[0] = step
        elif step == "allow":
            out.append(b.allow())
        elif step == "f":
            b.record_failure()
        else:
            b.record_success()
        out.append((b.state, round(b.retry_after_s(), 6)))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    out.append((br.retry_call(flaky, attempts=4, base_ms=0.01, cap_ms=0.02,
                              rng=random.Random(42)), len(calls)))
    ctl = adm.AdmissionController(interactive_limit=2, batch_limit=1)
    for p in ("interactive", "interactive", "interactive", "analytics",
              "batch"):
        try:
            out.append(ctl.admit(p))
        except adm.ShedError as e:
            out.append(("shed", e.retry_after_s > 0))
    ctl.release("interactive")
    out.append(ctl.admit("interactive"))
    st = ctl.stats()
    out.append((st["shed"], st["admitted"]))
    d = dl.Deadline.after_ms(10_000)
    out.append((d.expired, dl.resolve(None, None) is None,
                dl.resolve(None, 1e-6).expired))
    with dl.use(dl.Deadline.after_ms(5)):
        inner = dl.resolve(None, 50_000)
    out.append(inner.remaining_ms() < 10)
    out.append((deg.estimate(object(), None, "deadline"),
                deg.is_approximate(deg.ApproximateCount(5, "x")),
                int(deg.ApproximateCount(5, "x"))))
    return out


def test_resilience_copy_equals_reference():
    assert _resilience_script(True) == _resilience_script(False)
