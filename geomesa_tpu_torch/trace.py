"""Query tracing: nested spans, per-query traces, a bounded ring of recents.

Copied from ``geomesa_tpu.trace`` (host-only) with its imports pointed at
this package; ``device_fetch`` takes the blocking function from its caller
(``index/scan.py:_fetch`` reads the result back to the host).

≙ the reference's Explainer threaded through QueryPlanner (every scan
accounts for its plan, ranges, and timings) plus the QueryEvent audit trail
(index/audit/QueryEvent.scala) — upgraded to a span tree so time attributes
to *stages*, not just plan-vs-scan. The load-bearing distinction is
``device_scan`` (dispatch: host work to enqueue the XLA computation) vs
``device_wait`` (time blocked on the result: the readback to the host in the
port, ``block_until_ready`` in the reference): the
dispatch floor and the device compute are different bottlenecks, and BENCH
showed blocking p50 is dispatch/RTT-bound — this layer makes that split
visible per-query.

Span kinds (the fixed vocabulary hot paths use):

  plan             filter parse + strategy selection
  range_decompose  key-range → candidate-block cover computation
  queue_wait       time spent queued in the micro-batching scheduler before
                   its batch dispatched (serve/scheduler.py)
  scan             umbrella execution stage (staging + kernel + readback);
                   its SELF time is constant staging / host glue
  device_scan      kernel dispatch (host-side enqueue, async)
  device_wait      the blocking wait for the dispatched result
  refine           host f64 re-evaluation of device candidates
  aggregate        host-side merge/summarize (density decode, join merge…)
  serialize        row hydration / output encoding
  wal_append       write-ahead-log frame write (durability/wal.py)
  wal_fsync        group-commit fsync (the durability tax, measured)
  recovery         snapshot load + WAL replay at DataStore.open()

Usage::

    with trace("query", type="gdelt", filter=str(f)) as t:
        with span("plan"):
            ...
    RING.recent()          # most-recent-first trace dicts (the audit ring)
    with disabled():       # hot-loop opt-out: spans become no-ops
        ...

Every span (and root trace) also feeds ``metrics.REGISTRY`` as a histogram
timer under its name, so the Prometheus surface gets per-stage percentiles
for free — spans REPLACE the ad-hoc ``REGISTRY.time(...)`` calls on the hot
paths. ``trace()`` nests: opened under an active trace it degrades to a
plain span, so datastore-level and planner-level roots compose.

Thread model: the current trace is thread-local (one query per thread, the
ThreadingHTTPServer model); the ring buffer is process-global and locked.

Every root trace carries a process-stable ``node_id`` and a
globally-unique ``global_id`` (``<node>-<local id>``). The reference's
cross-process propagation (trace headers on proxied queries, remote
parents, node roles) serves its router and web layer, which the port does
not have yet (ROADMAP.md Queue 1 item 15), so it is left out here, as
are the close and device hooks its observability plane installs.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

from geomesa_tpu_torch.metrics import REGISTRY as _REGISTRY

SPAN_KINDS = ("plan", "range_decompose", "queue_wait", "scan", "device_scan",
              "device_wait", "refine", "aggregate", "serialize",
              "wal_append", "wal_fsync", "recovery",
              # query-lifecycle resilience (serve/resilience/): a request
              # cancelled at its deadline BEFORE device dispatch, a count
              # degraded to the stats estimator, a request shed by admission
              # control — the overload test asserts on these leaves
              "cancel", "degrade", "shed",
              # long-running build phase (encode/upload/sort — obs/profiling
              # PROGRESS): a traced ingest that triggers a rebuild
              # attributes the build stages instead of one opaque span
              "build_phase",
              # cross-process collective op (cluster/: psum dispatch,
              # host allgather, barrier, row exchange) — stitched traces
              # show where a distributed query's wall time went
              "collective")

_pc = time.perf_counter  # cached: spans sit on µs-scale hot paths

class _Local(threading.local):
    # class-level defaults make `_local.trace` a plain read on threads that
    # never traced (no getattr-with-default on the hot path)
    trace = None
    stack = None


_local = _Local()
_ids = itertools.count(1)


# -- node identity (the fleet dimension on every trace/event/metric) ----------


class _Node:
    id: Optional[str] = None


def node_id() -> str:
    """Process-stable node identity: GEOMESA_TPU_NODE_ID, else
    ``<short-hostname>-<pid>`` (unique per incarnation on one host — the
    shape localhost fleets and tests produce)."""
    nid = _Node.id
    if nid is None:
        from geomesa_tpu_torch import config
        nid = str(config.NODE_ID.get() or "").strip()
        if not nid:
            try:
                import socket as _socket
                host = _socket.gethostname().split(".")[0]
            except OSError:
                host = "node"
            nid = f"{host}-{os.getpid()}"
        _Node.id = nid
    return nid


class _State:
    enabled = True


_state = _State()


def set_enabled(on: bool) -> None:
    """Globally enable/disable tracing (spans become no-ops when off)."""
    _state.enabled = bool(on)


class disabled:
    """Context manager: suspend tracing AND span→registry feeding inside.
    The perf-budget guard compares against this mode."""

    def __enter__(self):
        self._prev = _state.enabled
        _state.enabled = False
        return self

    def __exit__(self, *exc):
        _state.enabled = self._prev
        return False


class Span:
    """One timed stage. ``self_ms`` is duration minus child durations —
    the time this stage spent NOT delegated to a sub-stage. ``children`` is
    None until the first child attaches (most spans are leaves; the lazy
    list keeps leaf allocation to one object on the hot path)."""

    __slots__ = ("name", "kind", "attrs", "duration_ms", "children")

    def __init__(self, name: str, kind: Optional[str], attrs: Optional[dict]):
        self.name = name
        self.kind = kind if kind is not None else (
            name if name in SPAN_KINDS else "span")
        self.attrs = attrs
        self.duration_ms = 0.0
        self.children: Optional[List[Span]] = None

    def add_child(self, node: "Span") -> None:
        c = self.children
        if c is None:
            self.children = [node]
        else:
            c.append(node)

    @property
    def self_ms(self) -> float:
        if not self.children:
            return self.duration_ms
        return self.duration_ms - sum(c.duration_ms for c in self.children)

    def walk(self) -> Iterator["Span"]:
        yield self
        if self.children:
            for c in self.children:
                yield from c.walk()

    def to_dict(self) -> dict:
        d = {"name": self.name, "kind": self.kind,
             "duration_ms": round(self.duration_ms, 3),
             "self_ms": round(self.self_ms, 3)}
        if self.attrs:
            d["attrs"] = {k: str(v) for k, v in self.attrs.items()}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class QueryTrace:
    """One query's span tree (≙ one QueryEvent, with stage attribution).
    ``error`` is the exception type name when the traced block raised —
    the tail sampler's keep-always signal."""

    __slots__ = ("trace_id", "name", "ts_ms", "root", "error",
                 "_global_id")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.trace_id = next(_ids)
        self.name = name
        self.ts_ms = int(time.time() * 1000)
        self.root = Span(name, "trace", attrs)
        self.error: Optional[str] = None
        # the cross-process id, derived lazily from node + local id
        self._global_id: Optional[str] = None

    @property
    def global_id(self) -> str:
        gid = self._global_id
        if gid is None:
            gid = self._global_id = f"{node_id()}-{self.trace_id}"
        return gid

    @property
    def duration_ms(self) -> float:
        return self.root.duration_ms

    def spans(self) -> Iterator[Span]:
        """Depth-first over every span EXCLUDING the root."""
        for c in self.root.children or ():
            yield from c.walk()

    def kinds(self) -> set:
        return {s.kind for s in self.spans()}

    def self_times_ms(self) -> Dict[str, float]:
        """Total self-time per span kind — the per-stage breakdown."""
        out: Dict[str, float] = {}
        for s in self.spans():
            out[s.kind] = out.get(s.kind, 0.0) + s.self_ms
        return out

    def coverage(self) -> float:
        """Fraction of the root wall time attributed to (non-root) span
        self-times — 1.0 means every microsecond is accounted for."""
        if self.root.duration_ms <= 0:
            return 1.0
        return sum(s.self_ms for s in self.spans()) / self.root.duration_ms

    def to_dict(self) -> dict:
        out = {"id": self.trace_id, "name": self.name, "ts_ms": self.ts_ms,
               "global_id": self.global_id,
               "node": node_id(), "role": "standalone",
               "duration_ms": round(self.duration_ms, 3),
               "stages_ms": {k: round(v, 3)
                             for k, v in self.self_times_ms().items()},
               "root": self.root.to_dict()}
        # the reference adds the cluster's process/shard dimensions here;
        # the port has no cluster runtime yet (ROADMAP.md Queue 1 item 14)
        if self.error is not None:
            out["error"] = self.error
        return out


class TraceRing:
    """Bounded process-global buffer of completed traces (the audit ring;
    ≙ the reference's in-memory audit trail the `_queries` surface reads)."""

    def __init__(self, keep: int = 256):
        self._ring: deque = deque(maxlen=keep)

    def append(self, t: QueryTrace) -> None:
        # lockless: deque appends are GIL-atomic, and this sits on the
        # trace-close hot path; readers retry the mutated-mid-copy race
        self._ring.append(t)

    def recent(self, limit: Optional[int] = None) -> List[dict]:
        """Most-recent-first trace dicts, bounded by ``limit``."""
        while True:
            try:
                items = list(self._ring)
                break
            except RuntimeError:  # mutated during the copy — retry
                continue
        items.reverse()
        if limit is not None:
            items = items[: max(0, int(limit))]
        return [t.to_dict() for t in items]

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


RING = TraceRing()

def current_trace() -> Optional[QueryTrace]:
    return _local.trace


class span:
    """Context manager timing one stage. Attaches to the active trace (when
    one exists) and feeds the metrics registry under ``name`` either way —
    the drop-in replacement for ``REGISTRY.time(name)``. ~µs overhead when
    enabled; a no-op under ``disabled()``."""

    __slots__ = ("name", "kind", "attrs", "_node", "_t0")

    def __init__(self, name: str, kind: Optional[str] = None, **attrs):
        self.name = name
        self.kind = kind
        self.attrs = attrs or None

    def __enter__(self):
        if not _state.enabled:
            self._t0 = None
            return self
        tr = _local.trace
        if tr is not None:
            node = Span(self.name, self.kind, self.attrs)
            stack = _local.stack
            stack[-1].add_child(node)
            stack.append(node)
            self._node = node
        else:
            self._node = None
        self._t0 = _pc()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        dt = _pc() - self._t0
        node = self._node
        if node is not None:
            # under an active trace the registry feed is DEFERRED to trace
            # close (one batched lock acquisition for the whole span tree),
            # keeping per-span exit cost to pure bookkeeping
            node.duration_ms = dt * 1000
            _local.stack.pop()
        else:
            _REGISTRY.observe(self.name, dt)
        return False


def enabled() -> bool:
    return _state.enabled


def _leaf(name: str, kind: str, duration_ms: float) -> Span:
    """Allocate a completed leaf span without the __init__ frame (hot path)."""
    s = Span.__new__(Span)
    s.name = name
    s.kind = kind
    s.attrs = None
    s.duration_ms = duration_ms
    s.children = None
    return s


def record(name: str, kind: str, seconds: float) -> None:
    """Record an already-timed LEAF stage (no children) without context
    manager dispatch — the minimal-overhead hook for µs-scale hot paths.
    Callers gate their own timing on ``enabled()``."""
    tr = _local.trace
    if tr is not None:
        _local.stack[-1].add_child(_leaf(name, kind, seconds * 1000))
    else:
        _REGISTRY.observe(name, seconds)


def device_fetch(block, dispatch, *args):
    """Fused device_scan + device_wait recorder for the kernel hot path:
    ``block(dispatch(*args))`` with both stages timed through ONE function
    call instead of two context managers (the per-query span overhead budget
    is single-digit µs — see tests/test_perf_budget.py)."""
    if not _state.enabled:
        return block(dispatch(*args))
    t0 = _pc()
    out = dispatch(*args)
    t1 = _pc()
    out = block(out)
    t2 = _pc()
    tr = _local.trace
    if tr is not None:
        parent = _local.stack[-1]
        parent.add_child(_leaf("device_scan", "device_scan",
                               (t1 - t0) * 1000))
        parent.add_child(_leaf("device_wait", "device_wait",
                               (t2 - t1) * 1000))
    else:
        _REGISTRY.observe_batch(
            [("device_scan", t1 - t0), ("device_wait", t2 - t1)])
    return out


class trace:
    """Root context manager: opens a QueryTrace, lands it in ``RING`` on
    exit, and feeds the registry timer under ``name``. Re-entrant: under an
    already-active trace it degrades to a nested span (so a datastore-level
    root composes with planner-level instrumentation). Yields the QueryTrace
    (root) or Span (nested) — both expose ``to_dict()`` — or None when
    tracing is disabled."""

    __slots__ = ("name", "attrs", "_t0", "_trace", "_span")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs or None

    def __enter__(self):
        self._trace = self._span = None
        if not _state.enabled:
            self._t0 = None
            return None
        if _local.trace is not None:
            self._span = span(self.name, kind="trace",
                              **(self.attrs or {}))
            return self._span.__enter__()._node
        t = QueryTrace(self.name, self.attrs)
        _local.trace = t
        _local.stack = [t.root]
        self._trace = t
        self._t0 = _pc()
        return t

    def __exit__(self, *exc):
        if self._span is not None:
            return self._span.__exit__(*exc)
        if self._t0 is None:
            return False
        dt = _pc() - self._t0
        t = self._trace
        t.root.duration_ms = dt * 1000
        if exc and exc[0] is not None:
            t.error = exc[0].__name__
        _local.trace = None
        _local.stack = None
        RING.append(t)
        # deferred feed: the whole span tree drains into the histograms at
        # the next snapshot — trace close pays one list append. The trace id
        # rides along so retained traces become bucket exemplars at drain.
        _REGISTRY.feed_tree(t.root, trace_id=t.trace_id)
        return False
