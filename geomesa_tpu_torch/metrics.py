"""Metrics/observability: counters, histogram timers, gauges, reporters.

Copied from ``geomesa_tpu.metrics`` (host-only) with its imports pointed at
this package; the device gauges read ``torch.cuda``.

≙ the reference's converter ingest metrics + audit surface (SURVEY.md §5:
dropwizard metrics with graphite/cloudwatch/ganglia reporters in
geomesa-convert-metrics-*; QueryEvent audit records in index/audit/
QueryEvent.scala:13). Here a process-local registry collects ingest and
query counters/timers; ``snapshot()`` serializes for the CLI/REST surface,
``to_prometheus()`` emits the text exposition format, and ``add_reporter``
hooks a callable for external sinks (the graphite-reporter slot).

Timers are fixed-bucket log-scale histograms (dropwizard's reservoir slot):
bucket upper bounds grow geometrically by 2^0.25 from 1µs, so percentiles
carry ≤ ~19% relative error at O(bytes) cost and zero allocation per
observation. ``percentile()`` returns the UPPER BOUND of the bucket holding
the rank-th observation (deterministic, never an interpolated value that no
observation produced).

Reset semantics (the snapshot/reset race): ``reset()`` bumps a generation
counter; a ``time()`` block that STRADDLES a reset is discarded at exit
rather than resurrecting its name with a lost count — post-reset snapshots
only ever contain observations that started after the reset.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

# -- histogram geometry ------------------------------------------------------

_BUCKET_MIN_S = 1e-6          # first bucket: everything <= 1µs
_BUCKET_FACTOR = 2.0 ** 0.25  # ~19% resolution per bucket
_N_BUCKETS = 128              # reaches 1e-6 * 2^(127/4) ≈ 3.3e3 s

# upper (inclusive) bound of each bucket; the last is +inf-in-spirit
BUCKET_BOUNDS: tuple = tuple(
    _BUCKET_MIN_S * _BUCKET_FACTOR ** i for i in range(_N_BUCKETS))


def bucket_index(seconds: float) -> int:
    """First bucket whose upper bound >= seconds (exact via bisect — no
    float-log boundary jitter)."""
    i = bisect.bisect_left(BUCKET_BOUNDS, seconds)
    return min(i, _N_BUCKETS - 1)


def sanitize_metric_name(name: str) -> str:
    """Dotted registry name -> prometheus metric name (shared by the
    process exposition and the federated fleet exposition, so the same
    series keeps the same name in both)."""
    return "geomesa_tpu_" + "".join(
        c if c.isalnum() or c == "_" else "_" for c in name)


class Histogram:
    """Log-scale fixed-bucket duration histogram (count/total/max +
    percentiles). Not internally locked — the registry lock covers it."""

    __slots__ = ("count", "total_s", "max_s", "buckets")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.buckets = [0] * _N_BUCKETS

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds
        self.buckets[bucket_index(seconds)] += 1

    def percentile(self, q: float) -> float:
        """Upper bound (seconds) of the bucket holding the ceil(q*count)-th
        observation; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.buckets):
            cum += c
            if cum >= rank:
                return BUCKET_BOUNDS[i]
        return BUCKET_BOUNDS[-1]

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_ms": round(self.total_s / self.count * 1000, 3)
            if self.count else 0.0,
            "max_ms": round(self.max_s * 1000, 3),
            "p50_ms": round(self.percentile(0.50) * 1000, 3),
            "p90_ms": round(self.percentile(0.90) * 1000, 3),
            "p99_ms": round(self.percentile(0.99) * 1000, 3),
        }

    def to_value_dict(self) -> dict:
        """Raw-unit summary for value histograms (batch sizes, queue depths —
        anything that isn't a duration; no ms conversion)."""
        return {
            "count": self.count,
            "total": round(self.total_s, 6),
            "mean": round(self.total_s / self.count, 3) if self.count else 0.0,
            "max": round(self.max_s, 3),
            "p50": round(self.percentile(0.50), 3),
            "p90": round(self.percentile(0.90), 3),
            "p99": round(self.percentile(0.99), 3),
        }


class MetricsRegistry:
    """Thread-safe counters + histogram timers + gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gen = 0
        self._counters: Dict[str, int] = defaultdict(int)
        self._timers: Dict[str, Histogram] = defaultdict(Histogram)
        # value histograms: same log-bucket geometry, raw units (batch
        # sizes, flush waits in queries, …) — the scheduler's distribution
        # surface. Buckets start at 1e-6 so any positive value lands exactly.
        self._values: Dict[str, Histogram] = defaultdict(Histogram)
        self._gauges: Dict[str, object] = {}  # value or zero-arg callable
        self._reporters: List[Callable[[str, str, float], None]] = []
        # span trees awaiting histogram feed (GIL-atomic appends from trace
        # close; drained under the lock at snapshot time) — keeps the
        # per-query trace-close cost to one list append. Entries are
        # (root, trace_id) so retained traces can land bucket exemplars.
        self._pending: List[object] = []
        # timer name -> {bucket index -> (trace_id, seconds)}: the newest
        # RETAINED trace that observed into that bucket (OpenMetrics
        # exemplar slot). Populated at drain time through _exemplar_filter
        # (obs/sampling installs it — only tail-retained traces qualify,
        # so every exemplar links to a trace a reader can actually fetch).
        self._exemplars: Dict[str, Dict[int, tuple]] = {}
        self._exemplar_filter: Optional[Callable[[int], bool]] = None
        # runs BEFORE the lock on every snapshot-ish read: obs/sampling
        # drains its deferred retention queue here, so the exemplar filter
        # (consulted under the lock) sees up-to-date retention without ever
        # nesting locks
        self._pre_drain_hook: Optional[Callable[[], None]] = None

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n
            reporters = list(self._reporters)
        self._report(reporters, "counter", name, n)

    def observe(self, name: str, seconds: float) -> None:
        """Record one duration into the name's histogram (the span feed —
        the µs-scale hot path; skip the reporter copy when there are none)."""
        with self._lock:
            self._timers[name].observe(seconds)
            reporters = list(self._reporters) if self._reporters else None
        if reporters:
            self._report(reporters, "timer", name, seconds)

    def observe_batch(self, pairs) -> None:
        """Record many (name, seconds) at once under ONE lock acquisition."""
        with self._lock:
            for name, seconds in pairs:
                self._timers[name].observe(seconds)
            reporters = list(self._reporters) if self._reporters else None
        if reporters:
            for name, seconds in pairs:
                self._report(reporters, "timer", name, seconds)

    def observe_value(self, name: str, value: float) -> None:
        """Record one raw-unit observation (NOT a duration) into the name's
        value histogram — batch sizes, cover cardinalities, queue depths."""
        with self._lock:
            self._values[name].observe(value)

    def observe_exemplar(self, name: str, seconds: float,
                         trace_ref: str) -> None:
        """Record one duration AND pin ``trace_ref`` as the bucket's
        exemplar. Unlike drain-time exemplars (integer local trace ids
        re-checked against tail retention), a PINNED exemplar is a string
        reference to a trace on another node (e.g. a follower's apply
        trace riding a replication ack) — the local retention filter
        cannot vouch for it, so it is kept as-is until overwritten."""
        with self._lock:
            self._timers[name].observe(seconds)
            self._exemplars.setdefault(name, {})[
                bucket_index(seconds)] = (str(trace_ref), seconds)

    def feed_tree(self, root, trace_id: Optional[int] = None) -> None:
        """Defer a whole span tree (an object with ``walk()`` yielding nodes
        with ``name``/``duration_ms``) to the next drain — the trace-close
        hot-path feed: ONE locked list append now, histogram math at
        snapshot time. Reporters consequently see trace-span timer events at
        drain time (they poll snapshots anyway, the dropwizard model).
        ``trace_id`` tags the tree so retained traces become exemplars.
        Lockless by design (list appends are GIL-atomic; the drain swap
        under the lock captures the same list object, so nothing is
        lost) — this is the trace-close hot path."""
        self._pending.append((root, trace_id))

    def set_exemplar_filter(self, fn: Optional[Callable[[int], bool]]) -> None:
        """``fn(trace_id) -> bool`` gates which drained trees land bucket
        exemplars (obs/sampling installs its retained-set membership).
        MUST NOT acquire this registry's lock."""
        with self._lock:
            self._exemplar_filter = fn

    def set_pre_drain_hook(self, fn: Optional[Callable[[], None]]) -> None:
        """Zero-arg hook run before snapshot/export/timer_good_total take
        the lock (the tail sampler's deferred-decision drain slot)."""
        self._pre_drain_hook = fn

    def _pre_drain(self) -> None:
        hook = self._pre_drain_hook
        if hook is not None:
            try:
                hook()
            except Exception:
                pass  # a failing drain must never fail the surface

    def _drain_locked(self) -> Optional[list]:
        """Fold pending span trees into the histograms (lock held). Returns
        (name, seconds) pairs for the reporter fan-out, or None."""
        if not self._pending:
            return None
        pending, self._pending = self._pending, []
        flt = self._exemplar_filter
        pairs = []
        for root, tid in pending:
            keep = False
            if tid is not None and flt is not None:
                try:
                    keep = bool(flt(tid))
                except Exception:
                    keep = False
            for s in root.walk():
                seconds = s.duration_ms / 1000.0
                pairs.append((s.name, seconds))
                if keep:
                    self._exemplars.setdefault(s.name, {})[
                        bucket_index(seconds)] = (tid, seconds)
        for name, seconds in pairs:
            self._timers[name].observe(seconds)
        return pairs if self._reporters else None

    def timer_good_total(self, name: str, threshold_s: float):
        """(good, total) observation counts for one timer, where 'good'
        means the observation landed in a bucket whose UPPER bound is
        <= threshold_s (conservative by at most one bucket factor, ~19%).
        The SLO engine's latency feed. Drains pending trees first so the
        answer reflects every closed trace."""
        self._pre_drain()
        with self._lock:
            self._drain_locked()
            h = self._timers.get(name)
            if h is None or h.count == 0:
                return 0, 0
            good = 0
            for i, c in enumerate(h.buckets):
                if BUCKET_BOUNDS[i] > threshold_s:
                    break
                good += c
            return good, h.count

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        gen = self._gen  # racy read is fine: reset() bumps under the lock,
        # and the exit-side compare re-reads under the lock
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            reporters = None
            with self._lock:
                if self._gen == gen:
                    self._timers[name].observe(dt)
                    reporters = list(self._reporters)
                # else: straddled a reset() — discard, never resurrect
            if reporters is not None:
                self._report(reporters, "timer", name, dt)

    def set_gauge(self, name: str, value) -> None:
        """Set a gauge to a value OR a zero-arg callable evaluated lazily at
        snapshot time (resident rows, device memory, …)."""
        with self._lock:
            self._gauges[name] = value

    @staticmethod
    def _report(reporters, kind: str, name: str, value: float) -> None:
        for r in reporters:
            try:
                r(kind, name, value)
            except Exception:
                pass  # a failing sink must never fail the store (dropwizard rule)

    def add_reporter(self, fn: Callable[[str, str, float], None]) -> None:
        """fn(kind, name, value) — the external-sink slot (graphite/etc.)."""
        with self._lock:
            self._reporters.append(fn)

    def _gauge_values(self) -> Dict[str, float]:
        with self._lock:
            items = list(self._gauges.items())
        out = {}
        for k, v in items:
            if callable(v):
                try:
                    v = v()
                except Exception:
                    continue  # a failing probe must never fail the surface
            if v is not None:
                out[k] = v
        return out

    def snapshot(self) -> dict:
        self._pre_drain()
        gauges = self._gauge_values()  # probes run OUTSIDE the lock
        with self._lock:
            pairs = self._drain_locked()
            reporters = list(self._reporters) if pairs else None
            out = {
                "counters": dict(self._counters),
                "timers": {k: h.to_dict() for k, h in self._timers.items()},
                "histograms": {k: h.to_value_dict()
                               for k, h in self._values.items()},
                "gauges": gauges,
            }
        if pairs:
            for name, seconds in pairs:
                self._report(reporters, "timer", name, seconds)
        return out

    def snapshot_prefixed(self, *prefixes: str) -> dict:
        """``snapshot()`` filtered to names under the given prefixes — the
        focused debug surfaces (CLI ``debug admission``/``debug scheduler``,
        web overload state) without the whole registry."""
        snap = self.snapshot()
        return {section: {k: v for k, v in values.items()
                          if k.startswith(prefixes)}
                for section, values in snap.items()}

    def export_state(self) -> dict:
        """Bucket-exact registry state for metrics federation (the
        ``/metrics?format=state`` payload): counters, gauge values, and
        every timer/value histogram as (count, total, max, sparse
        buckets). Every process shares ONE fixed log-bucket geometry
        (BUCKET_BOUNDS), so a federator can merge histograms across
        nodes LOSSLESSLY by summing bucket counts — fleet percentiles
        are exactly what one process observing everything would report."""
        self._pre_drain()
        gauges = self._gauge_values()

        def hist_state(h: Histogram) -> dict:
            return {"count": h.count, "total": h.total_s, "max": h.max_s,
                    "buckets": {str(i): c for i, c in enumerate(h.buckets)
                                if c}}

        with self._lock:
            pairs = self._drain_locked()
            reporters = list(self._reporters) if pairs else None
            flt = self._exemplar_filter
            exemplars = {}
            for name, by_bucket in self._exemplars.items():
                kept = {}
                for bi, (tid, sec) in by_bucket.items():
                    try:
                        if isinstance(tid, str) or flt is None or flt(tid):
                            kept[str(bi)] = [tid, sec]
                    except Exception:
                        pass
                if kept:
                    exemplars[name] = kept
            out = {"bucket_geometry": [_N_BUCKETS, _BUCKET_MIN_S,
                                       _BUCKET_FACTOR],
                   "counters": dict(self._counters),
                   "gauges": gauges,
                   "timers": {k: hist_state(h)
                              for k, h in self._timers.items()},
                   "values": {k: hist_state(h)
                              for k, h in self._values.items()},
                   "exemplars": exemplars}
        if pairs:
            for name, seconds in pairs:
                self._report(reporters, "timer", name, seconds)
        return out

    def _export_locked_state(self):
        """One consistent view for the exposition: (counters, timer
        summaries+buckets, value summaries+buckets, exemplars) captured
        under ONE lock hold, so the summary and histogram families of a
        metric can never disagree. Gauges probe outside the lock."""
        self._pre_drain()
        gauges = self._gauge_values()
        with self._lock:
            pairs = self._drain_locked()
            reporters = list(self._reporters) if pairs else None
            counters = dict(self._counters)
            timers = {k: (h.to_dict(), list(h.buckets), h.total_s)
                      for k, h in self._timers.items()}
            values = {k: (h.to_value_dict(), list(h.buckets), h.total_s)
                      for k, h in self._values.items()}
            flt = self._exemplar_filter
            exemplars = {}
            for name, by_bucket in self._exemplars.items():
                kept = {}
                for bi, (tid, sec) in by_bucket.items():
                    # re-check retention at emission: a trace evicted from
                    # the tail-sampled ring must not leave a dangling link.
                    # String refs are PINNED cross-node exemplars
                    # (observe_exemplar) the local filter cannot judge.
                    try:
                        if isinstance(tid, str) or flt is None or flt(tid):
                            kept[bi] = (tid, sec)
                    except Exception:
                        pass
                by_bucket.clear()
                by_bucket.update(kept)
                if kept:
                    exemplars[name] = dict(kept)
        if pairs:
            for name, seconds in pairs:
                self._report(reporters, "timer", name, seconds)
        return counters, gauges, timers, values, exemplars

    @staticmethod
    def _bucket_lines(lines: List[str], m: str, buckets: List[int],
                      count: int, total: float,
                      exemplars: Optional[Dict[int, tuple]]) -> None:
        """Native cumulative ``_bucket{le=...}`` lines (only bounds that
        hold observations — le stays strictly increasing, cumulative counts
        non-decreasing) + the +Inf bucket, _count and _sum. Buckets backed
        by a retained trace carry an OpenMetrics-style exemplar."""
        cum = 0
        for i, c in enumerate(buckets):
            if not c:
                continue
            cum += c
            line = f'{m}_bucket{{le="{BUCKET_BOUNDS[i]:.9g}"}} {cum}'
            ex = exemplars.get(i) if exemplars else None
            if ex is not None:
                line += f' # {{trace_id="{ex[0]}"}} {ex[1]:.9g}'
            lines.append(line)
        lines.append(f'{m}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{m}_count {count}")
        lines.append(f"{m}_sum {total:.9g}")

    def to_prometheus(self) -> str:
        """Prometheus text exposition: counters as *_total, gauges as
        gauges, and each timer/value histogram as TWO families — the
        ``summary`` family (p50/p90/p99 quantile lines, the established
        names) plus a native ``histogram`` family under ``<name>_hist``
        with cumulative ``_bucket{le=...}`` lines and exemplar annotations
        on buckets where a tail-retained trace exists. Never emits NaN
        (empty timers emit count/sum only); every family name carries
        exactly one # TYPE line."""
        sane = sanitize_metric_name
        counters, gauges, timers, values, exemplars = \
            self._export_locked_state()
        lines: List[str] = []
        for name, v in sorted(counters.items()):
            m = sane(name) + "_total"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {v}")
        for name, g in sorted(gauges.items()):
            m = sane(name)
            # lazily-sampled monotone process totals (process.cpu_seconds_
            # total et al.) register as gauges but ARE counters; the
            # _total suffix is the contract and the exposition honors it
            lines.append(f"# TYPE {m} "
                         f"{'counter' if name.endswith('_total') else 'gauge'}")
            lines.append(f"{m} {float(g):g}")
        for name, (h, buckets, total_s) in sorted(timers.items()):
            m = sane(name) + "_seconds"
            lines.append(f"# TYPE {m} summary")
            if h["count"]:
                for q, key in ((0.5, "p50_ms"), (0.9, "p90_ms"),
                               (0.99, "p99_ms")):
                    lines.append(
                        f'{m}{{quantile="{q}"}} {h[key] / 1000:.9g}')
            lines.append(f"{m}_count {h['count']}")
            lines.append(f"{m}_sum {total_s:.9g}")
            mh = m + "_hist"
            lines.append(f"# TYPE {mh} histogram")
            self._bucket_lines(lines, mh, buckets, h["count"], total_s,
                               exemplars.get(name))
        for name, (h, buckets, total) in sorted(values.items()):
            m = sane(name)  # raw units: no _seconds suffix
            lines.append(f"# TYPE {m} summary")
            if h["count"]:
                for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                    lines.append(f'{m}{{quantile="{q}"}} {h[key]:.9g}')
            lines.append(f"{m}_count {h['count']}")
            lines.append(f"{m}_sum {total:.9g}")
            mh = m + "_hist"
            lines.append(f"# TYPE {mh} histogram")
            self._bucket_lines(lines, mh, buckets, h["count"], total, None)
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Clear counters and timers (gauges persist — they describe current
        state, not accumulation). In-flight ``time()`` blocks that entered
        before this reset are discarded at their exit (generation check)."""
        with self._lock:
            self._gen += 1
            self._counters.clear()
            self._timers.clear()
            self._values.clear()
            self._pending.clear()  # same straddling-discard semantics
            self._exemplars.clear()


# process-global default registry (≙ the shared MetricRegistry)
REGISTRY = MetricsRegistry()

_DEVICE_GAUGES_REGISTERED = False


def _cuda_memory() -> Dict[str, int]:
    """bytes_in_use / peak_bytes_in_use / bytes_limit summed over the
    CUDA devices (the caching allocator's live and peak allocations, the
    devices' total memory); empty without a card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    out = {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        out["bytes_in_use"] += int(st.get("allocated_bytes.all.current", 0))
        out["peak_bytes_in_use"] += int(st.get("allocated_bytes.all.peak", 0))
        out["bytes_limit"] += int(
            torch.cuda.get_device_properties(i).total_memory)
    return out


def register_device_gauges(registry: Optional[MetricsRegistry] = None) -> None:
    """Install lazy device + host-pressure gauges: ``device.count``,
    ``device.bytes_in_use`` / ``device.peak_bytes_in_use`` /
    ``device.bytes_limit`` (summed ``torch.cuda.memory_stats()`` and total
    memory over the CUDA devices, None without a card — live AND peak
    device memory so an OOM trajectory is visible before it lands), plus
    ``process.rss_bytes`` (host resident set),
    ``process.cpu_seconds_total`` (monotone user+sys CPU, exported as a
    counter), ``trace.ring_depth`` (recent-trace ring occupancy) and
    ``wal.open_segments`` (live WAL segment files; 0 until the write-ahead
    log is ported, ROADMAP.md Queue 1 item 15) — so /metrics reflects
    host memory and observability-buffer pressure, not just device state.
    Idempotent; probes evaluate at snapshot time and never raise through
    the surface."""
    global _DEVICE_GAUGES_REGISTERED
    reg = registry or REGISTRY
    if reg is REGISTRY and _DEVICE_GAUGES_REGISTERED:
        return
    if reg is REGISTRY:
        _DEVICE_GAUGES_REGISTERED = True

    def _count():
        import torch
        return torch.cuda.device_count()

    def _mem_key(key):
        def probe():
            return _cuda_memory().get(key)
        return probe

    def _cpu_seconds():
        # user + system CPU of this process — monotone, so the gauge
        # exports as a counter (the _total contract in to_prometheus)
        t = os.times()
        return round(t[0] + t[1], 3)

    def _rss():
        # current (not peak) resident set via /proc; ru_maxrss fallback
        try:
            with open("/proc/self/statm") as fh:
                pages = int(fh.read().split()[1])
            return pages * (os.sysconf("SC_PAGE_SIZE")
                            if hasattr(os, "sysconf") else 4096)
        except OSError:
            import resource
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    def _ring_depth():
        from geomesa_tpu_torch.trace import RING
        return len(RING)

    def _wal_segments():
        # the write-ahead log is not ported yet (ROADMAP.md Queue 1 item 15)
        return 0

    reg.set_gauge("device.count", _count)
    reg.set_gauge("device.bytes_in_use", _mem_key("bytes_in_use"))
    reg.set_gauge("device.peak_bytes_in_use", _mem_key("peak_bytes_in_use"))
    reg.set_gauge("device.bytes_limit", _mem_key("bytes_limit"))
    reg.set_gauge("process.rss_bytes", _rss)
    reg.set_gauge("process.cpu_seconds_total", _cpu_seconds)
    reg.set_gauge("trace.ring_depth", _ring_depth)
    reg.set_gauge("wal.open_segments", _wal_segments)
