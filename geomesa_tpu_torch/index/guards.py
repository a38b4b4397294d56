"""Query interceptors, guards, audit, timeouts.

Copied from ``geomesa_tpu.index.guards`` (host-only) with its imports
pointed at this package; the audit file's rotation raises until
``durability/rotation.py`` is ported (ROADMAP.md Queue 1 item 15).

≙ reference planning/QueryInterceptor.scala:28 (SPI hooks that rewrite or
veto queries), guard/GraduatedQueryGuard.scala + TemporalQueryGuard,
QueryProperties.BlockFullTableScans (conf/QueryProperties.scala:40), the
audit trail (audit/QueryEvent.scala:13 via AuditWriter), and the
ThreadManagement QueryKiller (index/utils/ThreadManagement.scala:28).

Timeout semantics: XLA dispatches are uninterruptible, so the deadline is
checked between pipeline stages (plan → scan → refine) — the same guarantee
level as the reference's cooperative QueryKiller, which also only interrupts
between iterator batches.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.extract import extract_bboxes, extract_intervals
from geomesa_tpu_torch.index.api import not_ported


class QueryGuardError(Exception):
    """A guard vetoed the query (≙ the IllegalArgumentException the
    reference guards raise)."""


class QueryTimeout(Exception):
    """Deadline exceeded (≙ ThreadManagement.QueryKiller cancellation)."""


class QueryInterceptor:
    """Rewrite and/or veto hook (≙ QueryInterceptor SPI)."""

    def rewrite(self, f: ir.Filter, sft) -> ir.Filter:
        return f

    def guard(self, plan, f: ir.Filter, sft) -> Optional[str]:
        """Return an error message to veto, None to allow."""
        return None


class FullTableScanGuard(QueryInterceptor):
    """Block filtered queries that degenerate to a full-table scan
    (≙ geomesa.scan.block-full-table)."""

    def guard(self, plan, f, sft):
        if isinstance(f, ir.Include):
            return None  # explicit full reads are allowed, as in the reference
        if plan.empty or plan.candidate_slices is not None:
            return None
        if plan.primary_kind == "none" and plan.windows is None:
            return ("Query would require a full-table scan "
                    "(no index-serviceable predicate); add a spatial, "
                    "temporal, or indexed-attribute constraint")
        return None


class TemporalQueryGuard(QueryInterceptor):
    """Require a bounded temporal filter under ``max_duration_ms``
    (≙ guard/TemporalQueryGuard)."""

    def __init__(self, max_duration_ms: int):
        self.max_duration_ms = int(max_duration_ms)

    def guard(self, plan, f, sft):
        dtg = sft.dtg_attribute
        if dtg is None or plan.empty:
            return None
        iv = extract_intervals(f, dtg.name)
        if iv is None or iv.unconstrained or not len(iv.intervals):
            return f"Query requires a temporal filter on {dtg.name!r}"
        span = max(int(hi) - int(lo) for lo, hi in iv.intervals)
        if span > self.max_duration_ms:
            return (f"Temporal filter spans {span}ms, over the "
                    f"{self.max_duration_ms}ms limit")
        return None


@dataclass
class SizeAndDuration:
    """One graduated limit: queries within ``area_deg2`` may span up to
    ``duration_ms`` (≙ GraduatedQueryGuard.SizeAndDuration)."""
    area_deg2: float
    duration_ms: int


class GraduatedQueryGuard(QueryInterceptor):
    """Smaller spatial extent ⇒ longer allowed duration (≙
    guard/GraduatedQueryGuard.scala). Limits sorted by area ascending; the
    first limit whose area covers the query applies; the final limit may use
    area=inf as the catch-all."""

    def __init__(self, limits: Sequence[SizeAndDuration]):
        self.limits = sorted(limits, key=lambda l: l.area_deg2)

    def guard(self, plan, f, sft):
        geom = sft.geometry_attribute
        dtg = sft.dtg_attribute
        if geom is None or plan.empty:
            return None
        ext = extract_bboxes(f, geom.name)
        area = 360.0 * 180.0 if ext.unconstrained else sum(
            max(0.0, (x1 - x0)) * max(0.0, (y1 - y0))
            for x0, y0, x1, y1 in ext.boxes)
        limit = next((l for l in self.limits if area <= l.area_deg2), None)
        if limit is None:
            return (f"Query area {area:.1f}deg2 exceeds the largest "
                    f"configured limit")
        if dtg is None:
            return None
        iv = extract_intervals(f, dtg.name)
        if iv is None or iv.unconstrained or not len(iv.intervals):
            span = None
        else:
            span = max(int(hi) - int(lo) for lo, hi in iv.intervals)
        if span is None or span > limit.duration_ms:
            return (f"Queries covering {area:.1f}deg2 must include a "
                    f"temporal filter of at most {limit.duration_ms}ms")
        return None


# -- audit (≙ audit/QueryEvent + AuditWriter) --------------------------------


@dataclass
class QueryEvent:
    type_name: str
    filter: str
    user: str = ""
    ts_ms: int = 0
    plan_time_ms: float = 0.0
    scan_time_ms: float = 0.0
    hits: int = 0
    index: str = ""

    def to_dict(self) -> dict:
        return self.__dict__.copy()


class AuditWriter:
    """In-memory audit trail with optional JSONL sink (≙ AuditLogger /
    the Accumulo ``_queries`` table).

    The JSONL path is bounded against unbounded growth: with ``max_bytes``
    set, the file rotates (keep-one-previous: ``path`` → ``path.1``) before
    an append would cross the limit, and events lost when a rotation
    discards the old ``.1`` file land on the ``audit.dropped`` counter —
    total on-disk footprint stays <= ~2*max_bytes."""

    def __init__(self, path: Optional[str] = None, keep: int = 1000,
                 max_bytes: Optional[int] = None):
        import os
        import threading
        self.path = path
        self.keep = keep
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.events: List[QueryEvent] = []
        self._lock = threading.Lock()
        self._size = os.path.getsize(path) if path and os.path.exists(path) \
            else 0
        self._file_events: Optional[int] = 0 if self._size == 0 else None

    def _rotate(self) -> None:
        # the keep-N shuffle is the reference's durability/rotation.py
        # helper, shared with the write-ahead log; neither is ported yet
        raise not_ported("audit log rotation (durability/rotation.py)", 15)

    def write(self, event: QueryEvent) -> None:
        with self._lock:
            self.events.append(event)
            if len(self.events) > self.keep:
                self.events = self.events[-self.keep:]
            if not self.path:
                return
            line = json.dumps(event.to_dict()) + "\n"
            if (self.max_bytes is not None and self._size > 0
                    and self._size + len(line) > self.max_bytes):
                self._rotate()
            with open(self.path, "a") as fh:
                fh.write(line)
            self._size += len(line)
            if self._file_events is not None:
                self._file_events += 1


# -- deadline ----------------------------------------------------------------


class Deadline:
    """Cooperative deadline checked between pipeline stages. Also honors
    the ambient per-REQUEST deadline (serve/resilience/deadline.py) when
    one is installed, so a web/API deadline propagates through planner
    stages without threading a parameter through every call — whichever
    of the two budgets lapses first wins."""

    def __init__(self, timeout_ms: Optional[float]):
        self.t0 = time.perf_counter()
        self.timeout_ms = timeout_ms
        # lazy import: guards loads before/without the serve package
        from geomesa_tpu_torch.serve.resilience import deadline as _rdl
        self._request = _rdl.current()

    def check(self, stage: str) -> None:
        if self._request is not None:
            self._request.check(stage)  # raises DeadlineExceeded
        if self.timeout_ms is None:
            return
        elapsed = (time.perf_counter() - self.t0) * 1000
        if elapsed > self.timeout_ms:
            raise QueryTimeout(
                f"Query exceeded {self.timeout_ms}ms at stage {stage!r} "
                f"({elapsed:.0f}ms elapsed)")
