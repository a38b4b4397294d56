"""Per-request deadlines with propagation (the Tail-at-Scale discipline).

Copied from ``geomesa_tpu.serve.resilience.deadline`` (host-only) with its
imports pointed at this package.

A ``Deadline`` is an absolute expiry captured where the request enters the
system (web handler, ``DataStore.count_*``) and threaded through every stage
that could spend time on its behalf: admission, the scheduler queue, plan /
range-decomposition / refine checkpoints in the planner, and — the
load-bearing one — the device-dispatch boundary, where an expired request is
cancelled BEFORE it costs a device round trip (XLA dispatches are
uninterruptible, so the only winning move is not to start one).

Propagation is explicit on the scheduler path (each Request carries its
Deadline) and ambient elsewhere: ``use(dl)`` installs the deadline
thread-locally so deep planner stages can check it without every signature
growing a parameter — the same cooperative-checkpoint guarantee level as the
reference's QueryKiller (guards.py), which also only interrupts between
stages.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from geomesa_tpu_torch.index.guards import QueryTimeout

_pc = time.perf_counter


class DeadlineExceeded(QueryTimeout):
    """The request's deadline lapsed at ``stage``. Subclasses QueryTimeout
    so existing timeout handling (and the web 504 mapping) catches both."""

    def __init__(self, stage: str, overrun_ms: float):
        super().__init__(
            f"deadline exceeded at stage {stage!r} "
            f"({overrun_ms:.1f}ms past the deadline)")
        self.stage = stage
        self.overrun_ms = overrun_ms


class Deadline:
    """Absolute per-request expiry (monotonic clock)."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = expires_at

    @classmethod
    def after_ms(cls, timeout_ms: float) -> "Deadline":
        return cls(_pc() + float(timeout_ms) / 1000.0)

    def remaining_ms(self) -> float:
        """Milliseconds until expiry (negative = overrun)."""
        return (self.expires_at - _pc()) * 1000.0

    @property
    def expired(self) -> bool:
        return _pc() >= self.expires_at

    def check(self, stage: str) -> None:
        """Cooperative checkpoint: raise DeadlineExceeded when lapsed."""
        rem = self.remaining_ms()
        if rem < 0:
            raise DeadlineExceeded(stage, -rem)

    def sooner_of(self, other: Optional["Deadline"]) -> "Deadline":
        if other is None or self.expires_at <= other.expires_at:
            return self
        return other

    def __repr__(self) -> str:
        return f"Deadline(remaining_ms={self.remaining_ms():.1f})"


class _Local(threading.local):
    deadline: Optional[Deadline] = None


_local = _Local()


def current() -> Optional[Deadline]:
    """The ambient deadline for this thread (None when unconstrained)."""
    return _local.deadline


def check_current(stage: str) -> None:
    """Checkpoint against the ambient deadline; no-op without one. The
    planner's range-decompose / refine stages call this — cost when
    unconstrained is one thread-local read."""
    dl = _local.deadline
    if dl is not None:
        dl.check(stage)


class use:
    """Context manager installing ``dl`` as the ambient deadline. Nests by
    keeping the SOONER of the new and any enclosing deadline (a callee may
    tighten its caller's budget, never extend it). ``use(None)`` is a
    no-op passthrough."""

    __slots__ = ("_dl", "_prev")

    def __init__(self, dl: Optional[Deadline]):
        self._dl = dl

    def __enter__(self):
        self._prev = _local.deadline
        if self._dl is not None:
            _local.deadline = self._dl.sooner_of(self._prev)
        return _local.deadline

    def __exit__(self, *exc):
        _local.deadline = self._prev
        return False


def scope(timeout_ms: Optional[float]) -> use:
    """``use(Deadline.after_ms(timeout_ms))``, tolerating None/0 (no
    deadline) — the one-liner for entry points taking a ``deadline_ms``
    parameter."""
    if not timeout_ms:
        return use(None)
    return use(Deadline.after_ms(timeout_ms))


def resolve(deadline: Optional[Deadline] = None,
            deadline_ms: Optional[float] = None) -> Optional[Deadline]:
    """The effective deadline for a request entering the scheduler: an
    explicit Deadline, else one built from ``deadline_ms``, else the
    ambient one — explicit args additionally clamp to a sooner ambient
    deadline (propagation never loosens)."""
    amb = _local.deadline
    if deadline is not None:
        return deadline.sooner_of(amb)
    if deadline_ms:
        return Deadline.after_ms(deadline_ms).sooner_of(amb)
    return amb
