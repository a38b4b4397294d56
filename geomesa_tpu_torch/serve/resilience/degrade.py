"""Graceful degradation: approximate answers when exact ones can't land.

Copied from ``geomesa_tpu.serve.resilience.degrade`` (host-only) with its
imports pointed at this package. A store's planners carry the type's stats
battery (``stats/``), so ``estimate`` prices their counts as the
reference's does; a bare planner (none), or one whose battery is not
observed yet, gets None, as the reference's bare planner; the latter's
observe starts on a thread.

When a count request reaches dispatch with (almost) no deadline budget left,
or the device-dispatch breaker is open, an exact answer is off the table —
the choice is between an error and a cheap approximation. For count/density
shapes the stats battery (stats/estimator.py: Z2/Z3 histogram mass, count-min
frequencies) already prices exactly these filters for the cost-based planner,
so the degraded path reuses it: a host-only estimate in microseconds, no
device round trip, explicitly flagged.

The flag is the contract: ``ApproximateCount`` IS an int (drop-in for every
caller that sums/compares counts) but carries ``approximate=True`` and a
``reason``, and the web layer surfaces both in the response body — a client
can always tell a degraded answer from an exact one.
"""

from __future__ import annotations

from typing import Optional

from geomesa_tpu_torch.metrics import REGISTRY as _metrics


class ApproximateCount(int):
    """An int count that is explicitly NOT exact. ``reason`` says which
    degradation produced it (``deadline`` | ``breaker_open``)."""

    approximate = True

    def __new__(cls, value, reason: str = ""):
        out = super().__new__(cls, int(value))
        out.reason = reason
        return out

    def __repr__(self) -> str:
        return f"ApproximateCount({int(self)}, reason={self.reason!r})"


def is_approximate(value) -> bool:
    return bool(getattr(value, "approximate", False))


def eligible(planner) -> bool:
    """Can this planner's type degrade? Needs a populated stats battery
    (bare bench planners have none) — the estimator answers any filter
    from there (unknown shapes conservatively estimate high). A battery
    not observed yet declines at once (the exact route answers, as for a
    bare planner) and starts its observe on a thread: a degraded count
    never waits on it."""
    stats = getattr(planner, "stats", None)
    if stats is None:
        return False
    if not getattr(stats, "observed", True):
        stats.observe_in_background()
        return False
    return getattr(stats, "total", 0) > 0


def estimate(planner, f_ir, reason: str) -> Optional[ApproximateCount]:
    """Flagged estimator count for the filter, or None when ineligible.
    Host-only: never touches the device."""
    if not eligible(planner):
        return None
    try:
        n = planner.stats.estimator.estimate_count(f_ir)
    except Exception:
        return None  # a broken sketch must not turn degradation into a 500
    _metrics.inc("degrade.approximate")
    _metrics.inc(f"degrade.approximate.{reason}")
    return ApproximateCount(n, reason)
