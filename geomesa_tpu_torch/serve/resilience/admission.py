"""Priority-aware admission control with load shedding.

Copied from ``geomesa_tpu.serve.resilience.admission`` (host-only) with its
imports pointed at this package.

≙ the overload-control discipline of Zhou et al., *Overload Control for
Scaling WeChat Microservices* (SoCC 2018): requests are classed by business
priority at the entry point and an overloaded server rejects excess work
EARLY — a bounded amount of in-flight work per class, shed-with-backpressure
(HTTP 429 + Retry-After) past the bound — instead of queueing until every
admitted request misses its deadline (queueing collapse).

Two classes:

  interactive   dashboard/map-tile style point queries; the class whose
                tail latency the system protects. Served first by the
                scheduler's priority queue.
  batch         analytics / bulk scans; bounded lower so background load
                can never starve interactive traffic.

Accounting is in-flight based (admitted minus completed, counted via a
future done-callback), so the bound covers queued AND executing work — the
quantity that actually determines how long a newly admitted request waits.

Tenant QoS (GEOMESA_TPU_QOS_*): within each class, weighted-fair per-tenant
shares bound how much of the class limit one tenant may hold while other
tenants are active — a noisy tenant saturates its own share and sheds 429
while the victims' requests keep landing in the reserved headroom. The cap
is work-conserving: a lone tenant (no other tenant admitted inside the
QOS_ACTIVE_S window) may use the full class limit.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from geomesa_tpu_torch import config
from geomesa_tpu_torch.metrics import REGISTRY as _metrics

PRIORITIES = ("interactive", "batch")


def normalize_priority(p) -> str:
    """Canonical priority class for a request parameter; unknown values
    fall back to interactive (a typo must not silently deprioritize)."""
    p = str(p or "interactive").lower()
    if p in ("batch", "analytics", "background", "bulk"):
        return "batch"
    return "interactive"


class ShedError(Exception):
    """The request was rejected by admission control (→ HTTP 429). Carries
    the Retry-After the client should honor."""

    def __init__(self, priority: str, in_flight: int, limit: int,
                 retry_after_s: float, tenant: Optional[str] = None):
        who = f"tenant {tenant} " if tenant else ""
        super().__init__(
            f"overloaded: {who}{in_flight}/{limit} {priority} queries in "
            f"flight; retry after {retry_after_s:g}s")
        self.priority = priority
        self.in_flight = in_flight
        self.limit = limit
        self.retry_after_s = retry_after_s
        # set when the shed was a per-tenant QoS share cap, not the class
        # limit: THIS tenant is over its fair share, the class has headroom
        self.tenant = tenant


class AdmissionController:
    """Bounded in-flight work per priority class; excess sheds."""

    def __init__(self, interactive_limit=None, batch_limit=None):
        self._lock = threading.Lock()
        self._limits_override = {"interactive": interactive_limit,
                                 "batch": batch_limit}
        self._in_flight: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._admitted: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._shed: Dict[str, int] = {p: 0 for p in PRIORITIES}
        # tenant QoS state (all guarded by the lock): per-class per-tenant
        # in-flight, last-admit timestamps (the activity window), and the
        # per-tenant QoS shed tally for the stats surface
        self._tenant_flight: Dict[str, Dict[str, int]] = \
            {p: {} for p in PRIORITIES}
        self._tenant_seen: Dict[str, Dict[str, float]] = \
            {p: {} for p in PRIORITIES}
        self._qos_shed: Dict[str, int] = {}
        self._draining = False
        _metrics.set_gauge("admission.in_flight.interactive",
                           lambda: self._in_flight["interactive"])
        _metrics.set_gauge("admission.in_flight.batch",
                           lambda: self._in_flight["batch"])

    def _limit(self, priority: str) -> int:
        ov = self._limits_override.get(priority)
        if ov is not None:
            return int(ov)
        prop = config.ADMIT_INTERACTIVE if priority == "interactive" \
            else config.ADMIT_BATCH
        return int(prop.get())

    def _share(self, limit: int) -> int:
        """Per-tenant in-flight share of a class limit while fairness is
        engaged: share-fraction of the limit, floored so a tenant is never
        starved to zero slots."""
        frac = float(config.QOS_TENANT_SHARE.get())
        floor = int(config.QOS_TENANT_MIN.get())
        return max(1, floor, int(limit * frac))

    def _admit_tenant_locked(self, p: str, tenant: str, limit: int):
        """Under the lock: the QoS verdict for one tenant. Returns None to
        admit, or (tenant_in_flight, share) to shed. Also maintains the
        activity window."""
        now = time.monotonic()
        seen = self._tenant_seen[p]
        window = float(config.QOS_ACTIVE_S.get())
        if len(seen) > 256:  # bound the window map under tenant churn
            for t in [t for t, ts in seen.items() if now - ts > window]:
                del seen[t]
        seen[tenant] = now
        others_active = any(t != tenant and now - ts <= window
                            for t, ts in seen.items())
        if not others_active:
            return None  # lone tenant: work-conserving, full class limit
        mine = self._tenant_flight[p].get(tenant, 0)
        share = self._share(limit)
        if mine >= share:
            return mine, share
        return None

    def admit(self, priority: str, tenant: Optional[str] = None) -> str:
        """Admit one request of ``priority`` (returns the normalized class)
        or raise ShedError. The caller MUST pair a successful admit with
        exactly one ``release`` — same tenant label — (the scheduler wires
        it to the request future's done-callback, covering every
        resolution path)."""
        p = normalize_priority(priority)
        if self._draining:
            # rolling restart / failover drain: shed EVERYTHING (even with
            # admission disabled) so in-flight work settles and a promote
            # can measure a quiesced node
            with self._lock:
                self._shed[p] += 1
                n = self._in_flight[p]
            _metrics.inc("admission.shed")
            _metrics.inc(f"admission.shed.{p}")
            raise ShedError(p, n, 0,
                            float(config.ADMIT_RETRY_AFTER_S.get()))
        if not config.ADMIT_ENABLED.get():
            with self._lock:
                self._in_flight[p] += 1
                self._admitted[p] += 1
                if tenant is not None:
                    tf = self._tenant_flight[p]
                    tf[tenant] = tf.get(tenant, 0) + 1
            _metrics.inc("admission.admitted")
            return p
        limit = self._limit(p)
        qos = tenant is not None and bool(config.QOS_ENABLED.get())
        with self._lock:
            verdict = self._admit_tenant_locked(p, tenant, limit) \
                if qos else None
            n = self._in_flight[p]
            if verdict is not None:
                # over the fair share while other tenants are active: shed
                # THIS tenant even though the class may have headroom —
                # that headroom is the victims' protection
                self._shed[p] += 1
                self._qos_shed[tenant] = self._qos_shed.get(tenant, 0) + 1
            elif n >= limit:
                self._shed[p] += 1
            else:
                self._in_flight[p] = n + 1
                self._admitted[p] += 1
                if tenant is not None:
                    tf = self._tenant_flight[p]
                    tf[tenant] = tf.get(tenant, 0) + 1
                n = -1
        if verdict is not None:
            _metrics.inc("admission.shed")
            _metrics.inc(f"admission.shed.{p}")
            _metrics.inc("admission.shed.qos")
            raise ShedError(p, verdict[0], verdict[1],
                            float(config.ADMIT_RETRY_AFTER_S.get()),
                            tenant=tenant)
        if n >= 0:
            _metrics.inc("admission.shed")
            _metrics.inc(f"admission.shed.{p}")
            raise ShedError(p, n, limit,
                            float(config.ADMIT_RETRY_AFTER_S.get()))
        _metrics.inc("admission.admitted")
        return p

    def release(self, priority: str, tenant: Optional[str] = None) -> None:
        with self._lock:
            self._in_flight[priority] = max(
                0, self._in_flight[priority] - 1)
            if tenant is not None:
                tf = self._tenant_flight.get(priority, {})
                left = tf.get(tenant, 0) - 1
                if left > 0:
                    tf[tenant] = left
                else:
                    tf.pop(tenant, None)

    def drain(self, draining: bool = True) -> None:
        """Enter (or leave) drain mode: every new request sheds with 429 +
        Retry-After while already-admitted work completes — the rolling-
        restart / pre-failover quiesce step."""
        self._draining = bool(draining)
        _metrics.inc("admission.drains" if draining
                     else "admission.undrains")

    @property
    def draining(self) -> bool:
        return self._draining

    def in_flight_total(self) -> int:
        with self._lock:
            return sum(self._in_flight.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": bool(config.ADMIT_ENABLED.get()),
                "draining": self._draining,
                "in_flight": dict(self._in_flight),
                "limits": {p: self._limit(p) for p in PRIORITIES},
                "admitted": dict(self._admitted),
                "shed": dict(self._shed),
                "retry_after_s": float(config.ADMIT_RETRY_AFTER_S.get()),
                "qos": {
                    "enabled": bool(config.QOS_ENABLED.get()),
                    "tenant_share": float(config.QOS_TENANT_SHARE.get()),
                    "tenant_min": int(config.QOS_TENANT_MIN.get()),
                    "share_limits": {p: self._share(self._limit(p))
                                     for p in PRIORITIES},
                    "tenant_in_flight": {p: dict(self._tenant_flight[p])
                                         for p in PRIORITIES
                                         if self._tenant_flight[p]},
                    "qos_shed": dict(self._qos_shed),
                },
            }
