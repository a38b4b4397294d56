"""Circuit breaker + capped exponential-backoff retry with full jitter.

Copied from ``geomesa_tpu.serve.resilience.breaker`` (host-only) with its
imports pointed at this package.

The breaker guards the device-dispatch boundary (and anything else with a
failure mode that is cheaper to fail fast than to pile onto): CLOSED passes
traffic and counts consecutive failures; at the threshold it OPENs and
everything fails fast (eligible counts degrade to the stats estimator
instead — serve/resilience/degrade.py); after a cooldown it HALF-OPENs a
bounded number of probes, closing on consecutive successes and re-opening on
any probe failure. The clock is injectable so every transition is tested
deterministically (no sleeps in tests).

``retry_call`` is the paired retry wrapper: capped exponential backoff with
FULL jitter (sleep ~ uniform(0, min(cap, base * 2^attempt))) per the AWS
architecture-blog analysis — full jitter minimizes synchronized retry storms
from concurrent callers. Deadline-aware: a sleep never runs past the ambient
request deadline, and an expired deadline stops retrying immediately.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from geomesa_tpu_torch import config
from geomesa_tpu_torch.metrics import REGISTRY as _metrics
from geomesa_tpu_torch.serve.resilience import deadline as _dl

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitOpenError(Exception):
    """Failing fast: the breaker is open (→ HTTP 503 + Retry-After)."""

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(f"circuit breaker {name!r} is open; "
                         f"retry after {retry_after_s:.1f}s")
        self.name = name
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing."""

    def __init__(self, name: str, threshold: Optional[int] = None,
                 cooldown_ms: Optional[float] = None,
                 probes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._threshold = threshold
        self._cooldown_ms = cooldown_ms
        self._probes = probes
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self._failures = 0           # consecutive, in CLOSED
        self._successes = 0          # consecutive probe successes, HALF_OPEN
        self._probes_out = 0         # probes currently allowed through
        self._opened_at = 0.0
        self._n_opened = 0
        self._n_closed = 0

    # knobs re-read per access so tests/operators can flip them live
    def _cfg_threshold(self) -> int:
        return int(self._threshold if self._threshold is not None
                   else config.BREAKER_THRESHOLD.get())

    def _cfg_cooldown_s(self) -> float:
        return float(self._cooldown_ms if self._cooldown_ms is not None
                     else config.BREAKER_COOLDOWN_MS.get()) / 1000.0

    def _cfg_probes(self) -> int:
        return max(1, int(self._probes if self._probes is not None
                          else config.BREAKER_PROBES.get()))

    def allow(self) -> bool:
        """May a call proceed right now? OPEN transitions to HALF_OPEN
        (admitting bounded probes) once the cooldown has elapsed."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._clock() - self._opened_at < self._cfg_cooldown_s():
                    return False
                self.state = HALF_OPEN
                self._successes = 0
                self._probes_out = 0
                _metrics.inc(f"breaker.{self.name}.half_open")
            # HALF_OPEN: admit at most the configured number of probes at
            # a time; the rest keep failing fast until probes conclude
            if self._probes_out < self._cfg_probes():
                self._probes_out += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self.state == HALF_OPEN:
                self._successes += 1
                self._probes_out = max(0, self._probes_out - 1)
                if self._successes >= self._cfg_probes():
                    self.state = CLOSED
                    self._n_closed += 1
                    _metrics.inc(f"breaker.{self.name}.closed")

    def record_failure(self) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                self._open_locked()   # one bad probe re-opens
                return
            if self.state == OPEN:
                return
            self._failures += 1
            if self._failures >= self._cfg_threshold():
                self._open_locked()

    def _open_locked(self) -> None:
        self.state = OPEN
        self._opened_at = self._clock()
        self._failures = 0
        self._successes = 0
        self._probes_out = 0
        self._n_opened += 1
        _metrics.inc(f"breaker.{self.name}.opened")

    def retry_after_s(self) -> float:
        """Seconds until the breaker would half-open (0 when not open)."""
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return max(0.0, self._cfg_cooldown_s()
                       - (self._clock() - self._opened_at))

    def open_error(self) -> CircuitOpenError:
        return CircuitOpenError(self.name, self.retry_after_s())

    def stats(self) -> dict:
        with self._lock:
            return {"name": self.name, "state": self.state,
                    "consecutive_failures": self._failures,
                    "threshold": self._cfg_threshold(),
                    "cooldown_ms": self._cfg_cooldown_s() * 1000.0,
                    "probes": self._cfg_probes(),
                    "opened": self._n_opened, "closed": self._n_closed}


def retry_call(fn: Callable[[], object], attempts: Optional[int] = None,
               base_ms: Optional[float] = None,
               cap_ms: Optional[float] = None,
               breaker: Optional[CircuitBreaker] = None,
               rng: Optional[random.Random] = None,
               counter: str = "retry.attempts"):
    """Run ``fn`` with up to ``attempts`` tries, capped-exponential
    full-jitter backoff between them, optionally gated by / reported to a
    breaker. Only ``Exception`` retries — BaseException (an injected
    worker kill, KeyboardInterrupt) always propagates. A sleep is clamped
    to the ambient deadline's remaining budget; an already-expired
    deadline stops the retry loop with the last error."""
    n = int(attempts if attempts is not None
            else config.RETRY_ATTEMPTS.get())
    base = float(base_ms if base_ms is not None
                 else config.RETRY_BASE_MS.get()) / 1000.0
    cap = float(cap_ms if cap_ms is not None
                else config.RETRY_CAP_MS.get()) / 1000.0
    rand = rng.uniform if rng is not None else random.uniform
    last: Optional[Exception] = None
    for i in range(max(1, n)):
        if breaker is not None and not breaker.allow():
            raise breaker.open_error()
        try:
            out = fn()
        except Exception as e:
            if breaker is not None:
                breaker.record_failure()
            last = e
            if i + 1 >= max(1, n):
                break
            _metrics.inc(counter)
            sleep_s = rand(0.0, min(cap, base * (2.0 ** i)))
            dl = _dl.current()
            if dl is not None:
                rem = dl.remaining_ms() / 1000.0
                if rem <= 0:
                    break  # no budget left to retry into
                sleep_s = min(sleep_s, rem)
            if sleep_s > 0:
                time.sleep(sleep_s)
            continue
        if breaker is not None:
            breaker.record_success()
        return out
    raise last
