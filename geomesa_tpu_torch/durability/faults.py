"""Deterministic fault injection for the durability + serving subsystems.

Copied from ``geomesa_tpu.durability.faults`` (host-only). Its armed state
is this module's own: arming the reference's registry never fires here.

≙ the crash-consistency test harnesses real storage engines carry (e.g.
Accumulo's WAL recovery tests kill tablet servers at write boundaries): a
registry of named **crash points** threaded through every WAL/snapshot
boundary, plus torn-write / short-write / fsync-failure injection. Tests arm
a point, drive mutations until the injected crash fires, then assert that
``recover()`` reconstructs exactly the oracle state.

The serving path threads through the same registry (**serve points**,
``SERVE_POINTS``): tests inject slow device rounds (``arm_serve_delay``),
dispatch errors (``arm_serve_error``), queue saturation (a collector stall
is a delay at ``sched.collect``), and killed scheduler worker threads
(``arm_serve_crash``) — so every overload / breaker / worker-death behavior
in serve/resilience is exercised deterministically, never by racing real
load.

Design constraints:
  - zero overhead when disarmed (one module-global boolean check);
  - ``InjectedCrash`` derives from BaseException so production ``except
    Exception`` guards can never swallow a simulated process death;
  - deterministic: ``arm(point, at=n)`` fires on the n-th hit of that point,
    so "kill at every crash point" enumerates reproducibly.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Dict, Optional

# every registered crash point, in rough mutation-lifecycle order. Tests
# iterate this to kill the store at each WAL/snapshot boundary.
CRASH_POINTS = (
    "wal.append.before",     # op never reached the log (op lost, never acked)
    "wal.append.torn",       # process died mid-frame-write (torn tail)
    "wal.append.after",      # frame written; died before the in-memory apply
    "wal.fsync",             # died inside the group-commit fsync
    "wal.rotate",            # died between segment close and successor open
    "snapshot.capture",      # died before the snapshot tmp dir was written
    "snapshot.written",      # tmp complete; died before the atomic install
    "snapshot.installed",    # installed; died before WAL rotate + GC
    "wal.gc",                # died before old segments were deleted
)


class InjectedCrash(BaseException):
    """Simulated process death (BaseException: nothing in the store may
    catch-and-continue past a crash)."""

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


# serving-side injection points (scheduler worker loops + device boundary),
# in request-lifecycle order. Tests arm delays/errors/crashes at these.
SERVE_POINTS = (
    "sched.collect",       # top of a collector iteration (stall = queue
                           # saturation; crash = killed collector thread)
    "sched.dispatch",      # immediately before the fused device dispatch
                           # (error = failing device path, feeds the breaker)
    "sched.device_wait",   # before the batched readback blocks (delay =
                           # slow device round, the overload-burst shape)
    "sched.complete",      # top of a completer iteration (crash = killed
                           # completer thread)
    "sched.single",        # before a fallback single execution
)

# replication-pipeline injection points (replication/), in ship-lifecycle
# order. The fleet fault drills arm these: a delay at repl.apply is a lag
# spike (stalled follower apply), a crash at repl.apply is a killed replica
# mid-ship, an error at repl.ship.frame is a flaky replication link.
REPL_POINTS = (
    "repl.ship.frame",     # primary, immediately before sending one frame
    "repl.ship.snapshot",  # primary, before a snapshot-catchup transfer
    "repl.apply",          # follower, before appending+applying a frame
    "repl.ack",            # follower, before sending an ack
)


_lock = threading.Lock()
_active = False                      # fast-path gate (read without the lock)
_armed: Dict[str, int] = {}          # point -> remaining hits before firing
_torn_frac: float = 0.5              # fraction of the frame written when torn
_fsync_errors = 0                    # pending injected fsync failures
_hits: Dict[str, int] = {}           # observability: point -> times reached
_serve_errors: Dict[str, int] = {}   # point -> remaining injected errors
_serve_crash: Dict[str, int] = {}    # point -> hits until InjectedCrash
_serve_delay: Dict[str, list] = {}   # point -> [remaining, seconds]
_repl_corrupt = 0                    # pending shipped-frame corruptions


def reset() -> None:
    """Disarm everything (test teardown)."""
    global _active, _fsync_errors, _repl_corrupt
    with _lock:
        _armed.clear()
        _hits.clear()
        _serve_errors.clear()
        _serve_crash.clear()
        _serve_delay.clear()
        _fsync_errors = 0
        _repl_corrupt = 0
        _active = False


def arm(point: str, at: int = 1) -> None:
    """Fire an InjectedCrash on the ``at``-th hit of ``point``."""
    global _active
    if point not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {point!r} "
                         f"(have {list(CRASH_POINTS)})")
    with _lock:
        _armed[point] = int(at)
        _active = True


def arm_torn(at: int = 1, frac: float = 0.5) -> None:
    """Arm a torn write: the ``at``-th WAL frame write persists only
    ``frac`` of its bytes before the injected crash — the short-write /
    power-loss-mid-sector shape recovery must truncate at."""
    global _torn_frac
    with _lock:
        _torn_frac = float(frac)
    arm("wal.append.torn", at=at)


def arm_fsync_errors(n: int = 1) -> None:
    """Make the next ``n`` fsyncs raise OSError (disk-full / EIO shape)."""
    global _active, _fsync_errors
    with _lock:
        _fsync_errors = int(n)
        _active = True


def crash_point(point: str) -> None:
    """Call site hook: dies here iff the point is armed and its countdown
    reaches zero. Disarmed cost: one global read + compare."""
    if not _active:
        return
    with _lock:
        _hits[point] = _hits.get(point, 0) + 1
        n = _armed.get(point)
        if n is None:
            return
        if n > 1:
            _armed[point] = n - 1
            return
        del _armed[point]
    raise InjectedCrash(point)


def torn_cut(size: int) -> Optional[int]:
    """If a torn write is armed (and due), return how many of ``size``
    frame bytes to persist before crashing; None = write normally. The cut
    is clamped to [0, size-1] so the frame is always incomplete."""
    if not _active:
        return None
    with _lock:
        _hits["wal.append.torn"] = _hits.get("wal.append.torn", 0) + 1
        n = _armed.get("wal.append.torn")
        if n is None:
            return None
        if n > 1:
            _armed["wal.append.torn"] = n - 1
            return None
        del _armed["wal.append.torn"]
        return max(0, min(size - 1, int(size * _torn_frac)))


def fsync_gate() -> None:
    """Raise an injected fsync failure if one is pending (rotation.fsync_file
    calls this before the real os.fsync)."""
    global _fsync_errors
    if not _active:
        return
    with _lock:
        if _fsync_errors <= 0:
            return
        _fsync_errors -= 1
    raise OSError("injected fsync failure")


def hits() -> Dict[str, int]:
    """Times each point was reached since the last reset (diagnostics)."""
    with _lock:
        return dict(_hits)


# -- serving-side injections --------------------------------------------------


def _check_serve_point(point: str) -> None:
    if point not in SERVE_POINTS and point not in REPL_POINTS:
        raise ValueError(f"unknown serve/repl point {point!r} "
                         f"(have {list(SERVE_POINTS + REPL_POINTS)})")


def arm_serve_error(point: str, n: int = 1) -> None:
    """Make the next ``n`` hits of ``point`` raise RuntimeError — the
    injected-dispatch-failure shape (retried by the retry wrapper, counted
    by the circuit breaker)."""
    global _active
    _check_serve_point(point)
    with _lock:
        _serve_errors[point] = int(n)
        _active = True


def arm_serve_crash(point: str, at: int = 1) -> None:
    """Raise InjectedCrash on the ``at``-th hit of ``point`` — a killed
    scheduler worker thread (BaseException: the worker's ``except
    Exception`` guards cannot swallow it; the thread-level handler must
    fail all outstanding futures)."""
    global _active
    _check_serve_point(point)
    with _lock:
        _serve_crash[point] = int(at)
        _active = True


def arm_serve_delay(point: str, seconds: float, n: int = 1) -> None:
    """Sleep ``seconds`` at the next ``n`` hits of ``point`` — slow device
    rounds (``sched.device_wait``) or queue saturation (a stalled
    collector, ``sched.collect``)."""
    global _active
    _check_serve_point(point)
    with _lock:
        _serve_delay[point] = [int(n), float(seconds)]
        _active = True


def serve_gate(point: str) -> None:
    """Call-site hook on the serving path: applies any armed delay, then
    any armed error or crash, in that order. Disarmed cost: one global
    read + compare (the same zero-overhead contract as crash_point)."""
    if not _active:
        return
    sleep_s = None
    exc: Optional[BaseException] = None
    with _lock:
        _hits[point] = _hits.get(point, 0) + 1
        d = _serve_delay.get(point)
        if d is not None and d[0] > 0:
            d[0] -= 1
            sleep_s = d[1]
        n = _serve_errors.get(point, 0)
        if n > 0:
            _serve_errors[point] = n - 1
            exc = RuntimeError(f"injected serve error at {point!r}")
        else:
            c = _serve_crash.get(point)
            if c is not None:
                if c > 1:
                    _serve_crash[point] = c - 1
                else:
                    del _serve_crash[point]
                    exc = InjectedCrash(point)
    if sleep_s:
        _time.sleep(sleep_s)
    if exc is not None:
        raise exc


def arm_repl_corrupt(n: int = 1) -> None:
    """Corrupt the next ``n`` shipped WAL frames in flight (one flipped
    byte mid-frame) — the torn-shipped-frame drill. The receiver must
    reject the frame on CRC and resynchronize from its acked seq."""
    global _active, _repl_corrupt
    with _lock:
        _repl_corrupt = int(n)
        _active = True


def repl_corrupt(frame: bytes) -> bytes:
    """Shipper-side hook: returns ``frame`` unchanged, or a copy with one
    byte flipped when a corruption is armed and due."""
    global _repl_corrupt
    if not _active:
        return frame
    with _lock:
        if _repl_corrupt <= 0:
            return frame
        _repl_corrupt -= 1
        _hits["repl.corrupt"] = _hits.get("repl.corrupt", 0) + 1
    b = bytearray(frame)
    b[len(b) // 2] ^= 0xFF
    return bytes(b)
