"""System-property registry: the typed runtime knobs the port reads.

≙ ``geomesa_tpu.config`` (the reference's GeoMesaSystemProperties tier),
trimmed to the knobs of the ported paths (the Z3 point query, the staged
scan, density, prepared queries, the serving scheduler with its
resilience layer, the index build and its native encoder, the store's LSM
delta tier and merge builds). The names
and defaults are the JAX package's, so one environment configures both. Every property reads
its environment variable on EACH access (late-bound), falling back to a
programmatic ``set`` override, then the default.

There is deliberately no counterpart of ``GEOMESA_TPU_PALLAS_REFINE``: on
the card the CUDA point-in-polygon kernel is the only path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class SystemProperty:
    """One typed knob: ``prop.get()`` → env override → set() value → default."""

    name: str                       # env var name
    default: object
    parse: Callable[[str], object]
    doc: str
    _override: object = field(default=None, repr=False)

    def get(self):
        raw = os.environ.get(self.name)
        if raw is not None:
            try:
                return self.parse(raw)
            except (TypeError, ValueError):
                pass  # malformed env values fall back (reference behavior)
        if self._override is not None:
            return self._override
        return self.default

    def set(self, value) -> None:
        self._override = value

    def unset(self) -> None:
        self._override = None


def _register(name: str, default, parse, doc: str) -> SystemProperty:
    return SystemProperty(name, default, parse, doc)


def _parse_bool(s: str) -> bool:
    return s.strip().lower() not in ("0", "false", "no", "off", "")


SCAN_RANGES_TARGET = _register(
    "GEOMESA_TPU_SCAN_RANGES_TARGET", 2000, int,
    "Target key ranges per query cover (geomesa.scan.ranges.target, "
    "QueryProperties.scala:22).")

PRUNE_BLOCK = _register(
    "GEOMESA_TPU_PRUNE_BLOCK", 4096, int,
    "Rows per gather block: the fused program's block gate and the staged "
    "path's range-pruned block cover.")

PRUNE_MAX_FRACTION = _register(
    "GEOMESA_TPU_PRUNE_MAX_FRAC", 0.25, float,
    "Fraction of the table's blocks a pruned scan may gather; above it the "
    "scan masks the full table.")

PRUNE_ENABLED = _register(
    "GEOMESA_TPU_PRUNE", True, _parse_bool,
    "Master switch for range-pruned scan execution.")

FUSED_QUERY = _register(
    "GEOMESA_TPU_FUSED_QUERY", True, _parse_bool,
    "Master switch for the fused query program (index/compiled.py). With it "
    "off, the staged ScanKernels path (index/scan.py) answers every query.")

DENSITY_PACK = _register(
    "GEOMESA_TPU_DENSITY_PACK", "auto", str,
    "Density grid readback encoding: auto (cheapest faithful of sparse/u8/"
    "fp16 by wire size), sparse, u8 (unweighted only), fp16, or none (raw "
    "f32 grid). Unknown values fall back to auto. ≙ the reference's sparse "
    "kryo density grids (DensityScan.scala:95).")

# -- recipe fast path (index/compiled.py) --------------------------------------

FUSED_SHAPE_CACHE = _register(
    "GEOMESA_TPU_FUSED_SHAPE_CACHE", 256, int,
    "LRU capacity of the per-planner (filter shape, auths) -> recipe "
    "cache that lets repeat shapes skip planning entirely.")

# -- serving: the micro-batching scheduler (serve/scheduler.py) ---------------

SCHED_ENABLED = _register(
    "GEOMESA_TPU_SCHEDULER", True, _parse_bool,
    "Master switch for the micro-batching query scheduler on the serving "
    "path (store.count_coalesced). Off: every request plans and dispatches "
    "individually.")

SCHED_FLUSH_SIZE = _register(
    "GEOMESA_TPU_SCHED_FLUSH_SIZE", 64, int,
    "Max queries fused into one batched device dispatch (flush-at-B). "
    "Matches the batched scan kernel's sweet spot (BENCH cfg1 batch64).")

SCHED_WINDOW_US = _register(
    "GEOMESA_TPU_SCHED_WINDOW_US", 1500, int,
    "Max micro-batch collection window in microseconds (flush-at-T). The "
    "scheduler adapts the live window between SCHED_MIN_WINDOW_US and this "
    "cap from observed batch sizes; lone queries never wait the full cap.")

SCHED_MIN_WINDOW_US = _register(
    "GEOMESA_TPU_SCHED_MIN_WINDOW_US", 100, int,
    "Floor of the adaptive collection window (latency bound at low traffic).")

SCHED_PLAN_CACHE = _register(
    "GEOMESA_TPU_SCHED_PLAN_CACHE", 512, int,
    "Plan-cache capacity (normalized filter + generation + auths -> plan). "
    "0 disables plan caching.")

SCHED_COVER_CACHE = _register(
    "GEOMESA_TPU_SCHED_COVER_CACHE", 256, int,
    "Cover-cache capacity (boxes/windows -> candidate gather blocks). "
    "0 disables cover caching.")

# -- query-lifecycle resilience (serve/resilience/) ---------------------------

DEADLINE_DEGRADE_MS = _register(
    "GEOMESA_TPU_DEADLINE_DEGRADE_MS", 25.0, float,
    "Graceful degradation floor: when a deadlined count reaches dispatch "
    "with less than this many ms remaining, an eligible query returns the "
    "stats-estimator approximation (flagged) instead of risking a device "
    "round trip it cannot afford. 0 disables degradation (expired queries "
    "then fail with deadline-exceeded only).")

ADMIT_ENABLED = _register(
    "GEOMESA_TPU_ADMIT", True, _parse_bool,
    "Master switch for serving-path admission control (bounded in-flight "
    "work per priority class; excess sheds with 429 + Retry-After).")

ADMIT_INTERACTIVE = _register(
    "GEOMESA_TPU_ADMIT_INTERACTIVE", 512, int,
    "Max in-flight (queued + executing) interactive-class queries before "
    "new ones shed. Sized so a full queue drains within a typical "
    "interactive deadline at the measured batch throughput.")

ADMIT_BATCH = _register(
    "GEOMESA_TPU_ADMIT_BATCH", 128, int,
    "Max in-flight analytics/batch-class queries (the lower bound keeps "
    "background scans from starving interactive traffic; the scheduler "
    "queue additionally serves interactive requests first).")

ADMIT_RETRY_AFTER_S = _register(
    "GEOMESA_TPU_ADMIT_RETRY_AFTER_S", 1.0, float,
    "Retry-After seconds returned with shed (429) responses.")

QOS_ENABLED = _register(
    "GEOMESA_TPU_QOS", True, _parse_bool,
    "Master switch for weighted-fair tenant QoS inside admission "
    "control: each tenant's in-flight share of a priority class is "
    "bounded, so a noisy tenant saturates its own share and sheds 429 "
    "while other tenants' latency holds.")

QOS_TENANT_SHARE = _register(
    "GEOMESA_TPU_QOS_TENANT_SHARE", 0.5, float,
    "Maximum fraction of a priority class's in-flight limit one tenant "
    "may hold while other tenants are active (a lone tenant may use "
    "the full class limit — work-conserving, not a hard quota).")

QOS_TENANT_MIN = _register(
    "GEOMESA_TPU_QOS_TENANT_MIN", 2, int,
    "Floor on the per-tenant in-flight share: fairness never starves a "
    "tenant below this many slots regardless of the share fraction.")

QOS_ACTIVE_S = _register(
    "GEOMESA_TPU_QOS_ACTIVE_S", 2.0, float,
    "How long a tenant counts as active after its last admitted request. "
    "The per-tenant share cap engages only while >= 2 tenants are active "
    "in a class (work-conserving: a lone tenant is never throttled), so "
    "this window is how fast a quiet tenant's claim on fairness decays.")

BREAKER_THRESHOLD = _register(
    "GEOMESA_TPU_BREAKER_THRESHOLD", 5, int,
    "Consecutive device-dispatch failures that open the circuit breaker "
    "(while open, eligible counts degrade to the stats estimator and "
    "other queries fail fast with 503 instead of queueing onto a sick "
    "device path).")

BREAKER_COOLDOWN_MS = _register(
    "GEOMESA_TPU_BREAKER_COOLDOWN_MS", 1000.0, float,
    "How long an open breaker waits before letting half-open probe "
    "traffic through.")

BREAKER_PROBES = _register(
    "GEOMESA_TPU_BREAKER_PROBES", 2, int,
    "Consecutive half-open probe successes required to close the breaker "
    "(any probe failure re-opens and restarts the cooldown).")

BREAKER_DEGRADE = _register(
    "GEOMESA_TPU_BREAKER_DEGRADE", True, _parse_bool,
    "When the breaker is open, serve eligible counts from the stats "
    "estimator (flagged approximate) instead of failing fast.")

RETRY_ATTEMPTS = _register(
    "GEOMESA_TPU_RETRY_ATTEMPTS", 3, int,
    "Max attempts for the device-dispatch retry wrapper (capped "
    "exponential backoff with full jitter between attempts).")

RETRY_BASE_MS = _register(
    "GEOMESA_TPU_RETRY_BASE_MS", 5.0, float,
    "Backoff base: attempt i sleeps uniform(0, min(cap, base * 2^i)) ms.")

RETRY_CAP_MS = _register(
    "GEOMESA_TPU_RETRY_CAP_MS", 100.0, float,
    "Backoff ceiling per retry sleep.")

# -- trace context (trace.py) -------------------------------------------------

# -- the index build (index/spatial.py, native/) ------------------------------

BUILD_STREAM_CHUNK = _register(
    "GEOMESA_TPU_BUILD_STREAM_CHUNK", 16_777_216, int,
    "Rows per chunk for the streamed native build: the C++ encoder works "
    "on chunk i+1 while chunk i uploads in a background thread (encode and "
    "host->device transfer overlap instead of summing).")

NO_NATIVE = _register(
    "GEOMESA_TPU_NO_NATIVE", False, _parse_bool,
    "Disable the native C++ encode path (numpy fallback). NB boolean "
    "semantics: '0'/'false'/'no'/'off' mean NOT disabled (earlier releases "
    "treated any non-empty value as disabling).")

LSM_MAX_FRACTION = _register(
    "GEOMESA_TPU_LSM_MAX_FRAC", 0.02, float,
    "Delta-run flush threshold as a fraction of the main table.")

MERGE_BUILD = _register(
    "GEOMESA_TPU_MERGE_BUILD", True, _parse_bool,
    "Master switch for delta-incremental merge builds: an LSM delta-tier "
    "flush merges the already-sorted resident run with the freshly-sorted "
    "delta run (merge-by-key; block metadata rebuilt from the merge, not "
    "a re-sort) instead of re-sorting the full table. Destructive paths "
    "(remove/update/upsert-collision/age-off drops/schema change) always "
    "fall back to a full rebuild.")

MERGE_MAX_FRACTION = _register(
    "GEOMESA_TPU_MERGE_MAX_FRACTION", 0.25, float,
    "Largest delta-to-resident row fraction the merge build accepts; a "
    "flush above it (bulk load through the delta tier) takes the full "
    "rebuild, whose O(n log n) sort amortizes better at that scale.")

NODE_ID = _register(
    "GEOMESA_TPU_NODE_ID", "", str,
    "Stable node identity for fleet observability (the `node` label on "
    "federated metrics, the node dimension on traces/flight events, the "
    "/healthz + BENCH_summary attribution). Empty = derived "
    "hostname-pid-suffix, unique per process incarnation.")

JOIN_DEVICE_MIN_PAIRS = _register(
    "GEOMESA_TPU_JOIN_DEVICE_MIN_PAIRS", 32_768, int,
    "Candidate-pair count above which the extent join's exact refine runs "
    "on the device band kernel (parallel/pair_kernel: pair_band; below it, "
    "host f64 soups win — each device dispatch pays a launch and a "
    "readback).")

# -- the geometry function catalog (geom/catalog.py) -------------------------

GEOM_KERNELS = _register(
    "GEOMESA_TPU_GEOM_KERNELS", True, _parse_bool,
    "Evaluate st_* residual predicates through the device catalog "
    "(geom/catalog.py: the geom_unary, geom_dist and geom_pred kernels; "
    "the predicates' uncertain sliver refined by the f64 host oracle, so "
    "booleans stay exact; scalar comparisons read the f32 kernel value, "
    "as the reference's do). Off: every Func residual evaluates on the "
    "f64 host oracle.")

GEOM_FUSE = _register(
    "GEOMESA_TPU_GEOM_FUSE", True, _parse_bool,
    "Registered as the reference registers it, and read nowhere (the "
    "reference reads it nowhere either): the fused program lowers its "
    "eligible Func residuals whatever its value.")

GEOM_CHUNK = _register(
    "GEOMESA_TPU_GEOM_CHUNK", 4_000_000, int,
    "Element budget of the catalog's plain pairwise tables (feature "
    "segment x literal segment): the plain predicate and distance run "
    "their rows in chunks so B*64*L stays under it. The kernels build no "
    "pair table and take a call's rows in one launch.")
