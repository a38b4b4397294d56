"""Query-lifecycle resilience for the serving path.

Copied from ``geomesa_tpu.serve.resilience`` (host-only) with its imports
pointed at this package.

The tail-latency toolkit (Dean & Barroso, *The Tail at Scale*, CACM 2013;
Zhou et al., *Overload Control for Scaling WeChat Microservices*, SoCC
2018) applied to the TPU serving stack:

  deadline.py   per-request deadlines propagated web → datastore →
                scheduler → planner → device boundary, with cooperative
                cancellation BEFORE a doomed device round trip
  admission.py  priority-classed (interactive vs batch) bounded in-flight
                admission control; excess sheds with 429 + Retry-After
                instead of queueing into collapse
  breaker.py    circuit breaker around device dispatch (+ anything else
                that can fail fast) and the capped-backoff-with-jitter
                retry wrapper
  degrade.py    graceful degradation: eligible counts fall back to the
                stats estimator and return explicitly flagged approximate
                results when the deadline is nearly spent or the breaker
                is open

Fault injection for all of it lives in durability/faults.py
(``SERVE_POINTS``); the deterministic overload suite is
tests/test_resilience.py.
"""

from geomesa_tpu_torch.serve.resilience.admission import (  # noqa: F401
    AdmissionController, ShedError, normalize_priority)
from geomesa_tpu_torch.serve.resilience.breaker import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, retry_call)
from geomesa_tpu_torch.serve.resilience.deadline import (  # noqa: F401
    Deadline, DeadlineExceeded)
from geomesa_tpu_torch.serve.resilience.degrade import (  # noqa: F401
    ApproximateCount, is_approximate)
