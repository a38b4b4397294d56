"""Serving-path runtime of the port: the adaptive micro-batching query
scheduler with its plan/cover caches (``scheduler.py``) and the
query-lifecycle resilience layer (deadlines, admission control, circuit
breaking, graceful degradation — ``resilience/``). The reference's
hot-result cache and replica router are ROADMAP.md Queue 1 item 15."""

from geomesa_tpu_torch.serve.resilience import (ApproximateCount,  # noqa: F401
                                                CircuitOpenError, Deadline,
                                                DeadlineExceeded, ShedError)
from geomesa_tpu_torch.serve.scheduler import (PlannerBinding,  # noqa: F401
                                               QueryScheduler,
                                               SchedulerCrashed,
                                               SchedulerShutdown,
                                               StoreBinding)
