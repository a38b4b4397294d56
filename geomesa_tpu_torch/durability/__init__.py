"""Durability subsystem of the port: so far only the fault-injection
registry (``faults``), which the serving path's fault points use. The
write-ahead log, snapshots and recovery are ROADMAP.md Queue 1 item 15."""

from geomesa_tpu_torch.durability import faults  # noqa: F401
