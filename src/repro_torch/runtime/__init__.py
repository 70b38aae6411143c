"""Runtime policies (the port of ``repro.runtime``): the training
supervisor with restart from a checkpoint, heartbeat files, and
straggler mitigation (which the serving recovery layer also uses)."""

from repro_torch.runtime.fault_tolerance import (Heartbeat,
                                                 StragglerMitigator,
                                                 Supervisor,
                                                 TransientWorkerFailure)

__all__ = ["Heartbeat", "Supervisor", "StragglerMitigator",
           "TransientWorkerFailure"]
