"""repro_torch.runtime — fault tolerance for the training loop
(counterpart of ``repro.runtime``; the elastic re-mesh is mesh scope)."""
from repro_torch.runtime.fault_tolerance import (FileHeartbeatStore,
                                                 Heartbeat, HeartbeatStore,
                                                 Monitor,
                                                 TrainingSupervisor,
                                                 WorkerState)

__all__ = ["WorkerState", "Heartbeat", "HeartbeatStore",
           "FileHeartbeatStore", "Monitor", "TrainingSupervisor"]
