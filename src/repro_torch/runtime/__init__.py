"""repro_torch.runtime — fault tolerance and the elastic re-mesh for the
training loop (counterpart of ``repro.runtime``)."""
from repro_torch.runtime.elastic import ElasticPlan, replan
from repro_torch.runtime.fault_tolerance import (FileHeartbeatStore,
                                                 Heartbeat, HeartbeatStore,
                                                 Monitor,
                                                 TrainingSupervisor,
                                                 WorkerState)

__all__ = ["ElasticPlan", "replan", "WorkerState", "Heartbeat",
           "HeartbeatStore", "FileHeartbeatStore", "Monitor",
           "TrainingSupervisor"]
