"""Elastic scaling: re-mesh a job onto the survivor set (counterpart of
``repro.runtime.elastic``).

Policy (synchronous SPMD): the *model* axis is sacred (param shards must be
whole), so elasticity happens on the data/pod axes: shrink the data-
parallel replicas to the largest count the survivors support, and keep the
global batch by raising gradient accumulation.

The checkpoint stores logical PartitionSpecs, not device ids, so a restore
on the new mesh is ``Checkpointer.restore(..., shardings=)`` with
shardings built for that mesh (each rank keeps its tiles); this module
computes the new mesh shape and the new accumulation factor.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ElasticPlan", "replan"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    pod: int                 # 0 = no pod axis
    data: int
    model: int
    microbatches: int        # grad-accumulation factor preserving global batch

    @property
    def devices(self) -> int:
        return max(self.pod, 1) * self.data * self.model

    def mesh_shape(self) -> tuple[int, ...]:
        return (self.pod, self.data, self.model) if self.pod \
            else (self.data, self.model)

    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.pod else ("data", "model")


def replan(available_devices: int, *, model: int, global_batch: int,
           per_replica_batch: int, pods: int = 0) -> ElasticPlan:
    """Largest data-parallel width the survivors support.

    ``model`` is fixed (param shards must stay whole).  The data axis is the
    largest d with d * model * max(pods, 1) <= available and d | global_batch.
    Grad accumulation keeps the global batch constant.
    """
    if available_devices < model:
        raise ValueError(
            f"{available_devices} devices cannot host model={model} shards")
    pod_f = max(pods, 1)
    data = available_devices // (model * pod_f)
    if data < 1:
        pods, pod_f = 0, 1
        data = available_devices // model
    # shrink until it divides the global batch
    while data > 1 and global_batch % data:
        data -= 1
    replicas = data * pod_f
    per_step = replicas * per_replica_batch
    microbatches = max(1, -(-global_batch // per_step))
    return ElasticPlan(pod=pods if pod_f > 1 else 0, data=data, model=model,
                       microbatches=microbatches)
