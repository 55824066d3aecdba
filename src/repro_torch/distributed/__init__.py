"""repro_torch.distributed — sharding rules, the parameters' partition
rules (``partition``), the hierarchical collectives plane (axis-role
reduction, ring and Cannon plans, DESIGN.md §8), ring attention, and the
mesh-scoped numerics (counterpart of ``repro.distributed``).

``repro_torch.distributed.numerics`` is deliberately NOT imported here: it
registers mesh-scoped registry variants as a side effect, and the registry
loads it per op (``registry._PROVIDERS``)."""
from repro_torch.distributed import collectives, sharding  # noqa: F401
