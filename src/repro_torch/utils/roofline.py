"""Roofline records of the card (counterpart of ``repro.utils.roofline``,
its ``HW`` and ``RooflineTerms`` only; ``analyze`` and a profiler analogue
of the HLO parser are ROADMAP queue 1 item 9).

    compute term    = FLOPs / peak FLOP/s at the operands' dtype
    memory term     = HBM bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

The reference's ``HW`` holds one (bf16) peak.  The port's holds the f32
rate beside it: the paper's kernels run f32 on the FMA units, outside the
tensor cores, at a fifteenth of the bf16 rate, so one peak would put
their compute bound 15x too low.  :data:`H100` is the one record that
``chip_smoke.py``'s ``bound_ms`` and the cost model's predictions read.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["HW", "H100", "RooflineTerms"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float          # per card, bf16 (tensor cores, dense)
    hbm_bw: float              # bytes/s per card
    link_bw: float             # bytes/s per NVLink direction
    peak_flops_f32: float = 0.0   # per card, f32 FMA outside tensor cores

    def peak_for(self, dtype: str) -> float:
        """The peak FLOP/s for operands of ``dtype`` (a numpy-style name,
        :func:`repro_torch.core.costmodel.dtype_of`): the tensor-core rate
        for 16-bit floats, the FMA rate for everything else."""
        if dtype in ("bfloat16", "float16"):
            return self.peak_flops
        return self.peak_flops_f32 or self.peak_flops


#: NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit: 989 TFLOP/s
#: bf16, 67 TFLOP/s f32 FMA, 3.35 TB/s HBM3, 450 GB/s NVLink a direction.
H100 = HW(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
          link_bw=450e9, peak_flops_f32=67e12)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict[str, int]
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_total: float            # 6·N·D (MoE: active N)
    useful_ratio: float                 # model flops / counted flops
    argument_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """t_compute / max(all terms): 1.0 means compute-bound with no
        exposed memory or collective time."""
        return self.t_compute / max(self.step_time, 1e-30)

    @property
    def mfu_bound(self) -> float:
        """Upper bound on model-flops-utilisation: useful flops over the
        bf16 peak at the step-time lower bound."""
        useful = self.flops_per_chip * self.useful_ratio
        return useful / (self.step_time * H100.peak_flops) \
            if self.step_time else 0.0

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["step_time"] = self.step_time
        d["roofline_fraction"] = self.roofline_fraction
        d["mfu_bound"] = self.mfu_bound
        return d
