"""Three-term roofline model of a step on the card (counterpart of
``repro.utils.roofline``).

    compute term    = FLOPs / peak FLOP/s at the operands' dtype
    memory term     = HBM bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

The reference's ``HW`` holds one (bf16) peak.  The port's holds the f32
rate beside it: the paper's kernels run f32 on the FMA units, outside the
tensor cores, at a fifteenth of the bf16 rate, so one peak would put
their compute bound 15x too low.  :data:`H100` is the one record that
``chip_smoke.py``'s ``bound_ms``, the cost model's predictions and
:func:`analyze` read.

Where the reference reads its terms from a compiled executable
(``cost_analysis()`` and the HLO text), :func:`analyze` runs the step
once, in one counting pass: PyTorch's ``FlopCounterMode`` counts the aten
ops' FLOPs, a dispatch mode sums each aten op's operand and result bytes
(eager ops each read and write memory; views move nothing), the port's
own kernels, which launch through ctypes where no dispatch mode sees
them, are reckoned by the registry (``core/costmodel.py``, the counting
pass), and the collective bytes come from a ``torch.profiler`` trace of
the same pass (:mod:`repro_torch.utils.profile`), recorded only where a
process group is initialised.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["HW", "H100", "RooflineTerms", "analyze", "model_flops",
           "save_jsonl", "load_jsonl", "count_pass"]


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


def model_flops(cfg, n_tokens: int, *, training: bool = True) -> float:
    """6·N·D rule (forward 2ND + backward 4ND); serving forward-only =
    2·N·D, N the active parameters."""
    n = cfg.active_param_count()
    return (6.0 if training else 2.0) * n * n_tokens


def _bytes_of(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteCount(TorchDispatchMode):
    """A dispatch mode summing each aten op's operand and result bytes:
    the memory traffic of an eager step, where every op reads its inputs
    from memory and writes its outputs back.  View ops and factories (no
    tensor operand) move nothing and are not counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            moved = _bytes_of((args, kwargs))
            if moved:
                self.bytes += moved + _bytes_of(out)
        return out


class count_pass:
    """One counting pass over whatever runs inside: ``flops`` and
    ``bytes`` (aten ops and the port's kernels), ``kernels`` (the
    :class:`~repro_torch.core.costmodel.KernelCount`), and ``prof`` (a
    ``torch.profiler`` trace with shapes, for the collectives; None where
    no process group is initialised, so that no collective can run: a
    trace of a step costs seconds to read)."""

    def __enter__(self):
        import torch.distributed as dist
        from torch.profiler import ProfilerActivity, profile
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.core import costmodel

        traced = dist.is_available() and dist.is_initialized()
        self._stack = [costmodel.counting(), FlopCounterMode(display=False),
                       _ByteCount()]
        if traced:
            self._stack.insert(1, profile(activities=[ProfilerActivity.CPU],
                                          record_shapes=True))
        entered = [cm.__enter__() for cm in self._stack]
        self.kernels, self._flops, self._bytes = (entered[0], entered[-2],
                                                  entered[-1])
        self.prof = entered[1] if traced else None
        return self

    def __exit__(self, *exc):
        for cm in reversed(self._stack):
            cm.__exit__(*exc)
        self.flops = float(self._flops.get_total_flops()) + self.kernels.flops
        self.bytes = float(self._bytes.bytes) + self.kernels.bytes
        return False


def analyze(step: Callable[[], Any], *, arch: str, shape: str,
            mesh_name: str = "chip", n_chips: int = 1, cfg=None,
            n_tokens: int = 0, training: bool = True, hw: HW = H100,
            dtype: str = "bfloat16") -> RooflineTerms:
    """The three roofline terms of one run of ``step()`` (see the module
    docstring): FLOPs at ``hw``'s peak for ``dtype``, bytes at its HBM
    rate, collective bytes at its link rate, and ``useful_ratio``, the
    6·N·D (or 2·N·D) model FLOPs per card over the counted FLOPs."""
    from repro_torch.utils import profile as prof_mod

    with count_pass() as c:
        step()
    coll = prof_mod.collective_bytes(c.prof) if c.prof is not None else {}
    mf = model_flops(cfg, n_tokens, training=training) if cfg else 0.0
    mf_per_chip = mf / max(n_chips, 1)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_chip=c.flops, hbm_bytes_per_chip=c.bytes,
        coll_bytes_per_chip=float(coll.get("total", 0)),
        coll_breakdown={k: v for k, v in coll.items() if k != "total"},
        t_compute=c.flops / hw.peak_for(dtype),
        t_memory=c.bytes / hw.hbm_bw,
        t_collective=coll.get("total", 0) / hw.link_bw,
        model_flops_total=mf,
        useful_ratio=(mf_per_chip / c.flops) if c.flops else 0.0)


def save_jsonl(path: str, terms: list[RooflineTerms]) -> None:
    with open(path, "w") as f:
        for t in terms:
            f.write(json.dumps(t.to_json()) + "\n")


def load_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
