"""Split-stream FFT stage kernel wrappers (mod2f).

Replace the Pallas TPU kernel ``repro/kernels/fft.py:36``
(``fft_stage_kernel``), which the JAX package launches once per stage.
The CUDA kernel (``csrc/fft.cu``) runs up to :data:`STAGES_PER_PASS`
consecutive stages per launch in shared memory: a pass reads contiguous
groups of 2^k points, runs k stages on each, and writes its local point r
of group g to ``g + r * n / 2^k``.  Two wrappers launch it:

    fft_stages   ``count`` stages from stage ``s0`` on flat re/im data, in
                 ``ceil(count / STAGES_PER_PASS)`` passes enqueued by one
                 host call; :func:`repro_torch.kernels.ops.fft` runs a whole
                 transform through it.
    fft_stage    one stage on the (n/2, 2) view, with the TPU function's
                 contract (any ``m`` dividing n/2): a one-stage pass.

The kernel reads the stage's twiddle as ``tw[u % m]`` from the untiled
table, where the TPU code materialised ``tile(tw[:m], i)`` before every
stage.  ``fft_stages.launches`` counts kernel launches (passes) of both.

On host tensors the wrappers compute their plain versions; on CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import fft_stage_ref

__all__ = ["fft_stage", "fft_stage_plain", "fft_stages", "fft_stages_plain",
           "pass_sizes", "STAGES_PER_PASS", "POINTS_PER_CTA"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 2}

#: Stages per pass (KMAX in csrc/fft.cu): a group of 2^10 points.
STAGES_PER_PASS = 10
#: Points one CTA holds in shared memory (POINTS in csrc/fft.cu).
POINTS_PER_CTA = 4096


def pass_sizes(count: int) -> list[int]:
    """Stages per pass for ``count`` stages, as csrc/fft.cu splits them:
    ``ceil(count / STAGES_PER_PASS)`` passes as even as can be, the longer
    ones first."""
    passes = -(-count // STAGES_PER_PASS)
    return [count // passes + (p < count % passes) for p in range(passes)]


def fft_stage_plain(data_re, data_im, tw_re, tw_im, m: int):
    """The plain version: tile the twiddle prefix ``tw[:m]`` to n/2 entries
    and apply :func:`repro_torch.kernels.ref.fft_stage_ref`."""
    half = data_re.shape[0]
    reps = half // m
    return fft_stage_ref(data_re, data_im, tw_re[:m].repeat(reps),
                         tw_im[:m].repeat(reps))


def fft_stages_plain(re, im, tw_re, tw_im, s0: int, count: int):
    """``count`` applications of :func:`fft_stage_plain` to flat (n,) data,
    stage s (from ``s0``) with ``m = (n/2) >> s``."""
    n = re.shape[0]
    for s in range(s0, s0 + count):
        ore, oim = fft_stage_plain(re.view(n // 2, 2), im.view(n // 2, 2),
                                   tw_re, tw_im, (n // 2) >> s)
        re, im = ore.view(n), oim.view(n)
    return re, im


def _launch(what, re, im, tw_re, tw_im, count: int, m0: int):
    """Check the operands and enqueue ``count`` stages over flat (n,)
    re/im starting at twiddle count ``m0``; returns flat (out_re, out_im)."""
    _lib.require_cuda(what, re, im, tw_re, tw_im)
    n = re.shape[0]
    if re.shape != (n,) or im.shape != (n,) or tw_re.ndim != 1 \
            or tw_re.shape != tw_im.shape or tw_re.shape[0] < m0:
        raise ValueError(f"{what}: data {tuple(re.shape)}/"
                         f"{tuple(im.shape)}, twiddles {tuple(tw_re.shape)}/"
                         f"{tuple(tw_im.shape)}, m={m0}")
    dtype = re.dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype
                                       for t in (im, tw_re, tw_im)):
        raise ValueError(f"{what}: takes one real dtype, f32 or f64")
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    passes = len(pass_sizes(count))
    scratch = (torch.empty_like(re), torch.empty_like(im)) if passes > 1 \
        else (None, None)
    code = _lib.lib().fft_stages_launch(
        re.data_ptr(), im.data_ptr(), tw_re.data_ptr(), tw_im.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch), n, count, m0,
        _DTYPE_CODE[dtype], _lib.stream_of(re))
    _lib.check(code, what)
    fft_stages.launches += passes
    return out_re, out_im


def fft_stages(re: torch.Tensor, im: torch.Tensor, tw_re: torch.Tensor,
               tw_im: torch.Tensor, s0: int, count: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stages ``s0 .. s0 + count - 1`` of the split-stream transform of
    length n (a power of two) on tangled flat (n,) re/im, with the untiled
    bit-reversed twiddle table ``tw_*``.  Returns flat (out_re, out_im)."""
    n = re.shape[0]
    logn = n.bit_length() - 1
    if n < 2 or n != 1 << logn or count < 1 or s0 < 0 \
            or s0 + count > logn:
        raise ValueError(f"fft_stages: n={n} must be a power of two >= 2 "
                         f"and stages {s0}..{s0 + count - 1} within "
                         f"0..{logn - 1}")
    if _lib.on_host(re, im, tw_re, tw_im):
        return fft_stages_plain(re, im, tw_re, tw_im, s0, count)
    return _launch("fft_stages", re, im, tw_re, tw_im, count,
                   (n // 2) >> s0)


fft_stages.launches = 0


def fft_stage(data_re: torch.Tensor, data_im: torch.Tensor,
              tw_re: torch.Tensor, tw_im: torch.Tensor, m: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One split-stream stage.  ``data_*`` are (n/2, 2) (column 0 even,
    column 1 odd), ``tw_*`` the untiled twiddle table (at least ``m``
    entries), and ``m`` divides n/2.  Returns (out_re, out_im), each
    (2, n/2): row 0 up, row 1 down."""
    half = data_re.shape[0]
    if m < 1 or half % m != 0:
        raise ValueError(f"fft_stage: m={m} must divide n/2={half}")
    if _lib.on_host(data_re, data_im, tw_re, tw_im):
        return fft_stage_plain(data_re, data_im, tw_re, tw_im, m)
    if data_re.shape != (half, 2) or data_im.shape != (half, 2):
        raise ValueError(f"fft_stage: data {tuple(data_re.shape)}/"
                         f"{tuple(data_im.shape)} is not (n/2, 2)")
    if half == 0:
        return tuple(torch.empty((2, 0), dtype=data_re.dtype,
                                 device=data_re.device) for _ in range(2))
    _lib.require_cuda("fft_stage", data_re, data_im)
    out_re, out_im = _launch("fft_stage", data_re.view(-1), data_im.view(-1),
                             tw_re, tw_im, 1, m)
    return out_re.view(2, half), out_im.view(2, half)
