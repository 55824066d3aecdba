"""SpMM kernel wrappers: a sparse matrix (ELL or BSR) times a dense
multi-RHS panel X (n, k).

``spmm_ell`` replaces the Pallas TPU kernel ``repro/kernels/spmm.py:41``
(``spmm_ell_kernel``); ``spmm_bsr`` replaces ``repro/kernels/spmm.py:91``
(``spmm_bsr_kernel``).  Both CUDA kernels live in ``csrc/spmm.cu``; that
file's header says what bounds them and how they are laid out.  They mask
ragged rows and k themselves, so no operand is padded here.
:func:`ell_partition` sizes the ELL kernel's row tiles, warps and chunks of
X from the shape and the SM count.

On host tensors the wrappers compute the plain versions; on CUDA tensors
they launch their kernel or raise.  They take f32 values and X and int32
indices, and refuse any other dtype.  The BSR kernel takes any block edge
from 1 to :data:`MAX_BSR_BLOCK`.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import spmm_bsr_ref, spmm_ell_ref

__all__ = ["spmm_ell", "spmm_bsr", "spmm_ell_plain", "spmm_bsr_plain",
           "MAX_BSR_BLOCK", "check_bsr_block", "EllPartition",
           "ell_partition"]

#: The plain PyTorch versions the kernels are held against.
spmm_ell_plain = spmm_ell_ref
spmm_bsr_plain = spmm_bsr_ref

#: The largest BSR block edge the CUDA kernels take (csrc/spmm.cu and
#: csrc/spgemm.cu; 8, 16, 32 and 64 are compiled in, other edges run with
#: the edge as an argument).
MAX_BSR_BLOCK = 64

#: Shared memory one CTA may have on sm_90 (227 KB), and the entries of a
#: row the ELL kernel keeps there at once (a window of (col, value) pairs).
SMEM_PER_CTA = 232448
ELL_WIN = 64


@dataclasses.dataclass(frozen=True)
class EllPartition:
    """How ``spmm_ell_kernel`` cuts one call: CTAs of ``nwarps`` walking
    warps (and one that copies X), each walking ``rpw`` rows, a lane owning
    ``cpl`` columns of a panel of ``32 * cpl``; X swept in chunks of
    ``chunk`` rows (0: nothing staged, every entry gathers its row of X).
    Only these four reach the kernel: ``csrc/spmm.cu`` spmm_ell_launch
    works out the chunk count, the buffers and the staged rows' stride
    from them as the methods below do."""
    cpl: int
    rpw: int
    nwarps: int
    chunk: int

    @property
    def rows(self) -> int:
        """Rows of A per CTA."""
        return self.nwarps * self.rpw

    @property
    def panel(self) -> int:
        """Columns of X per CTA."""
        return 32 * self.cpl

    def nchunks(self, n: int) -> int:
        """Chunks of X's ``n`` rows (0 where nothing is staged)."""
        return -(-n // self.chunk) if self.chunk else 0

    def nbuf(self, n: int) -> int:
        """Chunk buffers: two where X takes more than one chunk."""
        return 2 if self.nchunks(n) > 1 else 1

    def stride(self, k: int) -> int:
        """Floats per staged row of X: the panel's width, padded to
        ``cpl``."""
        return self.cpl * -(-min(self.panel, k) // self.cpl)

    def smem_bytes(self, n: int, k: int) -> int:
        return 4 * self.nbuf(n) * self.chunk * self.stride(k) \
            + 8 * self.rows * ELL_WIN

    def grid(self, nrows: int, k: int) -> tuple[int, int]:
        return -(-nrows // self.rows), -(-k // self.panel)


def ell_partition(nrows: int, width: int, n: int, k: int, sms: int
                  ) -> EllPartition:
    """The ELL kernel's cut of ``(nrows, width) x (n, k)`` on a card of
    ``sms`` SMs.  A lane owns one column of X up to k = 32 and two above
    (panels of 64 columns beyond).  A walking warp walks one row, or four
    where one row a warp would need more than 15 walking warps a CTA at one
    CTA per SM; the CTA has at most 15 or 20 of them (for registers) and
    one more warp, which copies the chunks.  The walking warps are as many
    as put about one row tile on each SM (every CTA copies all of X into
    shared memory, so fewer, taller tiles copy less).  X goes through
    shared memory in one chunk if it fits beside the row windows, else in
    two buffers of as many rows as fit; where a tile's stored entries are
    fewer than X's rows (a staged row would serve less than one entry), in
    no chunk at all (``chunk == 0``): every entry gathers its row from
    global memory."""
    if min(nrows, width, n, k) < 1 or sms < 1:
        raise ValueError(f"ell_partition: nrows {nrows}, width {width}, "
                         f"n {n}, k {k}, sms {sms}")
    cpl = 1 if k <= 32 else 2
    npanels = -(-k // (32 * cpl))
    rpw = 4 if nrows > 15 * sms else 1
    nwarps = max(1, min(20 if rpw == 4 else 15,
                        -(-nrows * npanels // (rpw * sms))))
    gather = EllPartition(cpl, rpw, nwarps, 0)
    if nwarps * rpw * width < n:
        return gather
    # the row windows, and 64 bytes for the kernel's static barriers
    budget = SMEM_PER_CTA - gather.smem_bytes(n, k) - 64
    row_bytes = 4 * gather.stride(k)
    if n * row_bytes <= budget:
        return EllPartition(cpl, rpw, nwarps, n)
    return EllPartition(cpl, rpw, nwarps, budget // (2 * row_bytes))


@functools.lru_cache(maxsize=64)
def _ell_plan(nrows: int, width: int, n: int, k: int, device: torch.device
              ) -> EllPartition:
    """The partition for one shape on one card, made once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return ell_partition(nrows, width, n, k, sms)


def spmm_ell(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    """``y[i, :] = sum_w values[i, w] * x[cols[i, w], :]`` over every stored
    entry (ELL padding included), in any column order.  One launch a call;
    the result is the same bit for bit from run to run."""
    if _lib.on_host(values, cols, x):
        return spmm_ell_plain(values, cols, x)
    _lib.require_cuda("spmm_ell", values, cols, x)
    if values.ndim != 2 or cols.shape != values.shape or x.ndim != 2:
        raise ValueError(f"spmm_ell: values {tuple(values.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    _lib.require_dtypes("spmm_ell", (values, x), (cols,))
    nrows, width = values.shape
    n, k = x.shape
    if width and not n:
        raise ValueError(f"spmm_ell: {width} stored entries a row index an "
                         f"empty x {tuple(x.shape)}")
    y = torch.empty((nrows, k), dtype=torch.float32, device=values.device)
    if nrows == 0 or k == 0:
        return y
    if width == 0:
        return y.zero_()
    part = _ell_plan(nrows, width, n, k, values.device)
    code = _lib.lib().spmm_ell_launch(
        values.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
        nrows, width, n, k, part.cpl, part.rpw, part.nwarps, part.chunk,
        _lib.stream_of(values))
    _lib.check(code, "spmm_ell")
    spmm_ell.launches += 1
    return y


spmm_ell.launches = 0


def check_bsr_block(what: str, bs: int) -> None:
    """Raise unless the CUDA BSR kernels take block edge ``bs``."""
    if not 1 <= bs <= MAX_BSR_BLOCK:
        raise ValueError(f"{what}: block edge {bs} is outside 1.."
                         f"{MAX_BSR_BLOCK}, the edges the CUDA kernels take")


def spmm_bsr(values: torch.Tensor, cols: torch.Tensor, rowp: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y[I*bs:(I+1)*bs, :] = sum_{p in rowp[I]..rowp[I+1]} values[p] @
    x[cols[p]*bs : +bs, :]``; an empty matrix gives zeros."""
    if _lib.on_host(values, cols, rowp, x):
        return spmm_bsr_plain(values, cols, rowp, x)
    _lib.require_cuda("spmm_bsr", values, cols, rowp, x)
    if values.ndim != 3 or values.shape[1] != values.shape[2] \
            or cols.shape != values.shape[:1] or rowp.ndim != 1 \
            or x.ndim != 2 or x.shape[0] % max(values.shape[1], 1):
        raise ValueError(f"spmm_bsr: values {tuple(values.shape)}, cols "
                         f"{tuple(cols.shape)}, rowp {tuple(rowp.shape)}, "
                         f"x {tuple(x.shape)}")
    nblocks, bs, _ = values.shape
    check_bsr_block("spmm_bsr", bs)
    _lib.require_dtypes("spmm_bsr", (values, x), (cols, rowp))
    nbrows = rowp.shape[0] - 1
    k = x.shape[1]
    if nblocks == 0:
        return torch.zeros((nbrows * bs, k), dtype=torch.float32,
                           device=values.device)
    y = torch.empty((nbrows * bs, k), dtype=torch.float32,
                    device=values.device)
    if nbrows == 0 or k == 0:
        return y
    code = _lib.lib().spmm_bsr_launch(
        values.data_ptr(), cols.data_ptr(), rowp.data_ptr(), x.data_ptr(),
        y.data_ptr(), nbrows, bs, k, _lib.stream_of(values))
    _lib.check(code, "spmm_bsr")
    spmm_bsr.launches += 1
    return y


spmm_bsr.launches = 0
