"""SpMM kernel wrappers: a sparse matrix (ELL or BSR) times a dense
multi-RHS panel X (n, k).

``spmm_ell`` replaces the Pallas TPU kernel ``repro/kernels/spmm.py:41``
(``spmm_ell_kernel``); ``spmm_bsr`` replaces ``repro/kernels/spmm.py:91``
(``spmm_bsr_kernel``).  Both CUDA kernels live in ``csrc/spmm.cu``; that
file's header says what bounds them and how they are laid out.  They mask
ragged rows and k themselves, so no operand is padded here.
:func:`ell_partition` sizes the ELL kernel's row tiles, warps and chunks of
X, from the shape and the SM count, and :func:`bsr_partition` the BSR
kernel's panels, lanes and warps, from the shape.

On host tensors the wrappers compute the plain versions; on CUDA tensors
they launch their kernel or raise.  They take f32 values and X and int32
indices, and refuse any other dtype.  The BSR kernels run block edges 1 to
:data:`MAX_BSR_BLOCK`; both BSR wrappers take any edge, re-cutting a
larger one into sub-blocks of edge :func:`recut_edge` first
(:func:`bsr_recut`, the same matrix on the operands' device).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import spmm_bsr_ref, spmm_ell_ref
from repro_torch.numerics.sparse import csr_row_ids

__all__ = ["spmm_ell", "spmm_bsr", "spmm_ell_plain", "spmm_bsr_plain",
           "MAX_BSR_BLOCK", "recut_edge", "bsr_recut", "bsr_uncut",
           "EllPartition", "ell_partition", "BsrPartition", "bsr_partition"]

#: The plain PyTorch versions the kernels are held against.
spmm_ell_plain = spmm_ell_ref
spmm_bsr_plain = spmm_bsr_ref

#: The largest BSR block edge the CUDA kernels run (csrc/spmm.cu and
#: csrc/spgemm.cu); the wrappers re-cut a larger edge (:func:`bsr_recut`).
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


#: The BSR kernel's widest panel of X's columns, the most warps it gives a
#: block-row, and the outputs a lane may keep.  csrc/spmm.cu owns the
#: stage layout and takes as many of the warps as fit shared memory.
BSR_MAX_PANEL = 64
BSR_MAX_WARPS = 8
BSR_LANE_OUTPUTS = 32


@dataclasses.dataclass(frozen=True)
class BsrPartition:
    """How ``spmm_bsr_kernel`` cuts one call: a CTA of up to ``warps``
    warps a (block-row, panel of ``panel`` columns of X); the row's blocks
    are split evenly into one contiguous range a warp, whose partials are
    added in warp order.  Lanes cover the (bs, panel) output tile as
    ``32 // lanes_c`` rows x ``lanes_c`` pairs of columns, a lane owning
    ``rpl`` rows x 2 columns."""
    panel: int
    lanes_c: int
    rpl: int
    warps: int

    def grid(self, nbrows: int, k: int) -> tuple[int, int]:
        return nbrows, -(-k // self.panel)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


@functools.lru_cache(maxsize=64)
def bsr_partition(nbrows: int, nblocks: int, bs: int, k: int
                  ) -> BsrPartition:
    """The BSR kernel's cut of ``nblocks`` blocks of edge ``bs`` in
    ``nbrows`` block-rows times X (n, k).

    The panel is k up to 64 columns, and no wider than keeps a lane at 32
    outputs (a power of two <= 1024 / bs: 64 at bs 8 and 16, 32 at bs 32,
    16 at bs 64); lanes pair up its columns, a power of two of them across,
    the rest of the 32 down the rows.  A block-row gets one warp per block
    on average, up to 8."""
    if min(nbrows, nblocks, bs, k) < 1 or bs > MAX_BSR_BLOCK:
        raise ValueError(f"bsr_partition: nbrows {nbrows}, nblocks "
                         f"{nblocks}, bs {bs}, k {k}")
    cap = 1 << ((BSR_LANE_OUTPUTS * 32) // bs).bit_length() - 1
    panel = min(k, BSR_MAX_PANEL, cap)
    lanes_c = _pow2_at_least(-(-panel // 2))
    rpl = _pow2_at_least(-(-bs // (32 // lanes_c)))
    warps = max(1, min(BSR_MAX_WARPS, -(-nblocks // nbrows)))
    return BsrPartition(panel, lanes_c, rpl, warps)


def recut_edge(bs: int) -> int:
    """The edge the BSR kernels run a block edge ``bs`` at: ``bs`` itself
    up to :data:`MAX_BSR_BLOCK`, above it its largest divisor that is no
    larger."""
    return next(d for d in range(min(bs, MAX_BSR_BLOCK), 0, -1)
                if bs % d == 0)


def _recut_order(rowp: torch.Tensor, nblocks: int, m: int) -> torch.Tensor:
    """Where sub-block (a, b) of block p lands when each block is cut into
    m x m sub-blocks: (nblocks, m, m) positions in the re-cut entry order,
    which walks sub-block-row a of block-row I over I's blocks in order,
    m sub-blocks each.  Blocks past rowp[-1] (none in a well-formed BSR)
    land after every row's."""
    dev = rowp.device
    r = torch.cat((rowp.long(), torch.full((1,), nblocks, device=dev)))
    row = csr_row_ids(r, nblocks)
    start = r[row]
    length = r[row + 1] - start
    # sub-block (0, 0) of block p; then a sub-block-row down is a whole
    # block-row's m * length further, a sub-block across is one further
    first = m * m * start + m * (torch.arange(nblocks, device=dev) - start)
    ar = torch.arange(m, device=dev)
    return first.view(-1, 1, 1) + (m * length).view(-1, 1, 1) \
        * ar.view(1, m, 1) + ar.view(1, 1, m)


def bsr_recut(values: torch.Tensor | None, cols: torch.Tensor,
              rowp: torch.Tensor, bs: int, d: int):
    """The same BSR matrix in sub-blocks of edge ``d`` (a divisor of
    ``bs``): each block (I, J) becomes the m x m sub-blocks (I*m + a,
    J*m + b), m = bs // d, a sub-block-row holding its sub-blocks in its
    block-row's block order.  Returns ``(values, cols, rowp, order)``
    (``values`` None if none were given); ``order`` (nblocks, m, m) says
    where sub-block (a, b) of block p went, so that results made on the
    re-cut pattern can be put back.  Torch operations only, on the
    operands' device, with no host sync: every size follows from the
    shapes."""
    nblocks = cols.shape[0]
    m = bs // d
    order = _recut_order(rowp, nblocks, m)
    flat = order.reshape(-1)
    ar = torch.arange(m, device=cols.device)
    sub_cols = (cols.long().view(-1, 1, 1) * m + ar.view(1, 1, m)).expand(
        nblocks, m, m).reshape(-1)
    new_cols = torch.empty_like(flat, dtype=torch.int32).index_copy_(
        0, flat, sub_cols.to(torch.int32))
    r = rowp.long()
    starts = (m * m * r[:-1]).view(-1, 1) \
        + ar.view(1, m) * (m * (r[1:] - r[:-1])).view(-1, 1)
    new_rowp = torch.cat((starts.reshape(-1), m * m * r[-1:]))
    new_vals = None
    if values is not None:
        sub = values.reshape(nblocks, m, d, m, d).permute(0, 1, 3, 2, 4) \
            .reshape(nblocks * m * m, d, d)
        new_vals = torch.empty_like(sub).index_copy_(0, flat, sub)
    return new_vals, new_cols, new_rowp.to(torch.int32), order


def bsr_uncut(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`bsr_recut` on values: the (nblocks * m * m,
    d, d) sub-blocks of a re-cut pattern put back into the (nblocks, bs,
    bs) blocks ``order`` came from."""
    nblocks, m, _ = order.shape
    d = values.shape[-1]
    return values[order.reshape(-1)].reshape(nblocks, m, m, d, d) \
        .permute(0, 1, 3, 2, 4).reshape(nblocks, m * d, m * d)


def spmm_bsr(values: torch.Tensor, cols: torch.Tensor, rowp: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y[I*bs:(I+1)*bs, :] = sum_{p in rowp[I]..rowp[I+1]} values[p] @
    x[cols[p]*bs : +bs, :]``; an empty matrix gives zeros.  Any block edge:
    above :data:`MAX_BSR_BLOCK` the kernel runs on :func:`bsr_recut`'s
    sub-blocks.  One launch a call; the result is the same bit for bit from
    run to run."""
    if _lib.on_host(values, cols, rowp, x):
        return spmm_bsr_plain(values, cols, rowp, x)
    _lib.require_cuda("spmm_bsr", values, cols, rowp, x)
    if values.ndim != 3 or values.shape[1] != values.shape[2] \
            or values.shape[1] < 1 or cols.shape != values.shape[:1] \
            or rowp.ndim != 1 or rowp.shape[0] < 1 or x.ndim != 2 \
            or x.shape[0] % values.shape[1]:
        raise ValueError(f"spmm_bsr: values {tuple(values.shape)}, cols "
                         f"{tuple(cols.shape)}, rowp {tuple(rowp.shape)}, "
                         f"x {tuple(x.shape)}")
    _lib.require_dtypes("spmm_bsr", (values, x), (cols, rowp))
    nblocks, bs, _ = values.shape
    nbrows = rowp.shape[0] - 1
    k = x.shape[1]
    if nblocks == 0:
        return torch.zeros((nbrows * bs, k), dtype=torch.float32,
                           device=values.device)
    y = torch.empty((nbrows * bs, k), dtype=torch.float32,
                    device=values.device)
    if nbrows == 0 or k == 0:
        return y
    d = recut_edge(bs)
    if d != bs:
        values, cols, rowp, _ = bsr_recut(values, cols, rowp, bs, d)
        nblocks, nbrows, bs = values.shape[0], rowp.shape[0] - 1, d
    part = bsr_partition(nbrows, nblocks, bs, k)
    code = _lib.lib().spmm_bsr_launch(
        values.data_ptr(), cols.data_ptr(), rowp.data_ptr(), x.data_ptr(),
        y.data_ptr(), nbrows, bs, k, part.panel, part.lanes_c, part.rpl,
        part.warps, _lib.stream_of(values))
    _lib.check(code, "spmm_bsr")
    spmm_bsr.launches += 1
    return y


spmm_bsr.launches = 0
