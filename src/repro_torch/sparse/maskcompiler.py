"""Mask-pattern compiler: declarative attention masks → tile-level BSR
layouts (counterpart of ``repro.sparse.maskcompiler``, a copy: the port
imports nothing of the JAX package; DESIGN.md §12).

The paper's sparse kernel (mod2as) wins exactly where the dense formulation
burns FLOPs on zeros; attention is this repo's dominant O(L²) workload, and
its production masks — causal, sliding-window, global tokens, BigBird-style
block patterns — are mostly *empty at tile granularity*.  This module is
the bridge between the sparse plane (§9) and the attention plane (§10): it
lowers a declarative :class:`MaskSpec` to the same rowptr/packed-column
layout BSR uses for matrices, so the tile-skipping flash kernel
(``kernels/flash_attention.py``) walks only the live K tiles of each Q row
with exactly the traversal shape of ``kernels/spmm.py``.

Per (Lq/bq × Lk/bk) tile the compiler classifies

    FULL     every position unmasked — the kernel skips masking entirely
    PARTIAL  mixed — masked positionally (band specs: one iota compare
             against the compiled band) or via a stored additive bias tile
             (global tokens / arbitrary block patterns)
    DEAD     every position masked — the tile is never launched

and packs each Q row's live tiles full-first, so the kernel runs two
recorded ``_for`` loops per row — an unmasked interior loop and a masked
edge loop — over dynamic ``rowp`` bounds (the paper's §3.2 dynamic-bounds
``_for``, at attention-tile granularity).

The tile occupancy matrix is measured with the sparse plane's own
:func:`~repro_torch.sparse.stats.sparse_stats`, so the layout carries a
:class:`~repro_torch.sparse.stats.SparseStats` and its **live-tile density** is
the statistic dispatch thresholds on (``selector.BLOCKSPARSE_MAX_DENSITY``).

Everything here is host-side numpy computed once per (spec, shape, blocks)
and lru-cached (the most recent :data:`LAYOUT_CACHE` of each compiler) —
statistics and layout construction are data-pipeline work, never kernel
work (the §9 rule).

Unlike the JAX compiler, the blocks need not divide the lengths: the tile
grid is ceil-divided and the last Q tile and the last K tile are short.
A tile's class counts only its positions inside (Lq, Lk); the kernels fold
a short K tile with its own key count and never write rows past Lq.  For
lengths the blocks divide, the layout is the JAX compiler's exactly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from repro_torch.sparse.stats import SparseStats, sparse_stats

__all__ = ["MaskSpec", "TileLayout", "dense_mask", "compile_layout",
           "causal_layout", "grid_layout", "dense_masked_layout", "FULL",
           "PARTIAL", "DEAD"]

#: Compiled layouts each compiler keeps (one per prompt length on the serve
#: path; older ones are recompiled if they come back).
LAYOUT_CACHE = 256

#: Tile classes (values of the per-tile classification, documentation-level —
#: the packed layout encodes them positionally, not as an array).
FULL, PARTIAL, DEAD = 2, 1, 0


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """A declarative attention mask — what the model *means*, not how any
    kernel runs it.

    Hashable and cheap: layouts compile lazily per (spec, shape, blocks)
    and cache, exactly like the FFT twiddle tables.

    Fields compose by intersection (causal ∧ window ∧ blocks), then
    ``global_tokens`` union in their full rows *and* columns (the
    LongFormer/BigBird global contract: a global token attends everywhere
    and is attended from everywhere — note this punches through causality;
    decoder-style specs simply leave it empty):

    ``causal``         query i sees keys j with ``j <= i + offset`` (offset
                       aligns the tails when Lq < Lk, as in chunked prefill)
    ``window``         sliding window: causal specs see the ``window`` most
                       recent keys (``i + offset - j < window``); bidirectional
                       specs see ``|i + offset - j| < window``
    ``global_tokens``  key/query positions with full attention
    ``blocks``         arbitrary tile-level pattern at ``block`` granularity
                       (rows × cols of bools, True = live) — BigBird random
                       blocks, document masks, anything tile-shaped
    """
    causal: bool = False
    window: Optional[int] = None
    global_tokens: tuple[int, ...] = ()
    blocks: Optional[tuple[tuple[bool, ...], ...]] = None
    block: int = 0

    def __post_init__(self):
        if self.window is not None and self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if (self.blocks is None) != (self.block == 0):
            raise ValueError("blocks and block come together: an arbitrary "
                             "tile pattern needs its granularity")

    @classmethod
    def from_block_mask(cls, mask: np.ndarray, block: int,
                        **kw) -> "MaskSpec":
        """An arbitrary block-level pattern (bool (nq, nk), True = live)."""
        arr = np.asarray(mask, bool)
        return cls(blocks=tuple(tuple(bool(x) for x in row) for row in arr),
                   block=int(block), **kw)

    @property
    def positional(self) -> bool:
        """True when the mask is a pure position band (causal/window only)
        — the kernel then masks edge tiles with one iota compare instead of
        stored bias tiles."""
        return not self.global_tokens and self.blocks is None

    @property
    def trivial_dense(self) -> bool:
        """True when a dense kernel expresses this spec natively (plain
        causal or no mask at all) — blocksparse then competes on density
        instead of being the only kernel-grade formulation."""
        return self.window is None and self.positional

    def cost_dims(self) -> dict[str, int]:
        """Structural fingerprint for the measured cost model
        (:func:`repro_torch.core.costmodel.signature`): keeps differently
        masked calls of the same tensor shapes in different shape classes,
        so the dense <-> block-sparse crossover calibrates per mask."""
        d = {"causal": int(self.causal)}
        if self.window is not None:
            d["window"] = self.window
        if self.global_tokens:
            d["nglobal"] = len(self.global_tokens)
        if self.blocks is not None:
            d["block"] = self.block
            d["liveblocks"] = sum(sum(row) for row in self.blocks)
        return d


def dense_mask(spec: MaskSpec, lq: int, lk: int) -> np.ndarray:
    """The reference bool mask (lq, lk), True = attend — the oracle every
    compiled layout must round-trip to (the property under test)."""
    qi = np.arange(lq)[:, None] + (lk - lq)          # align tails (offset)
    kj = np.arange(lk)[None, :]
    m = np.ones((lq, lk), bool)
    if spec.causal:
        m &= qi >= kj
    if spec.window is not None:
        if spec.causal:
            m &= (qi - kj) < spec.window
        else:
            m &= np.abs(qi - kj) < spec.window
    if spec.blocks is not None:
        blk = np.asarray(spec.blocks, bool)
        bs = spec.block
        if blk.shape != (-(-lq // bs), -(-lk // bs)):
            raise ValueError(
                f"block pattern {blk.shape} at granularity {bs} does not "
                f"cover ({lq}, {lk})")
        m &= np.repeat(np.repeat(blk, bs, 0), bs, 1)[:lq, :lk]
    if spec.global_tokens:
        g = np.asarray(spec.global_tokens, np.int64)
        gq = g[(g >= lk - lq) & (g < lk)] - (lk - lq)   # query-side rows
        gk = g[(g >= 0) & (g < lk)]
        m[gq, :] = True
        m[:, gk] = True
    return m


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """A mask compiled to tile-level BSR: per-Q-row live-tile extents plus a
    packed live-tile index list, full tiles first (see module docstring).

    Index arrays (host numpy — the lru-cached layout never holds device
    tensors; the tiles kernel's wrapper copies them to the card once per
    (layout, device), in a cache of its own):

    ``rowp``   (nq+1,) int32 — row i's live tiles are ``cols[rowp[i] :
               rowp[i+1]]`` (BSR's rowptr, over K tiles of one Q row)
    ``mid``    (nq,) int32 — row i's FULL tiles end (and PARTIAL tiles
               begin) at ``mid[i]``; the unmasked interior loop runs
               ``rowp[i]..mid[i]``, the masked edge loop ``mid[i]..rowp[i+1]``
    ``cols``   (ntiles,) int32 — packed K-tile indices
    ``prowp``  (nq,) int32 — PARTIAL tiles before row i: edge tile ``p`` of
               row i reads bias tile ``prowp[i] + (p - mid[i])``
    ``biases`` (max(npartial, 1), bq, bk) f32 additive bias (0 live,
               NEG_INF dead) — only consulted when ``band`` is None

    Static metadata: ``band`` is ``(causal, window, offset)`` for positional
    specs (edge tiles masked by iota compare — nothing stored), None
    otherwise.  ``stats`` is the sparse plane's :class:`SparseStats` of the
    tile occupancy matrix; :attr:`density` (live tiles / all tiles) is the
    dispatch statistic.
    """
    rowp: object                     # np (nq+1,) int32
    mid: object                      # np (nq,) int32
    prowp: object                    # np (nq,) int32
    cols: object                     # np (ntiles,) int32
    biases: object                   # np (max(npartial,1), bq, bk) f32
    shape: tuple[int, int]           # (Lq, Lk)
    block_q: int
    block_k: int
    ntiles: int                      # live tiles
    nfull: int                       # FULL tiles among them
    band: Optional[tuple[bool, Optional[int], int]]
    stats: SparseStats = dataclasses.field(compare=False)

    @property
    def nq(self) -> int:
        return -(-self.shape[0] // self.block_q)

    @property
    def nk(self) -> int:
        return -(-self.shape[1] // self.block_k)

    @property
    def density(self) -> float:
        """Live-tile fraction — what accepts()/cost threshold on."""
        return self.ntiles / (self.nq * self.nk)

    def tile_classes(self) -> np.ndarray:
        """(nq, nk) array of FULL/PARTIAL/DEAD — the round-trip view the
        property test compares against the reference mask's tiles."""
        out = np.full((self.nq, self.nk), DEAD, np.int8)
        rowp = np.asarray(self.rowp)
        mid = np.asarray(self.mid)
        cols = np.asarray(self.cols)
        for i in range(self.nq):
            out[i, cols[rowp[i]:mid[i]]] = FULL
            out[i, cols[mid[i]:rowp[i + 1]]] = PARTIAL
        return out

    def dense(self) -> np.ndarray:
        """Reconstruct the bool mask this layout encodes (FULL → all True,
        PARTIAL → its band/bias tile, DEAD → all False) — must equal
        :func:`dense_mask` of the compiled spec exactly."""
        lq, lk = self.shape
        bq, bk = self.block_q, self.block_k
        out = np.zeros((lq, lk), bool)
        rowp = np.asarray(self.rowp)
        mid = np.asarray(self.mid)
        prowp = np.asarray(self.prowp)
        cols = np.asarray(self.cols)
        biases = np.asarray(self.biases)
        for i in range(self.nq):
            for p in range(rowp[i], rowp[i + 1]):
                c = cols[p]
                if p < mid[i]:
                    tile = np.ones((bq, bk), bool)
                elif self.band is not None:
                    causal, window, off = self.band
                    qi = i * bq + np.arange(bq)[:, None] + off
                    kj = c * bk + np.arange(bk)[None, :]
                    tile = np.ones((bq, bk), bool)
                    if causal:
                        tile &= qi >= kj
                    if window is not None:
                        tile &= ((qi - kj) < window if causal
                                 else np.abs(qi - kj) < window)
                else:
                    tile = biases[prowp[i] + (p - mid[i])] == 0.0
                rows = out[i * bq:(i + 1) * bq, c * bk:(c + 1) * bk]
                rows[...] = tile[:rows.shape[0], :rows.shape[1]]
        return out


def _tiles(spec: MaskSpec, lq: int, lk: int, block_q: int, block_k: int):
    """The reference mask cut into (nq, block_q, nk, block_k) tiles, padded
    with dead positions past (Lq, Lk), and each tile's live (any position
    live) and full (every position inside (Lq, Lk) live) flags."""
    return _tiles_of(dense_mask(spec, lq, lk), block_q, block_k)


def _tiles_of(mask: np.ndarray, block_q: int, block_k: int):
    """:func:`_tiles` of a bool (Lq, Lk) mask."""
    lq, lk = mask.shape
    nq, nk = -(-lq // block_q), -(-lk // block_k)
    m = np.zeros((nq * block_q, nk * block_k), bool)
    m[:lq, :lk] = mask
    inside = np.zeros_like(m)
    inside[:lq, :lk] = True
    tiles = m.reshape(nq, block_q, nk, block_k)
    t_all = (tiles | ~inside.reshape(tiles.shape)).all(axis=(1, 3))
    return tiles, tiles.any(axis=(1, 3)), t_all


def _pack(tiles, t_all, part, shape, block_q, block_k, *, band, biased,
          stats) -> TileLayout:
    """Pack each Q row's FULL tiles, then its PARTIAL tiles (``part``
    (nq, nk) bool), into a :class:`TileLayout`; ``biased`` stores a bias
    tile for every PARTIAL tile."""
    from repro_torch.kernels.flash_attention import NEG_INF  # import cycle

    rowp, mid, prowp, cols, biases = [0], [], [], [], []
    npartial = 0
    for i in range(tiles.shape[0]):
        (full_js,) = np.nonzero(t_all[i])
        (part_js,) = np.nonzero(part[i])
        cols.extend(full_js.tolist())
        mid.append(len(cols))
        cols.extend(part_js.tolist())
        rowp.append(len(cols))
        prowp.append(npartial)
        npartial += len(part_js)
        if not biased:
            continue
        for j in part_js:
            biases.append(np.where(tiles[i, :, j, :], 0.0, NEG_INF)
                          .astype(np.float32))
    bias_arr = (np.stack(biases) if biases
                else np.zeros((1, block_q, block_k), np.float32))
    return TileLayout(
        rowp=np.asarray(rowp, np.int32),
        mid=np.asarray(mid, np.int32),
        prowp=np.asarray(prowp, np.int32),
        cols=np.asarray(cols, np.int32),
        biases=bias_arr,
        shape=shape, block_q=block_q, block_k=block_k,
        ntiles=len(cols), nfull=int(t_all.sum()), band=band, stats=stats)


@functools.lru_cache(maxsize=LAYOUT_CACHE)
def compile_layout(spec: MaskSpec, lq: int, lk: int,
                   block_q: int, block_k: int) -> TileLayout:
    """Lower ``spec`` to a :class:`TileLayout` at (block_q, block_k) tiles
    (the last of each may be short).

    Classification goes through the reference mask (host numpy, O(Lq·Lk)
    once per cached key — the same staging-array tradeoff as
    ``bsr_from_csr``); the band shortcut only changes *how edge tiles are
    masked in the kernel*, never which tiles live.
    """
    if min(lq, lk, block_q, block_k) < 1:
        raise ValueError(f"({lq}, {lk}) at ({block_q}, {block_k}) tiles")
    tiles, t_any, t_all = _tiles(spec, lq, lk, block_q, block_k)
    band = (spec.causal, spec.window, lk - lq) if spec.positional else None
    # the tile occupancy matrix, measured by the sparse plane's own stats —
    # density/bandwidth/ndiags of the *tile* matrix drive selection
    return _pack(tiles, t_all, t_any & ~t_all, (lq, lk), block_q, block_k,
                 band=band, biased=not spec.positional,
                 stats=sparse_stats(t_any.astype(np.float32)))


def causal_layout(lq: int, lk: int, block_q: int, block_k: int) -> TileLayout:
    """The degenerate banded case: plain causal compiled to row extents —
    what the dense flash kernel's causal path and the ring's diagonal
    half-blocks walk instead of launching every above-diagonal K step."""
    return compile_layout(MaskSpec(causal=True), lq, lk, block_q, block_k)


@functools.lru_cache(maxsize=LAYOUT_CACHE)
def grid_layout(lq: int, lk: int, block_q: int, block_k: int,
                causal: bool) -> TileLayout:
    """The dense grid's walk as a layout, which its backward walks: every
    tile FULL when not causal; when causal, the tiles holding a live key of
    ``qpos >= kpos`` (no tail offset, as the dense kernels mask), the
    diagonal ones PARTIAL under the band (True, None, 0)."""
    if min(lq, lk, block_q, block_k) < 1:
        raise ValueError(f"({lq}, {lk}) at ({block_q}, {block_k}) tiles")
    mask = (np.tril(np.ones((lq, lk), bool)) if causal
            else np.ones((lq, lk), bool))
    tiles, t_any, t_all = _tiles_of(mask, block_q, block_k)
    return _pack(tiles, t_all, t_any & ~t_all, (lq, lk), block_q, block_k,
                 band=(bool(causal), None, 0), biased=False,
                 stats=sparse_stats(t_any.astype(np.float32)))


@functools.lru_cache(maxsize=LAYOUT_CACHE)
def dense_masked_layout(spec: MaskSpec, lq: int, lk: int,
                        block_q: int, block_k: int) -> TileLayout:
    """``spec`` with tile skipping *disabled*: every tile launched, FULL
    tiles kept full, everything else (partial *and dead*) a stored-bias
    edge tile.  This is the A/B baseline of the density-sweep benchmark —
    the work a dense grid does for a rich mask (launch all, mask with
    NEG_INF), expressed in the tiles kernel so the comparison isolates
    exactly what skipping dead tiles buys."""
    live = compile_layout(spec, lq, lk, block_q, block_k)
    tiles, _, t_all = _tiles(spec, lq, lk, block_q, block_k)
    return _pack(tiles, t_all, ~t_all, (lq, lk), block_q, block_k,
                 band=None, biased=True, stats=live.stats)
