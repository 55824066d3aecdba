"""Statistics-driven format auto-selection (counterpart of
``repro.sparse.selector``, DESIGN.md §9).

``matrix(a)`` is the one constructor call sites write; the rules below pick
the storage format the data shape admits, mirroring the cost ordering of
the ``spmm`` registry variants (strongest kernel first):

    DIA   banded: the non-empty diagonals are few and dense
          (``dia_fill`` >= 0.5, ``ndiags`` bounded)
    BSR   clustered: the occupied block x block tiles are mostly dense
          (``block_fill`` >= 0.5 and the shape tiles evenly)
    ELL   uniform rows: padding to the longest row wastes < 2x
          (``ell_fill`` >= 0.5)
    CSR   everything else: the paper's 3-array format, the oracle

An explicit ``format=`` overrides the rules exactly like an explicit
``variant=`` overrides registry dispatch (DESIGN.md §6).

When ``block`` is not pinned, :func:`autotune_block` probes ``block_fill``
at the :data:`BLOCK_CANDIDATES` edges (8/16/32) and picks the largest
candidate that keeps the occupied tiles at least half full.  A hit in the
block cache (:mod:`repro_torch.core.blocking`, ``op=bsr_block``) skips the
probe, and under ``REPRO_TORCH_AUTOTUNE=1`` the winner is persisted there,
as the JAX package does.  Probing is cheap host-side statistics.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np

from repro_torch.core import blocking
from repro_torch.numerics.sparse import (CSR, DIA, ELL, csr_from_dense,
                                         dia_from_dense, ell_from_csr)
from repro_torch.sparse.formats import BSR, bsr_from_dense
from repro_torch.sparse.stats import DEFAULT_BLOCK, SparseStats, sparse_stats

__all__ = ["FORMATS", "BLOCK_CANDIDATES", "BLOCKSPARSE_MAX_DENSITY",
           "select_format", "autotune_block", "matrix", "format_of"]

#: Auto-selectable formats, strongest-kernel-first (the selector's ranking).
FORMATS = ("dia", "bsr", "ell", "csr")

#: Minimum storage efficiency for a specialised format to beat CSR.
MIN_FILL = 0.5

#: Maximum live-tile density at which the block-sparse flash attention
#: kernel beats the dense flash grid for densely-expressible masks (the
#: attention-plane dual of MIN_FILL, DESIGN.md §12); read by the attention
#: slice.
BLOCKSPARSE_MAX_DENSITY = 0.5

#: DIA runs one shifted FMA per diagonal; cap the program.
MAX_DIAGS = 512

#: BSR block edges probed when ``block`` isn't pinned.
BLOCK_CANDIDATES = (8, 16, 32)

Matrix = Union[CSR, ELL, DIA, BSR]


def select_format(stats: SparseStats) -> str:
    """The format the statistics admit (see module docstring for rules)."""
    n, m = stats.shape
    if n == m and stats.ndiags and stats.ndiags <= MAX_DIAGS \
            and stats.dia_fill >= MIN_FILL:
        return "dia"
    if n % stats.block == 0 and m % stats.block == 0 \
            and stats.block_fill >= MIN_FILL:
        return "bsr"
    if stats.ell_fill >= MIN_FILL:
        return "ell"
    return "csr"


def autotune_block(a: np.ndarray, stats: Optional[SparseStats] = None
                   ) -> tuple[int, SparseStats]:
    """Probe ``block_fill`` at :data:`BLOCK_CANDIDATES` and return the
    winning BSR block edge with its statistics.

    Winner: the largest candidate that tiles the shape and keeps
    ``block_fill`` >= :data:`MIN_FILL`; when none clears the bar, the
    best-fill candidate.  A cache hit (``op=bsr_block`` keyed on
    shape/nnz/bandwidth/dtype) skips the probe; the winner persists only
    under ``REPRO_TORCH_AUTOTUNE=1``.  ``stats`` supplies an
    already-measured :data:`DEFAULT_BLOCK` measurement so callers never
    re-scan the matrix."""
    a = np.asarray(a)
    n, m = a.shape
    base = stats if stats is not None and stats.block == DEFAULT_BLOCK \
        else sparse_stats(a, block=DEFAULT_BLOCK)
    cache = blocking.get_cache()
    key = blocking.AutotuneCache.key(
        "bsr_block",
        {"m": n, "n": m, "nnz": base.nnz, "bw": base.bandwidth},
        str(a.dtype))
    hit = cache.lookup(key)
    if hit is not None and "block" in hit:
        b = int(hit["block"])
        return b, (base if b == base.block else sparse_stats(a, block=b))
    probed = {b: (base if b == base.block else sparse_stats(a, block=b))
              for b in BLOCK_CANDIDATES if n % b == 0 and m % b == 0}
    if not probed:
        return DEFAULT_BLOCK, base
    full = [b for b, s in probed.items() if s.block_fill >= MIN_FILL]
    best = max(full) if full else max(probed,
                                      key=lambda b: probed[b].block_fill)
    if blocking.autotune_enabled():
        cache.put(key, {"block": best})
    return best, probed[best]


def matrix(a: np.ndarray, format: str = "auto",
           block: Optional[int] = None, dtype=None, *,
           device: Any = None) -> Matrix:
    """Build the sparse container for ``a``, auto-selected from its
    statistics (``format="auto"``) or pinned (``format="dia"|...``), on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    ``block`` pins the BSR block edge; None probes the
    :data:`BLOCK_CANDIDATES` ladder.  ``dtype`` is a numpy dtype applied to
    ``a`` first.  The returned container carries the measured
    :class:`SparseStats` as an advisory ``.stats`` attribute."""
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype)
    if block is not None:
        stats = sparse_stats(a, block=block)
    else:
        stats = sparse_stats(a)
        # probe the block ladder only when BSR is in play: block_fill never
        # grows with the block edge, so a matrix the 8-edge statistics
        # route past BSR cannot qualify at 16/32 either
        if format == "bsr" or (format == "auto"
                               and select_format(stats) == "bsr"):
            _, stats = autotune_block(a, stats)
    fmt = select_format(stats) if format == "auto" else format
    if fmt == "dia":
        out: Matrix = dia_from_dense(a, device=device)
    elif fmt == "bsr":
        out = bsr_from_dense(a, block=stats.block, stats=stats, device=device)
    elif fmt == "ell":
        out = ell_from_csr(csr_from_dense(a, device=device))
    elif fmt == "csr":
        out = csr_from_dense(a, device=device)
    else:
        raise ValueError(f"unknown sparse format {fmt!r}; choose from "
                         f"{FORMATS} or 'auto'")
    if getattr(out, "stats", None) is None:
        object.__setattr__(out, "stats", stats)    # advisory, frozen-safe
    return out


def format_of(a: Matrix) -> str:
    """The format name of a container (the selector's vocabulary)."""
    for name, layout in (("dia", DIA), ("bsr", BSR), ("ell", ELL),
                         ("csr", CSR)):
        if isinstance(a, layout):
            return name
    raise TypeError(f"not a sparse container: {type(a)!r}")
