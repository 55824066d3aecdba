"""Linear solvers: conjugate gradients (paper §3.4), Jacobi and Gauss-Seidel
(counterpart of ``repro.numerics.solvers``), at chip scope.

The CG port is the paper's listing on the DSL: a ``_while`` whose condition
is ``r2 > stop && k < max_iters`` and whose body composes the SpMV with dot
products.  The SpMV formulation is a ``solver_spmv`` registry variant
('spmv1', 'spmv2', 'ell', 'dia', and 'spmm' for a BSR matrix);
``backend=None`` picks the strongest one the matrix layout admits.  As in
the JAX package the element-format variants are DSL programs and reach no
kernel; the 'spmm' route reaches the BSR kernel.

The iteration count and final residual stay on the device in
:class:`CGResult`; the loop condition itself is read on the host once per
iteration (see ``repro_torch.core.control.arbb_while``).

``cg_block_solve`` is the multi-RHS block CG on the ``spmm`` plane: one
SpMM dispatch per iteration (a CUDA kernel on BSR and ELL operands on the
card) and k x k rank-revealing Gram solves.

Under an ambient O3/O4 mesh the registry selects a mesh-scoped
``solver_spmv`` and ``cg_solve`` runs the whole solve row-sharded
(:func:`repro_torch.distributed.numerics.cg_mesh`: every dot product a
hierarchical all-reduce); ``cg_block_solve``'s SpMM dispatches
``mesh_spmm`` and gathers its row-sharded product.  An explicit
``backend=`` still pins either scope.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import Dense, arbb_while, call, unwrap, wrap
from repro_torch.core import registry
from repro_torch.distributed.sharding import gather
from repro_torch.numerics import spmv as spmv_mod  # noqa: F401  (registers solver_spmv)
from repro_torch.numerics.sparse import CSR, DIA, ELL

__all__ = ["cg_solve", "cg_jit", "cg_block_solve", "jacobi_solve",
           "gauss_seidel_solve", "CGResult", "BlockCGResult"]

Matrix = Union[CSR, ELL, DIA]


@dataclasses.dataclass
class CGResult:
    """Device-resident result; ``int(res.iterations)`` /
    ``float(res.residual_sq)`` copy to the host at the caller's edge."""
    x: Dense
    iterations: torch.Tensor    # int32 scalar, on device
    residual_sq: torch.Tensor   # f32 scalar, on device


def _spmv(a: Matrix, p, backend: Optional[str]):
    return registry.dispatch("solver_spmv", a, wrap(p), variant=backend)


def _selected_spmv(a: Matrix, bv, backend: Optional[str]
                   ) -> registry.Variant:
    """The solver_spmv variant the registry would run for this solve: the
    scope decision (the chip loop or the mesh solve) hangs off its
    scope."""
    return registry.select("solver_spmv", a, wrap(bv), variant=backend)


def _cg_mesh(a: Matrix, bv, stop, max_iters: int, backend: Optional[str]):
    from repro_torch.distributed import numerics as dnum
    return dnum.cg_mesh(a, bv, stop=stop, max_iters=max_iters,
                        variant=backend)


def _cg_core(a: Matrix, bv: torch.Tensor, stop: float, max_iters: int,
             backend: Optional[str]):
    """The §3.4 iteration from x0 = 0, r0 = p0 = b; returns (x, r2, k)."""
    def cond(state):
        x, r, p, r2, k = state
        return torch.logical_and(r2 > stop, k < max_iters)

    def body(state):
        x, r, p, r2, k = state
        ap = unwrap(_spmv(a, p, backend))                  # Ap = A @ p
        alpha = r2 / torch.sum(p * ap)
        r_new = r - alpha * ap
        r2_new = torch.sum(r_new * r_new)
        beta = r2_new / r2
        return (x + alpha * p, r_new, r_new + beta * p, r2_new, k + 1)

    init = (torch.zeros_like(bv), bv, bv, torch.sum(bv * bv),
            torch.zeros((), dtype=torch.int32, device=bv.device))
    x, r, p, r2, k = arbb_while(cond, body, init)
    return x, r2, k


def cg_solve(a: Matrix, b, *, stop: float = 1e-10, max_iters: int = 1000,
             backend: Optional[str] = None) -> CGResult:
    """Conjugate gradients, the paper's §3.4 listing on the DSL.

    ``backend`` names a ``solver_spmv`` variant ('spmv1', 'spmv2', 'ell',
    'dia', or the mesh-scoped 'mesh_*' forms); None lets the registry pick
    by matrix layout *and* scope: under an O3/O4 mesh the whole solve runs
    row-sharded, and ``x`` comes back a row-sharded DTensor."""
    bv = unwrap(wrap(b))
    core = _cg_mesh if _selected_spmv(a, bv, backend).scope == "mesh" \
        else _cg_core
    x, r2, k = core(a, bv, stop, max_iters, backend)
    return CGResult(x=wrap(x), iterations=k, residual_sq=r2)


def _cg_jit_core(a: Matrix, bv, stop, max_iters: int,
                 backend: Optional[str]):
    """The ``call()``-wrapped CG core returning (x, r2, k), scope-aware
    like :func:`cg_solve`."""
    bv = unwrap(bv)
    if _selected_spmv(a, bv, backend).scope == "mesh":
        return _cg_mesh(a, bv, stop, max_iters, backend)
    return _cg_core(a, bv, stop, max_iters, backend)


cg_jit = call(_cg_jit_core)


@dataclasses.dataclass
class BlockCGResult:
    """Device-resident block-CG result: ``x`` is the (n, k) solution panel,
    ``residual_sq`` the per-RHS final squared residuals (k,)."""
    x: Dense
    iterations: torch.Tensor    # int32 scalar, on device
    residual_sq: torch.Tensor   # (k,) f32, on device


def cg_block_solve(a, b, *, stop: float = 1e-10, max_iters: int = 1000,
                   variant: Optional[str] = None,
                   rank_tol: float = 1e-7) -> BlockCGResult:
    """Multi-RHS conjugate gradients (block CG, O'Leary 1980) on the SpMM
    plane: the §3.4 listing widened to a (n, k) right-hand-side panel.

    One iteration does one SpMM (``S = A @ P``, a registry dispatch;
    ``variant=`` pins its formulation) and replaces CG's scalar α/β with
    k×k Gram solves, so the k systems share one Krylov space:

        γ = (PᵀS)⁻¹ (RᵀR)          X += P γ        R' = R − S γ
        δ = (RᵀR)⁻¹ (R'ᵀR')        P  = R' + P δ

    Stops when every RHS column's squared residual is below ``stop``.

    Both Gram solves are rank-revealing, so a residual block that loses
    rank (a converged column, duplicate right-hand sides) deflates instead
    of poisoning every column: columns with residual² ≤ ``stop``/100 (a
    hysteresis margin) are masked out (identity-padded, so their γ/δ
    columns vanish and their x/r freeze), and the masked Gram matrix is
    eigen-decomposed (``torch.linalg.eigh`` on the k×k matrix) with
    eigenvalues below ``rank_tol``·λmax inverted to zero."""
    bm = unwrap(wrap(b))
    if bm.ndim != 2:
        raise ValueError(f"cg_block_solve wants a (n, k) RHS panel, got "
                         f"shape {tuple(bm.shape)}; use cg_solve for one "
                         f"vector")
    if bm.shape[0] != a.shape[1]:
        raise ValueError(f"cg_block_solve: A is {tuple(a.shape)} but b has "
                         f"{bm.shape[0]} rows")

    def aspmm(p):
        # under a mesh, mesh_spmm's product is row-sharded: made whole here
        return gather(unwrap(registry.dispatch("spmm", a, wrap(p),
                                               variant=variant)))

    def rr_solve(g, rhs, active):
        """Rank-revealing solve of ``g @ out = rhs`` on the active
        columns (see the docstring above)."""
        am = active.to(g.dtype)
        mask = am[:, None] * am[None, :]
        gm = g * mask + torch.diag(1.0 - am)
        gm = 0.5 * (gm + gm.T)              # PᵀAP / RᵀR: symmetric up to fp
        w, vec = torch.linalg.eigh(gm)
        wmax = torch.max(torch.abs(w))
        inv = torch.where(torch.abs(w) > rank_tol * wmax, 1.0 / w,
                          torch.zeros_like(w))
        return vec @ (inv[:, None] * (vec.T @ (rhs * mask)))

    def cond(state):
        x, r, p, rtr, k = state
        return torch.logical_and(torch.max(torch.diagonal(rtr)) > stop,
                                 k < max_iters)

    def body(state):
        x, r, p, rtr, k = state
        # hysteresis: deflate only columns well below the stop threshold
        active = torch.diagonal(rtr) > 0.01 * stop     # live RHS columns
        s = aspmm(p)                                   # S = A @ P   (n, k)
        gamma = rr_solve(p.T @ s, rtr, active)         # k×k
        x_new = x + p @ gamma
        r_new = r - s @ gamma
        rtr_new = r_new.T @ r_new
        delta = rr_solve(rtr, rtr_new, active)
        p_new = r_new + p @ delta
        return (x_new, r_new, p_new, rtr_new, k + 1)

    init = (torch.zeros_like(bm), bm, bm, bm.T @ bm,
            torch.zeros((), dtype=torch.int32, device=bm.device))
    x, r, p, rtr, k = arbb_while(cond, body, init)
    return BlockCGResult(x=wrap(x), iterations=k,
                         residual_sq=torch.diagonal(rtr))


def _operand(a_dense, like: torch.Tensor) -> torch.Tensor:
    """A dense matrix on ``like``'s device and dtype (a host array is copied
    there; the solvers take the right-hand side's placement)."""
    a = unwrap(a_dense)
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a)
    return a.to(device=like.device, dtype=like.dtype)


def jacobi_solve(a_dense, b, *, iters: int = 200) -> Dense:
    """Jacobi iteration x <- D^-1 (b - (A - D) x)."""
    bv = unwrap(wrap(b))
    a = _operand(a_dense, bv)
    d = torch.diagonal(a)
    off = a - torch.diag(d)
    x = torch.zeros_like(bv)
    for _ in range(iters):
        x = (bv - off @ x) / d
    return wrap(x)


def gauss_seidel_solve(a_dense, b, *, iters: int = 100) -> Dense:
    """Gauss-Seidel forward sweeps (serial per row).  The iterate is
    updated in place: it is local to the solve, and a functional copy per
    row would cost O(n) per update."""
    bv = unwrap(wrap(b))
    a = _operand(a_dense, bv)
    n = a.shape[0]
    d = torch.diagonal(a)
    x = torch.zeros_like(bv)
    for _ in range(iters):
        for i in range(n):
            s = bv[i] - a[i] @ x + a[i, i] * x[i]
            x[i] = s / d[i]
    return wrap(x)
