"""Linear solvers: conjugate gradients (paper §3.4), Jacobi and Gauss-Seidel
(counterpart of ``repro.numerics.solvers``), at chip scope.

The CG port is the paper's listing on the DSL: a ``_while`` whose condition
is ``r2 > stop && k < max_iters`` and whose body composes the SpMV with dot
products.  The SpMV formulation is a ``solver_spmv`` registry variant
('spmv1', 'spmv2', 'ell', 'dia'); ``backend=None`` picks the strongest one
the matrix layout admits.  As in the JAX package these are DSL programs and
reach no kernel.

The iteration count and final residual stay on the device in
:class:`CGResult`; the loop condition itself is read on the host once per
iteration (see ``repro_torch.core.control.arbb_while``).

Not ported yet: ``cg_block_solve`` (it needs the blocked-sparse slice's
``spmm``) and the mesh-scoped solve.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import Dense, arbb_while, call, unwrap, wrap
from repro_torch.core import registry
from repro_torch.numerics import spmv as spmv_mod  # noqa: F401  (registers solver_spmv)
from repro_torch.numerics.sparse import CSR, DIA, ELL

__all__ = ["cg_solve", "cg_jit", "jacobi_solve", "gauss_seidel_solve",
           "CGResult"]

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
    'dia'); None lets the registry pick by matrix layout."""
    bv = unwrap(wrap(b))
    x, r2, k = _cg_core(a, bv, stop, max_iters, backend)
    return CGResult(x=wrap(x), iterations=k, residual_sq=r2)


def _cg_jit_core(a: Matrix, bv, stop, max_iters: int,
                 backend: Optional[str]):
    """The ``call()``-wrapped CG core returning (x, r2, k)."""
    return _cg_core(a, unwrap(bv), stop, max_iters, backend)


cg_jit = call(_cg_jit_core)


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
