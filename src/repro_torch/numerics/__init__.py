"""repro_torch.numerics — the paper's four kernel ports (DSL level) and
sparse formats (counterpart of ``repro.numerics``).

    matmul   mod2am: arbb_mxm0/1/2a/2b + torch.matmul comparator
    spmv     mod2as: arbb_spmv1/2 + ELL/DIA
    fft      mod2f:  split-stream radix-2 (+ Stockham comparator)
    solvers  CG (paper §3.4), Jacobi, Gauss-Seidel
    sparse   CSR / ELL / DIA formats + paper input generators
"""
from repro_torch.numerics import fft, matmul, solvers, sparse, spmv  # noqa: F401
