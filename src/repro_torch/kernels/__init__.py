"""repro_torch.kernels — hand-written CUDA kernels for the paper's hot spots.

    csrc/*.cu     CUDA C++ for sm_90a, built by _lib.py with nvcc at first use
    _lib.py       build + ctypes binding
    matmul.py     tiled f32-accumulating matmul    (mod2am)
    spmv.py       ELL + DIA SpMV                   (mod2as, banded)
    fft.py        split-stream stages, up to ten per launch (mod2f)
    spmm.py       ELL + BSR SpMM                   (blocked-sparse spmm)
    spgemm.py     BSR x BSR numeric phase          (blocked-sparse spgemm)
    flash_attention.py  dense-grid, key-length and tile-skipping flash
                  attention                        (the serve tier)
    ops.py        the entry points of the paper kernels and of attention,
                  registered with repro_torch.core.registry (the sparse
                  ones register from repro_torch.sparse)
    ref.py        plain PyTorch oracles

Importing this package builds nothing; the first launch does.
"""
