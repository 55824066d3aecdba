#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

1. Print the card's name and power limit, and build the CUDA kernels from
   src/repro_torch/kernels/csrc with nvcc (timed).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones.
3. Run the two paths of the port, each with data made from fixed seeds and
   validated as benchmarks/*.py does, and each with the launch counts set
   to 0 just before it and read just after; every kernel of a path must
   have launched during that path.
   a. The paper's four Euroben suites at their largest configurations:
     mod2am  n = 1024 via ops.matmul and arbb_mxm1/2a/2b (arbb_mxm0 at 256)
     mod2as  n = 10240, 5.72 % fill via ops.spmv_ell, arbb_spmv1/2
     mod2f   n = 2^20 via ops.fft and split_stream_fft
     CG      Table-2 conf 18 (n = 1024, half-bandwidth 511) with the spmv2
             and dia formulations, plus ops.spmv_dia on the same matrix
   b. The blocked-sparse plane at the suites' full sizes:
     SpMM    benchmarks/spmm.py: n = 1024, the four format classes through
             sparse.matrix (the selector must pick dia/bsr/ell/csr) and
             sparse.spmm at k = 8 and 64, max error < 1e-3
     block-CG the suite's CG_BLOCK systems (auto format: DIA), plus
             (512, 127, 8) pinned to BSR and to ELL, relative residual
             < 1e-5
     SpGEMM  benchmarks/spgemm.py: n = 2048, block 8, clustered 0.02 /
             0.08 / 0.2 and banded bw 31 / 127, relative error < 1e-3
4. Time each kernel, its plain version and the library call (CUDA events
   around each call, with the L2 scrubbed between calls so that inputs come
   from HBM), read the kernel's own device time from a torch.profiler
   trace (``kernel_ms``), and print one JSON line of kernel records.
5. Print the contract line {"ok": true, "device": {...}} last.

Any failure raises and exits nonzero before the last line.  Without a CUDA
device, or without the repository around it, it exits 1 and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# float32 FMA rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
L2_SCRUB_BYTES = 256 << 20


def log(*parts) -> None:
    print(*parts, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scrub_buffer(torch):
    """A buffer five times the H100's 50 MB L2.  Reading it all before a
    timed call leaves no line of the call's inputs in L2, so every call
    reads them from HBM and the HBM bound holds.  A read leaves clean
    lines, so the timed call pays for no write-back of the scrub."""
    return torch.ones(L2_SCRUB_BYTES // 4, device="cuda")


def time_ms(torch, fn, iters: int, scrub) -> float:
    """Mean device time of one call with a cold L2: CUDA events around each
    call alone, after a warm-up, with ``scrub`` read between calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        scrub.sum()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def kernel_ms(torch, fn, iters: int, kernel: str, scrub):
    """Device time per call of ``fn`` spent in CUDA kernels whose name holds
    ``kernel``, from a torch.profiler trace, with a cold L2 as in
    :func:`time_ms`; None if the trace shows no device time for it.  Unlike
    :func:`time_ms`, this leaves out the gaps in which the device waits for
    the host to launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            scrub.sum()
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if kernel in e.key)
    return total_us / iters / 1e3 if total_us > 0 else None


def max_err(torch, got, want, rtol: float, atol: float, what: str) -> float:
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    return float((got.to(want.dtype) - want).abs().max())


# The blocked-sparse suites' inputs, with their seeds (benchmarks/spmm.py,
# benchmarks/spgemm.py; copied, since this script imports nothing of the
# JAX package).
SPMM_N = 1024
SPMM_RHS = (8, 64)
CG_BLOCK = ((256, 31, 4), (512, 63, 4), (512, 127, 8))
SPGEMM_N = 2048
SPGEMM_BLOCK = 8


def spmm_classes(sparse, n: int):
    """(label, dense f32 matrix, format the selector must pick) per class."""
    banded = sparse.banded_spd(n, 31, seed=1).astype(np.float32)
    rng = np.random.default_rng(2)
    nb, block = n // 8, 8
    blocked = np.zeros((n, n), np.float32)
    for p in rng.choice(nb * nb, size=max(1, int(nb * nb * 0.06)),
                        replace=False):
        i, j = divmod(int(p), nb)
        blocked[i * block:(i + 1) * block, j * block:(j + 1) * block] = \
            rng.standard_normal((block, block))
    rng = np.random.default_rng(3)
    uniform = np.zeros((n, n), np.float32)
    for i in range(n):
        uniform[i, rng.choice(n, size=16, replace=False)] = \
            rng.standard_normal(16)
    ragged = sparse.random_sparse(n, 2.0, seed=4).astype(np.float32)
    rng = np.random.default_rng(5)
    for i in rng.choice(n, size=4, replace=False):
        ragged[i, :] = rng.standard_normal(n)
    return (("banded", banded, "dia"), ("blocked", blocked, "bsr"),
            ("uniform", uniform, "ell"), ("ragged", ragged, "csr"))


def clustered(n: int, frac: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nb = n // SPGEMM_BLOCK
    occ = rng.random((nb, nb)) < frac
    d = rng.standard_normal((n, n)).astype(np.float32)
    return np.where(np.kron(occ, np.ones((SPGEMM_BLOCK, SPGEMM_BLOCK), bool)),
                    d, 0.0).astype(np.float32)


def spgemm_cases(sparse, n: int):
    for frac in (0.02, 0.08, 0.2):
        yield (f"clustered_f{frac}", clustered(n, frac, 1),
               clustered(n, frac, 2))
    for bw in (31, 127):
        yield (f"banded_bw{bw}",
               sparse.banded_spd(n, bw, seed=3).astype(np.float32),
               sparse.banded_spd(n, bw, seed=4).astype(np.float32))


def random_bsr(S, torch, rng, nbrows: int, nbcols: int, bs: int,
               fill: float, empty_rows=()):
    """A random BSR on the card with the block-rows in ``empty_rows``
    empty."""
    occ = rng.random((nbrows, nbcols)) < fill
    occ[list(empty_rows)] = False
    cols, rowp = S.block_pattern(occ)
    vals = rng.standard_normal((cols.size, bs, bs)).astype(np.float32)
    dev = torch.device("cuda")
    return S.BSR(torch.as_tensor(vals, device=dev),
                 torch.as_tensor(cols, device=dev),
                 torch.as_tensor(rowp, device=dev),
                 (nbrows * bs, nbcols * bs), bs)


def spgemm_args(S, torch, a, b):
    """The numeric-phase kernel's arguments for ``a @ b`` (the plan on the
    card) and the plan."""
    plan = S.spgemm_symbolic(a, b)
    dev = a.device
    return ((a.values, a.cols, a.rowp, b.values, b.cols, b.rowp,
             torch.as_tensor(plan.c_cols, device=dev),
             torch.as_tensor(plan.c_rowp, device=dev)), plan)


def sparse_inputs():
    """The blocked-sparse path's operands on the card: the SpMM suite's
    four classes through sparse.matrix, the block-CG systems (auto format,
    then the last one pinned to BSR and to ELL) and the SpGEMM cases."""
    from repro_torch import sparse as S
    from repro_torch.numerics import sparse

    classes = spmm_classes(sparse, SPMM_N)
    cg_systems = []
    for cn, cbw, k in CG_BLOCK:
        a = sparse.banded_spd(cn, cbw, seed=cn + cbw).astype(np.float32)
        b = np.random.default_rng(cn).standard_normal((cn, k)).astype(
            np.float32)
        cg_systems.append((f"n{cn}bw{cbw}k{k}", a, b, "auto"))
    label, a, b, _ = cg_systems[-1]
    cg_systems += [(label, a, b, "bsr"), (label, a, b, "ell")]
    return {
        "classes": classes,
        "mats": {label: S.matrix(a) for label, a, _ in classes},
        "cg_systems": cg_systems,
        "cg_mats": {(label, fmt): S.matrix(a, format=fmt)
                    for label, a, _, fmt in cg_systems},
        "gemm_cases": [(case, A, B, S.bsr_from_dense(A, block=SPGEMM_BLOCK),
                        S.bsr_from_dense(B, block=SPGEMM_BLOCK))
                       for case, A, B in spgemm_cases(sparse, SPGEMM_N)],
    }


def hold_sparse_kernels(torch, inp, mod2as_ell, kernels) -> None:
    """Phase 1 for the blocked-sparse kernels.  f32 sums run in another
    order than in the plain versions (an FMA chain per output against
    einsum/bmm + index_add_).  max_abs_err is taken at the path's shapes;
    the ragged cases follow."""
    from repro_torch import sparse as S
    from repro_torch.kernels import spgemm as spgemm_k
    from repro_torch.kernels import spmm as spmm_k
    from repro_torch.numerics import sparse

    dev = torch.device("cuda")
    last = inp["cg_systems"][-1][0]
    ell_uni, ell_cg = inp["mats"]["uniform"], inp["cg_mats"][(last, "ell")]
    errs = []
    for what, m, k in (("uniform", ell_uni, 8), ("uniform", ell_uni, 64),
                       ("block-CG", ell_cg, 8), ("mod2as", mod2as_ell, 64)):
        x = torch.randn(m.shape[1], k, device=dev)
        errs.append(max_err(
            torch, spmm_k.spmm_ell(m.values, m.cols, x),
            spmm_k.spmm_ell_plain(m.values, m.cols, x), 1e-4, 1e-4,
            f"spmm_ell {what} k={k}"))
    kernels["spmm_ell"]["max_abs_err"] = max(errs)
    odd = sparse.ell_from_csr(sparse.csr_from_dense(
        sparse.random_sparse(37, 20.0, seed=37)))
    for m in (ell_uni, odd):
        for k in (1, 3, 65):
            x = torch.randn(m.shape[1], k, device=dev)
            max_err(torch, spmm_k.spmm_ell(m.values, m.cols, x),
                    spmm_k.spmm_ell_plain(m.values, m.cols, x), 1e-4, 1e-4,
                    f"spmm_ell n={m.shape[0]} k={k}")

    errs = []
    for what, m, k in (("blocked", inp["mats"]["blocked"], 8),
                       ("blocked", inp["mats"]["blocked"], 64),
                       ("clustered 0.2", inp["gemm_cases"][2][3], 64),
                       ("block-CG", inp["cg_mats"][(last, "bsr")], 8)):
        x = torch.randn(m.shape[1], k, device=dev)
        errs.append(max_err(
            torch, spmm_k.spmm_bsr(m.values, m.cols, m.rowp, x),
            spmm_k.spmm_bsr_plain(m.values, m.cols, m.rowp, x), 1e-4, 1e-4,
            f"spmm_bsr {what} bs={m.block} k={k}"))
    kernels["spmm_bsr"]["max_abs_err"] = max(errs)
    rng = np.random.default_rng(12)
    for bs in (8, 16, 32):
        m = random_bsr(S, torch, rng, 40, 30, bs, 0.2, empty_rows=(0, 17, 39))
        for k in (1, 3, 65):
            x = torch.randn(m.shape[1], k, device=dev)
            got = spmm_k.spmm_bsr(m.values, m.cols, m.rowp, x)
            max_err(torch, got,
                    spmm_k.spmm_bsr_plain(m.values, m.cols, m.rowp, x),
                    1e-4, 1e-4, f"spmm_bsr bs={bs} k={k}")
            if got[17 * bs:18 * bs].any():
                raise AssertionError(f"spmm_bsr bs={bs}: empty block-row "
                                     f"not zero")
    empty = random_bsr(S, torch, rng, 4, 4, 8, 0.0)
    before = spmm_k.spmm_bsr.launches
    y = spmm_k.spmm_bsr(empty.values, empty.cols, empty.rowp,
                        torch.ones(32, 3, device=dev))
    if y.shape != (32, 3) or y.any() or spmm_k.spmm_bsr.launches != before:
        raise AssertionError("spmm_bsr with no blocks: not zeros, or it "
                             "launched")

    errs = []
    for case, _, _, a, b in inp["gemm_cases"]:
        args, _ = spgemm_args(S, torch, a, b)
        want = spgemm_k.spgemm_bsr_plain(*args, ncols=b.shape[1])
        # banded products reach O(1e4): the bar scales with the product
        scale = max(1.0, float(want.abs().max()))
        errs.append(max_err(
            torch, spgemm_k.spgemm_bsr(*args, ncols=b.shape[1]), want, 1e-5,
            1e-5 * scale, f"spgemm_bsr {case}"))
    kernels["spgemm_bsr"]["max_abs_err"] = max(errs)
    for bs in (16, 32):
        a = random_bsr(S, torch, rng, 24, 24, bs, 0.3, empty_rows=(3, 11))
        b = random_bsr(S, torch, rng, 24, 24, bs, 0.3, empty_rows=(5,))
        args, _ = spgemm_args(S, torch, a, b)
        max_err(torch, spgemm_k.spgemm_bsr(*args, ncols=b.shape[1]),
                spgemm_k.spgemm_bsr_plain(*args, ncols=b.shape[1]), 1e-5,
                1e-4, f"spgemm_bsr bs={bs}")
    # no pairs: A's only live block-column meets an empty block-row of B
    a = np.zeros((32, 32), np.float32)
    a[:8, :8] = 1.0
    b = np.zeros((32, 32), np.float32)
    b[8:16, :8] = 1.0
    args, plan = spgemm_args(S, torch, S.bsr_from_dense(a),
                             S.bsr_from_dense(b))
    before = spgemm_k.spgemm_bsr.launches
    c = spgemm_k.spgemm_bsr(*args, ncols=32)
    if plan.npairs or c.shape != (0, 8, 8) \
            or spgemm_k.spgemm_bsr.launches != before:
        raise AssertionError("spgemm_bsr with no pairs: wrong result")
    # a pattern that lacks a tile some product reaches: the kernel raises
    a = random_bsr(S, torch, rng, 6, 6, 8, 0.5)
    args, plan = spgemm_args(S, torch, a, a)
    row = int(np.flatnonzero(np.diff(plan.c_rowp))[0])  # first live row
    cut = int(plan.c_rowp[row + 1]) - 1                  # its last tile
    c_rowp = torch.as_tensor(plan.c_rowp, device=dev)
    c_rowp[row + 1:] -= 1
    args = args[:6] + (torch.cat((args[6][:cut], args[6][cut + 1:])), c_rowp)
    try:
        spgemm_k.spgemm_bsr(*args, ncols=48)
    except ValueError:
        pass
    else:
        raise AssertionError("spgemm_bsr took a pattern missing a tile")
    torch.cuda.synchronize()


def run_sparse_path(torch, inp) -> None:
    """Phase 2b: the blocked-sparse path through the entry points a user
    calls, validated as benchmarks/spmm.py and benchmarks/spgemm.py do."""
    import repro_torch.core as C
    from repro_torch import sparse as S
    from repro_torch.core import registry
    from repro_torch.numerics import solvers

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []
    for label, a, expect in inp["classes"]:
        m = inp["mats"][label]
        fmt = S.format_of(m)
        if fmt != expect:
            raise AssertionError(f"selector: {label} gave {fmt}, not "
                                 f"{expect}")
        for k in SPMM_RHS:
            x = rng.standard_normal((SPMM_N, k)).astype(np.float32)
            y = S.spmm(m, C.bind(x)).read()
            err = float(np.abs(y - a.astype(np.float64) @ x).max())
            if not err < 1e-3:
                raise AssertionError(f"spmm {label} k={k}: max error {err}")
        rows.append(f"{label}->{fmt}")
    log(f"spmm n={SPMM_N} k={SPMM_RHS}: {', '.join(rows)} ok")

    rows = []
    for label, a, b, fmt in inp["cg_systems"]:
        t = time.perf_counter()
        m = inp["cg_mats"][(label, fmt)]
        res = solvers.cg_block_solve(m, C.bind(b), stop=1e-12,
                                     max_iters=2 * a.shape[0])
        x = res.x.read()
        rel = float((np.linalg.norm(a.astype(np.float64) @ x - b, axis=0)
                     / np.linalg.norm(b, axis=0)).max())
        if not rel < 1e-5:
            raise AssertionError(f"block-CG {label} {fmt}: relative "
                                 f"residual {rel}")
        blk = f" bs={m.block}" if S.format_of(m) == "bsr" else ""
        rows.append(f"{label} {S.format_of(m)}{blk}: "
                    f"{int(res.iterations)} iters, rel {rel:.1e}, "
                    f"{time.perf_counter() - t:.2f} s")
    log("block-CG: " + "; ".join(rows))

    rows = []
    for case, A, B, a, b in inp["gemm_cases"]:
        name = registry.select("spgemm", a, b).name
        if name != "bsr":
            raise AssertionError(f"spgemm {case}: selected {name!r}")
        c = S.spgemm(a, b)
        ref = (torch.as_tensor(A, dtype=torch.float64, device=dev)
               @ torch.as_tensor(B, dtype=torch.float64, device=dev))
        got = torch.as_tensor(c.todense(), dtype=torch.float64, device=dev)
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max()) / scale
        if not err < 1e-3:
            raise AssertionError(f"spgemm {case}: relative error {err}")
        rows.append(f"{case}: {c.nblocks} blocks, rel err {err:.1e}")
    log(f"spgemm n={SPGEMM_N} block {SPGEMM_BLOCK}: " + "; ".join(rows))
    torch.cuda.synchronize()


def time_sparse_kernels(torch, inp, mod2as_csr, mod2as_ell, kernels, cold_ms,
                        csr_tensor) -> dict:
    """Phase 3 for the blocked-sparse kernels; returns the call that
    launches each kernel, for the profiler pass."""
    from repro_torch import sparse as S
    from repro_torch.kernels import spgemm as spgemm_k
    from repro_torch.kernels import spmm as spmm_k

    dev = torch.device("cuda")
    k = 64
    # spmm_ell: the mod2as Table-1 matrix times a k = 64 panel.  Bound: the
    # matrix's nonzeros (value + column; ELL's padding is storage, not work)
    # read once, X read once, Y written once, 2 flops per nonzero and column.
    vals, cols = mod2as_ell.values, mod2as_ell.cols
    n = mod2as_ell.shape[0]
    x_as = torch.randn(n, k, device=dev)
    lib_as = csr_tensor(mod2as_csr)
    nnz = mod2as_csr.nnz
    rec = kernels["spmm_ell"]
    rec["ms"] = cold_ms(lambda: spmm_k.spmm_ell(vals, cols, x_as), 50)
    rec["plain_ms"] = cold_ms(
        lambda: spmm_k.spmm_ell_plain(vals, cols, x_as), 5)
    rec["library_ms"] = cold_ms(lambda: lib_as @ x_as, 50)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        nnz * 8 + 2 * n * k * 4, 2.0 * nnz * k)

    # spmm_bsr: the SpGEMM suite's clustered 0.2 operand times k = 64.  Its
    # live blocks are dense (normal draws), so the stored entries are the
    # matrix's nonzeros.
    m = inp["gemm_cases"][2][3]
    bv, bc, br = m.values, m.cols, m.rowp
    x_bsr = torch.randn(m.shape[1], k, device=dev)
    rec = kernels["spmm_bsr"]
    rec["ms"] = cold_ms(lambda: spmm_k.spmm_bsr(bv, bc, br, x_bsr), 50)
    rec["plain_ms"] = cold_ms(
        lambda: spmm_k.spmm_bsr_plain(bv, bc, br, x_bsr), 20)
    lib_bsr = torch.sparse_bsr_tensor(br.long(), bc.long(), bv,
                                      size=m.shape, check_invariants=False)
    try:
        lib_bsr @ x_bsr
        torch.cuda.synchronize()
        note = "torch.sparse BSR @ dense"
    except (RuntimeError, NotImplementedError) as exc:
        lib_bsr = csr_tensor(S.csr_from_bsr(m))
        note = f"torch.sparse CSR @ dense (BSR @ dense refused: {exc})"
    rec["library_ms"] = cold_ms(lambda: lib_bsr @ x_bsr, 50)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        m.nnz * 4 + m.nblocks * 4 + br.numel() * 4 + 2 * m.shape[0] * k * 4,
        2.0 * m.nnz * k)
    log(f"spmm_bsr timed: n={m.shape[0]} bs={m.block} {m.nblocks} blocks "
        f"k={k}; library call: {note}")

    # spgemm_bsr: the clustered 0.2 A @ B, numeric phase only (the plan is
    # made once on the host).  The library call, torch.sparse CSR @ CSR,
    # also runs its own symbolic phase.
    _, _, _, a, b = inp["gemm_cases"][2]
    args, plan = spgemm_args(S, torch, a, b)
    ncols = b.shape[1]
    rec = kernels["spgemm_bsr"]
    rec["ms"] = cold_ms(lambda: spgemm_k.spgemm_bsr(*args, ncols=ncols), 20)
    rec["plain_ms"] = cold_ms(
        lambda: spgemm_k.spgemm_bsr_plain(*args, ncols=ncols), 5)
    lib_a = csr_tensor(S.csr_from_bsr(a))
    lib_b = csr_tensor(S.csr_from_bsr(b))
    rec["library_ms"] = cold_ms(lambda: lib_a @ lib_b, 10)
    bs = a.block
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (a.nblocks + b.nblocks + plan.nc) * bs * bs * 4,
        2.0 * plan.npairs * bs ** 3)
    log(f"spgemm_bsr timed: {plan.npairs} pairs, {plan.nc} output blocks, "
        f"{2.0 * plan.npairs * bs ** 3 / 1e6:.1f} MFLOP")
    return {"spmm_ell": lambda: spmm_k.spmm_ell(vals, cols, x_as),
            "spmm_bsr": lambda: spmm_k.spmm_bsr(bv, bc, br, x_bsr),
            "spgemm_bsr": lambda: spgemm_k.spgemm_bsr(*args, ncols=ncols)}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: src/repro_torch not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # f32 products run in full precision: the yardstick must not use TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch.core as C
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels import fft as fft_k
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import spgemm as spgemm_k
    from repro_torch.kernels import spmm as spmm_k
    from repro_torch.kernels import spmv as spmv_k
    from repro_torch.numerics import fft as nfft
    from repro_torch.numerics import matmul as mm
    from repro_torch.numerics import solvers, sparse, spmv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    t0 = time.perf_counter()
    _lib.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    dev = torch.device("cuda")
    kernels = {k: {"name": k} for k in
               ("matmul", "spmv_ell", "spmv_dia", "fft_stage", "spmm_ell",
                "spmm_bsr", "spgemm_bsr")}

    # -- inputs of the main path (fixed seeds, as benchmarks/*.py) ----------
    n_mm = 1024
    rng = np.random.default_rng(n_mm)
    a_np = rng.standard_normal((n_mm, n_mm)).astype(np.float32)
    b_np = rng.standard_normal((n_mm, n_mm)).astype(np.float32)
    A, B = C.bind(a_np), C.bind(b_np)

    n_as, fill = sparse.MOD2AS_TABLE1[-1]
    s_np = sparse.random_sparse(n_as, fill, seed=n_as)
    csr = sparse.csr_from_dense(s_np)
    ell = sparse.ell_from_csr(csr)
    xs_np = np.random.default_rng(n_as).standard_normal(n_as).astype(
        np.float32)
    XS = C.bind(xs_np)

    n_f = 1 << 20
    rng = np.random.default_rng(n_f)
    z_np = (rng.standard_normal(n_f) + 1j * rng.standard_normal(n_f)).astype(
        np.complex64)
    Z = C.bind(z_np)

    conf, (n_cg, bw) = 18, sparse.CG_TABLE2[17]
    spd_np = sparse.banded_spd(n_cg, bw, seed=conf)
    cg_csr = sparse.csr_from_dense(spd_np)
    cg_dia = sparse.dia_from_dense(spd_np)
    bcg_np = np.random.default_rng(conf).standard_normal(n_cg).astype(
        np.float32)
    BCG = C.bind(bcg_np)

    sparse_in = sparse_inputs()

    # -- phase 1: every kernel against its plain version --------------------
    kernels["matmul"]["max_abs_err"] = max_err(
        torch, mm_k.matmul(A.data, B.data), mm_k.matmul_plain(A.data, B.data),
        2e-5, 1e-3, "matmul f32 1024")
    for m, k, n in ((130, 257, 129), (1, 7, 3), (96, 80, 112)):
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            a = torch.randn(m, k, device=dev).to(dt)
            b = torch.randn(k, n, device=dev).to(dt)
            max_err(torch, mm_k.matmul(a, b).float(),
                    mm_k.matmul_plain(a, b).float(), tol, tol * 10,
                    f"matmul {dt} {(m, k, n)}")
    ab = A.data.bfloat16(), B.data.bfloat16()
    max_err(torch, mm_k.matmul(*ab).float(), mm_k.matmul_plain(*ab).float(),
            2e-2, 0.5, "matmul bf16 1024")

    kernels["spmv_ell"]["max_abs_err"] = max_err(
        torch, spmv_k.spmv_ell(ell.values, ell.cols, XS.data),
        spmv_k.spmv_ell_plain(ell.values, ell.cols, XS.data), 1e-4, 1e-4,
        "spmv_ell 10240")
    small = sparse.ell_from_csr(sparse.csr_from_dense(
        sparse.random_sparse(100, 3.5, seed=100)))
    xsm = torch.randn(100, device=dev)
    max_err(torch, spmv_k.spmv_ell(small.values, small.cols, xsm),
            spmv_k.spmv_ell_plain(small.values, small.cols, xsm), 1e-4, 1e-4,
            "spmv_ell 100")

    xcg = torch.randn(n_cg, device=dev)
    kernels["spmv_dia"]["max_abs_err"] = max_err(
        torch, spmv_k.spmv_dia(cg_dia.diags, cg_dia.offsets, xcg),
        spmv_k.spmv_dia_plain(cg_dia.diags, cg_dia.offsets, xcg), 1e-4, 1e-4,
        "spmv_dia conf 18")
    d33 = sparse.dia_from_dense(sparse.banded_spd(33, 32, seed=33))
    x33 = torch.randn(33, device=dev)
    max_err(torch, spmv_k.spmv_dia(d33.diags, d33.offsets, x33),
            spmv_k.spmv_dia_plain(d33.diags, d33.offsets, x33), 1e-4, 1e-4,
            "spmv_dia 33")

    perm, tw_re, tw_im = ops.fft_plan(n_f, torch.float32, dev)
    tangled = Z.data[perm]
    re0 = tangled.real.contiguous()
    im0 = tangled.imag.contiguous()
    errs = []
    for m in (n_f // 2, 1024, 1):
        got = fft_k.fft_stage(re0.view(-1, 2), im0.view(-1, 2), tw_re, tw_im,
                              m)
        want = fft_k.fft_stage_plain(re0.view(-1, 2), im0.view(-1, 2),
                                     tw_re, tw_im, m)
        errs += [max_err(torch, g, w, 1e-5, 1e-5, f"fft_stage m={m}")
                 for g, w in zip(got, want)]
    kernels["fft_stage"]["max_abs_err"] = max(errs)
    for zz in (Z.data, torch.randn(16, dtype=torch.complex128, device=dev)):
        got = ops.fft(zz)
        with ops.backend("torch"):
            plain = ops.fft(zz)
        # FMA in the kernel vs two roundings in the plain stage: a few ulps
        # of |x| (which grows like sqrt(n)) per stage, over log2 n stages.
        nz = zz.shape[0]
        atol = 4 * torch.finfo(got.real.dtype).eps * nz ** 0.5 * (
            nz.bit_length() - 1)
        max_err(torch, got, plain, 1e-5, atol, f"fft {nz}")

    hold_sparse_kernels(torch, sparse_in, ell, kernels)
    torch.cuda.synchronize()
    log("phase 1: 7 kernels agree with their plain versions")

    # -- phase 2a: the paper's path, counted --------------------------------
    wrappers = {"matmul": mm_k.matmul, "spmv_ell": spmv_k.spmv_ell,
                "spmv_dia": spmv_k.spmv_dia, "fft_stage": fft_k.fft_stage}
    for w in wrappers.values():
        w.launches = 0
    t_path = time.perf_counter()

    want = a_np.astype(np.float64) @ b_np.astype(np.float64)
    np.testing.assert_allclose(C.wrap(ops.matmul(A.data, B.data)).read(),
                               want, rtol=2e-3, atol=2e-3)
    for f in (mm.arbb_mxm1, mm.arbb_mxm2a, mm.arbb_mxm2b):
        np.testing.assert_allclose(f(A, B).read(), want, rtol=2e-3,
                                   atol=2e-3, err_msg=f.__name__)
    a256, b256 = C.bind(a_np[:256, :256]), C.bind(b_np[:256, :256])
    np.testing.assert_allclose(
        mm.arbb_mxm0(a256, b256).read(),
        a_np[:256, :256].astype(np.float64) @ b_np[:256, :256], rtol=2e-3,
        atol=2e-3)
    log(f"mod2am n={n_mm}: ops.matmul, arbb_mxm1/2a/2b ok; arbb_mxm0 n=256 ok")

    want = s_np @ xs_np.astype(np.float64)
    np.testing.assert_allclose(
        C.wrap(ops.spmv_ell(ell.values, ell.cols, XS.data)).read(), want,
        rtol=1e-3, atol=1e-3)
    for f in (spmv.arbb_spmv1, spmv.arbb_spmv2):
        np.testing.assert_allclose(f(csr, XS).read(), want, rtol=1e-3,
                                   atol=1e-3, err_msg=f.__name__)
    log(f"mod2as n={n_as} fill={fill}% nnz={csr.nnz} width={ell.width}: "
        f"ops.spmv_ell, arbb_spmv1, arbb_spmv2 ok")

    want = np.fft.fft(z_np)
    for name, out in (("ops.fft", C.wrap(ops.fft(Z.data)).read()),
                      ("split_stream_fft", nfft.split_stream_fft(Z).read())):
        np.testing.assert_allclose(out, want, rtol=1e-2, atol=1e-3 * n_f,
                                   err_msg=name)
    log(f"mod2f n={n_f}: ops.fft, split_stream_fft ok")

    cg_rows = []
    for backend, mat in (("spmv2", cg_csr), ("dia", cg_dia)):
        t = time.perf_counter()
        res = solvers.cg_solve(mat, BCG, stop=1e-10, max_iters=2 * n_cg,
                               backend=backend)
        x = res.x.read()
        rel = float(np.linalg.norm(spd_np @ x - bcg_np)
                    / np.linalg.norm(bcg_np))
        if not rel < 1e-3:
            raise AssertionError(f"CG {backend}: relative residual {rel}")
        cg_rows.append(f"{backend}: {int(res.iterations)} iters, rel "
                       f"residual {rel:.2e}, {time.perf_counter() - t:.2f} s")
    np.testing.assert_allclose(
        C.wrap(ops.spmv_dia(cg_dia.diags, cg_dia.offsets, BCG.data)).read(),
        spd_np @ bcg_np.astype(np.float64), rtol=1e-3, atol=1e-3)
    log(f"cg conf {conf} n={n_cg} bw={bw}: " + "; ".join(cg_rows)
        + "; ops.spmv_dia ok")
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"phase 2a: paper path in {time.perf_counter() - t_path:.2f} s, "
        f"kernel launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the paper path: "
                             f"{missing}")

    # -- phase 2b: the blocked-sparse path, counted -------------------------
    sparse_wrappers = {"spmm_ell": spmm_k.spmm_ell,
                       "spmm_bsr": spmm_k.spmm_bsr,
                       "spgemm_bsr": spgemm_k.spgemm_bsr}
    for w in sparse_wrappers.values():
        w.launches = 0
    t_path = time.perf_counter()
    run_sparse_path(torch, sparse_in)
    sparse_launches = {k: w.launches for k, w in sparse_wrappers.items()}
    log(f"phase 2b: blocked-sparse path in "
        f"{time.perf_counter() - t_path:.2f} s, kernel launches "
        f"{sparse_launches}")
    missing = [k for k, v in sparse_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the blocked-sparse "
                             f"path: {missing}")
    launches.update(sparse_launches)

    # -- phase 3: times, cold L2 --------------------------------------------
    scrub = scrub_buffer(torch)

    def cold_ms(fn, iters: int) -> float:
        return time_ms(torch, fn, iters, scrub)

    a, b = A.data, B.data
    rec = kernels["matmul"]
    rec["ms"] = cold_ms(lambda: mm_k.matmul(a, b), 50)
    rec["plain_ms"] = cold_ms(lambda: mm_k.matmul_plain(a, b), 50)
    rec["library_ms"] = cold_ms(lambda: torch.matmul(a, b), 50)
    rec["bound_ms"], rec["bound_by"] = bound_ms(3 * n_mm * n_mm * 4,
                                                2.0 * n_mm ** 3)

    def csr_tensor(m: sparse.CSR):
        return torch.sparse_csr_tensor(m.rowp.long(), m.indx.long(),
                                       m.matvals, size=m.shape,
                                       check_invariants=False)

    vals, cols, x = ell.values, ell.cols, XS.data
    lib_as = csr_tensor(csr)
    rec = kernels["spmv_ell"]
    rec["ms"] = cold_ms(lambda: spmv_k.spmv_ell(vals, cols, x), 200)
    rec["plain_ms"] = cold_ms(
        lambda: spmv_k.spmv_ell_plain(vals, cols, x), 200)
    rec["library_ms"] = cold_ms(lambda: lib_as @ x, 200)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        csr.nnz * 8 + 2 * n_as * 4, 2.0 * csr.nnz)

    diags, offs = cg_dia.diags, cg_dia.offsets
    band = sum(n_cg - abs(o) for o in offs)
    lib_cg = csr_tensor(cg_csr)
    rec = kernels["spmv_dia"]
    rec["ms"] = cold_ms(lambda: spmv_k.spmv_dia(diags, offs, xcg), 200)
    rec["plain_ms"] = cold_ms(
        lambda: spmv_k.spmv_dia_plain(diags, offs, xcg), 5)
    rec["library_ms"] = cold_ms(lambda: lib_cg @ xcg, 200)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        band * 4 + len(offs) * 4 + 2 * n_cg * 4, 2.0 * band)

    # one transform's log2 n stage launches on tangled data
    rec = kernels["fft_stage"]
    rec["ms"] = cold_ms(lambda: ops.stage_loop(
        re0, im0, tw_re, tw_im, fft_k.fft_stage), 20)
    rec["plain_ms"] = cold_ms(lambda: ops.stage_loop(
        re0, im0, tw_re, tw_im, fft_k.fft_stage_plain), 20)
    zd = Z.data
    rec["library_ms"] = cold_ms(lambda: torch.fft.fft(zd), 20)
    # The transform's inputs (tangled re/im, both twiddle tables) read once
    # and its output written once.  Each stage's output is the next stage's
    # input and need not leave the chip (it stays in L2 here), so charging
    # every stage's 16 B per point at the HBM rate would overstate the bound.
    stages = n_f.bit_length() - 1
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        8 * n_f + (tw_re.numel() + tw_im.numel()) * 4 + 8 * n_f,
        stages * 5.0 * n_f)

    timed_sparse = time_sparse_kernels(torch, sparse_in, csr, ell, kernels,
                                       cold_ms, csr_tensor)

    routes = {
        "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:35"),
        "spmv_ell": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:42"),
        "spmv_dia": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:88"),
        "fft_stage": ("src/repro_torch/kernels/csrc/fft.cu",
                      "src/repro/kernels/fft.py:36"),
        "spmm_ell": ("src/repro_torch/kernels/csrc/spmm.cu",
                     "src/repro/kernels/spmm.py:41"),
        "spmm_bsr": ("src/repro_torch/kernels/csrc/spmm.cu",
                     "src/repro/kernels/spmm.py:91"),
        "spgemm_bsr": ("src/repro_torch/kernels/csrc/spgemm.cu",
                       "src/repro/kernels/spgemm.py:45"),
    }
    timed = {"matmul": lambda: mm_k.matmul(a, b),
             "spmv_ell": lambda: spmv_k.spmv_ell(vals, cols, x),
             "spmv_dia": lambda: spmv_k.spmv_dia(diags, offs, xcg),
             "fft_stage": lambda: ops.stage_loop(re0, im0, tw_re, tw_im,
                                                 fft_k.fft_stage),
             **timed_sparse}
    for name, fn in timed.items():
        kernels[name]["kernel_ms"] = kernel_ms(torch, fn, 20,
                                               f"{name}_kernel", scrub)
    out = []
    for name, r in kernels.items():
        src, replaces = routes[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "kernel_ms": r["kernel_ms"]})
    log(json.dumps({"kernels": out}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
