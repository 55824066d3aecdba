#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

1. Print the card's name and power limit, and build the CUDA kernels from
   src/repro_torch/kernels/csrc with nvcc (timed).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones.
3. Run the main path, the paper's four Euroben suites at their largest
   configurations, with data made from fixed seeds, and validate each as
   benchmarks/*.py does:
     mod2am  n = 1024 via ops.matmul and arbb_mxm1/2a/2b (arbb_mxm0 at 256)
     mod2as  n = 10240, 5.72 % fill via ops.spmv_ell, arbb_spmv1/2
     mod2f   n = 2^20 via ops.fft and split_stream_fft
     CG      Table-2 conf 18 (n = 1024, half-bandwidth 511) with the spmv2
             and dia formulations, plus ops.spmv_dia on the same matrix
   Every kernel must have launched during this phase.
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


def main() -> int:
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
               ("matmul", "spmv_ell", "spmv_dia", "fft_stage")}

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
    torch.cuda.synchronize()
    log("phase 1: 4 kernels agree with their plain versions")

    # -- phase 2: the main path, counted ------------------------------------
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
    log(f"phase 2: main path in {time.perf_counter() - t_path:.2f} s, "
        f"kernel launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

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

    routes = {
        "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:35"),
        "spmv_ell": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:42"),
        "spmv_dia": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:88"),
        "fft_stage": ("src/repro_torch/kernels/csrc/fft.cu",
                      "src/repro/kernels/fft.py:36"),
    }
    timed = {"matmul": lambda: mm_k.matmul(a, b),
             "spmv_ell": lambda: spmv_k.spmv_ell(vals, cols, x),
             "spmv_dia": lambda: spmv_k.spmv_dia(diags, offs, xcg),
             "fft_stage": lambda: ops.stage_loop(re0, im0, tw_re, tw_im,
                                                 fft_k.fft_stage)}
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
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
