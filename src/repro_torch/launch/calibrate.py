"""Chip-scope calibration: the measured cost model and the attention block
cache, filled on the card (the port's counterpart of the JAX package's
``benchmarks/backend_sweep.py`` and ``benchmarks/autotune_sweep.py``).

    PYTHONPATH=src python -m repro_torch.launch.calibrate --out DIR
    PYTHONPATH=src python -m repro_torch.launch.calibrate --out DIR \\
        --tiny --device cpu                     # smoke sizes on the host
    ... --backend-sweep                         # the variant table only

:func:`autotune_sweep` times every variant admissible for each case's
operands through ``registry.dispatch`` — whole dispatched calls, host
overhead included, what a caller pays — and records the median seconds,
their spread, GFLOP/s and the H100 roofline prediction
(:data:`repro_torch.utils.roofline.H100`) in the cost model
(``DIR/costmodel.json``), which re-ranks dispatch from then on.  It also premeasures the attention blocks of each attention case
(``DIR/autotune.json``) and times every candidate block the kernels take.
:func:`backend_sweep` times the same admissible variants without writing
anything and reports the inadmissible ones with ``explain``'s reason, so
a sweep on the host documents which column the card fills in.

The ops and their cases (:func:`default_cases`, at the sources' sizes):
``matmul`` n 1024; ``spmv_ell`` at mod2as Table 1's largest (n 10240,
5.72 %); ``spmv_dia`` and ``solver_spmv`` on CG's Table-2 conf 18 (n 1024,
half-bandwidth 511), the latter in each container the selector builds;
``fft`` at 2^20; ``spmm`` at n 1024 with 8 and 64 right-hand sides in each
container; ``spgemm`` on clustered BSR at n 2048, bs 8; ``flash_attention``
at the training shape (B 4, 16/8 heads, L 512, d 128, bf16) causal, with a
causal window of L/4 and a 16-block pattern beside it.

``--out`` (default: a fresh temporary directory) holds every file the run
writes: the command writes nothing into the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
from typing import Any, Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import blocking, costmodel, registry, settings
from repro_torch.core.containers import resolve_device
from repro_torch.obs.trace import clock

__all__ = ["Case", "default_cases", "backend_sweep", "autotune_sweep",
           "timings", "median", "spread", "time_call", "gc_paused", "main"]


class Case(NamedTuple):
    """One calibrated call: ``op(*args, **kwargs)`` and the floating-point
    operations its useful work needs."""
    label: str
    args: tuple
    kwargs: dict
    flops: float


def _sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def timings(fn: Callable[[], Any], on_card: bool,
            budget_s: float = 0.05) -> list[float]:
    """Seconds of single calls of ``fn()``, sorted, each call followed by
    a synchronise (on the card): what a caller that waits for the result
    pays, host overhead included, as the drift detector observes it (and
    as the JAX package's sweep times it).  One warm-up, then as many calls
    as fill ``budget_s`` (5 to 21), in ``torch.no_grad()`` with the garbage
    collector paused (as ``timeit`` pauses it)."""
    times = []
    with torch.no_grad(), gc_paused():
        fn()
        _sync(on_card)
        while len(times) < 5 or (len(times) < 21
                                 and sum(times) < budget_s):
            t0 = clock()
            fn()
            _sync(on_card)
            times.append(clock() - t0)
    return sorted(times)


def median(times: list[float]) -> float:
    """The median of sorted ``times``."""
    return times[len(times) // 2]


def spread(times: list[float]) -> float:
    """The interquartile range of sorted ``times``: how far a call's
    seconds move between calls."""
    return times[3 * len(times) // 4] - times[len(times) // 4]


def time_call(fn: Callable[[], Any], on_card: bool,
              budget_s: float = 0.05) -> float:
    """Median seconds of one call of ``fn()`` (:func:`timings`)."""
    return median(timings(fn, on_card, budget_s))


@contextlib.contextmanager
def gc_paused() -> Iterator[None]:
    """The garbage collector off inside the block (a collection of a large
    process's objects takes milliseconds, which a timed call must not pay
    by chance), back to its previous state after."""
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _attention_cases(dev, tiny: bool) -> list[Case]:
    from repro_torch.sparse.maskcompiler import MaskSpec, dense_mask

    b, hq, hkv, L, d = (1, 2, 2, 128, 32) if tiny else (4, 16, 8, 512, 128)
    dtype = torch.float32 if tiny else torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(512)
    q, k, v = (torch.randn(shape, generator=g).to(device=dev, dtype=dtype)
               for shape in ((b, hq, L, d), (b, hkv, L, d), (b, hkv, L, d)))
    nt = L // 16
    pat = (np.random.default_rng(7).random((nt, nt)) < 0.15) \
        | np.eye(nt, dtype=bool)
    out = []
    for tag, spec, kw in (
            ("causal", MaskSpec(causal=True), {"causal": True}),
            ("win", MaskSpec(causal=True, window=L // 4),
             {"causal": True, "mask": MaskSpec(causal=True, window=L // 4)}),
            ("blk", MaskSpec.from_block_mask(pat, 16),
             {"causal": True, "mask": MaskSpec.from_block_mask(pat, 16)})):
        pairs = float(dense_mask(spec, L, L).sum())
        out.append(Case(f"b{b}h{hq}/{hkv}l{L}d{d}_{tag}", (q, k, v), kw,
                        4.0 * b * hq * pairs * d))
    return out


def default_cases(*, tiny: bool = False, device: Any = None
                  ) -> dict[str, list[Case]]:
    """op -> its cases, on ``device`` (the card unless ``"cpu"``), from
    fixed seeds; ``tiny`` shrinks every size to a smoke test's."""
    from repro_torch.core import bind
    from repro_torch.numerics import sparse
    from repro_torch.sparse import matrix
    from repro_torch.sparse.spgemm import spgemm_symbolic

    dev = resolve_device(device)
    put = dict(device=dev)
    cases: dict[str, list[Case]] = {}

    n = 64 if tiny else 1024
    rng = np.random.default_rng(n)
    a = bind(rng.standard_normal((n, n)).astype(np.float32), **put).data
    bm = bind(rng.standard_normal((n, n)).astype(np.float32), **put).data
    cases["matmul"] = [Case(f"n{n}", (a, bm), {}, 2.0 * n ** 3)]

    n_as, fill = (512, 5.0) if tiny else sparse.MOD2AS_TABLE1[-1]
    s_np = sparse.random_sparse(n_as, fill, seed=n_as)
    ell = sparse.ell_from_csr(sparse.csr_from_dense(s_np, **put))
    xs = bind(np.random.default_rng(n_as).standard_normal(n_as)
              .astype(np.float32), **put).data
    nnz = float(np.count_nonzero(s_np))
    cases["spmv_ell"] = [Case(f"n{n_as}_fill{fill}", (ell.values, ell.cols,
                                                      xs), {}, 2.0 * nnz)]

    conf, (n_cg, bw) = (18, (256, 15)) if tiny else (18,
                                                     sparse.CG_TABLE2[17])
    spd = sparse.banded_spd(n_cg, bw, seed=conf).astype(np.float32)
    nnz_cg = float(np.count_nonzero(spd))
    dia = sparse.dia_from_dense(spd, **put)
    xcg = bind(np.random.default_rng(conf).standard_normal(n_cg)
               .astype(np.float32), **put)
    cases["spmv_dia"] = [Case(f"conf{conf}_n{n_cg}bw{bw}",
                              (dia.diags, tuple(dia.offsets), xcg.data), {},
                              2.0 * nnz_cg)]
    cases["solver_spmv"] = [
        Case(f"{fmt}_conf{conf}_n{n_cg}bw{bw}",
             (matrix(spd, format=fmt, **put), xcg), {}, 2.0 * nnz_cg)
        for fmt in ("csr", "ell", "dia", "bsr")]

    fn = 1 << (10 if tiny else 20)
    rng = np.random.default_rng(fn)
    z = bind((rng.standard_normal(fn) + 1j * rng.standard_normal(fn))
             .astype(np.complex64), **put).data
    cases["fft"] = [Case(f"n{fn}", (z,), {}, 5.0 * fn * (fn.bit_length()
                                                        - 1))]

    sn, sbw = (256, 15) if tiny else (1024, 31)
    band = sparse.banded_spd(sn, sbw, seed=11).astype(np.float32)
    nnz_b = float(np.count_nonzero(band))
    cases["spmm"] = []
    for kk in ((8,) if tiny else (8, 64)):
        xk = bind(np.random.default_rng(kk).standard_normal((sn, kk))
                  .astype(np.float32), **put)
        for fmt in ("dia", "bsr", "ell", "csr"):
            cases["spmm"].append(Case(
                f"{fmt}_n{sn}bw{sbw}k{kk}",
                (matrix(band, format=fmt, **put), xk), {},
                2.0 * nnz_b * kk))

    gn, bs = (256, 8) if tiny else (2048, 8)
    rng = np.random.default_rng(42)
    occ = rng.random((gn // bs, gn // bs)) < 0.08
    gd = rng.standard_normal((gn, gn)).astype(np.float32)
    tile = np.kron(occ, np.ones((bs, bs), bool))
    ga = matrix(np.where(tile, gd, 0.0).astype(np.float32), format="bsr",
                block=bs, **put)
    gb = matrix(np.where(tile.T, gd.T, 0.0).astype(np.float32),
                format="bsr", block=bs, **put)
    plan = spgemm_symbolic(ga, gb)
    cases["spgemm"] = [Case(f"bsr_n{gn}b{bs}_clustered0.08", (ga, gb), {},
                            2.0 * plan.npairs * bs ** 3)]

    cases["flash_attention"] = _attention_cases(dev, tiny)
    return cases


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

def _admissible(row: dict) -> bool:
    return row["reason"].startswith(("selected", "outranked"))


def _on_card(case: Case) -> bool:
    return registry.device_type_of(*case.args, *case.kwargs.values()) \
        == "cuda"


def backend_sweep(cases: Optional[dict] = None, *, tiny: bool = False,
                  device: Any = None) -> list[dict]:
    """Time every variant admissible for each case (pinned through
    ``registry.dispatch``) and list the others with ``explain``'s reason.
    Writes nothing."""
    cases = cases if cases is not None else default_cases(tiny=tiny,
                                                          device=device)
    rows = []
    for op, op_cases in cases.items():
        for case in op_cases:
            for r in registry.explain(op, *case.args, **case.kwargs):
                row = {"op": op, "case": case.label, "variant": r["variant"],
                       "plane": r["plane"] or "-", "seconds": None,
                       "gflops": None, "note": r["reason"]}
                if _admissible(r):
                    t = time_call(lambda: registry.dispatch(
                        op, *case.args, variant=r["variant"], **case.kwargs),
                        _on_card(case))
                    row.update(seconds=t, gflops=case.flops / t / 1e9,
                               note="")
                rows.append(row)
    return rows


def _block_rows(case: Case, on_card: bool) -> list[dict]:
    """Every candidate block the kernels take, timed through the variant
    dispatch selects, pinned to those blocks (rows for the table; the
    cache's winner comes from :func:`blocking.premeasure`)."""
    from repro_torch.kernels import ops

    q = case.args[0]
    v = registry.select("flash_attention", *case.args, **case.kwargs)
    if v.plane != "cuda":
        return []
    rows = []
    for bl in ops.fa_candidates(q.shape[3]):
        kw = {**case.kwargs, "block_q": bl["q"], "block_k": bl["k"]}
        t = time_call(lambda: registry.dispatch(
            "flash_attention", *case.args, variant=v.name, **kw), on_card)
        rows.append({"op": "flash_attention", "case": case.label,
                     "variant": v.name, "plane": v.plane,
                     "blocks": f"{bl['q']}x{bl['k']}", "seconds": t,
                     "gflops": case.flops / t / 1e9})
    return rows


def autotune_sweep(cases: Optional[dict] = None, *, tiny: bool = False,
                   device: Any = None) -> list[dict]:
    """Time every variant admissible for each case through
    ``registry.dispatch`` and record it in the cost model (seconds,
    GFLOP/s, H100-predicted seconds); premeasure and time the attention
    blocks.  Returns one row per (case, variant) and per attention
    candidate block (``blocks``), and one ``premeasured`` row per
    attention case."""
    cases = cases if cases is not None else default_cases(tiny=tiny,
                                                          device=device)
    model = costmodel.get_model()
    rows: list[dict] = []
    for op, op_cases in cases.items():
        for case in op_cases:
            on_card = _on_card(case)
            dtype = costmodel.dtype_of(case.args)
            for r in registry.explain(op, *case.args, **case.kwargs):
                if not _admissible(r):
                    continue
                name = r["variant"]

                def call():
                    return registry.dispatch(op, *case.args, variant=name,
                                             **case.kwargs)
                times = timings(call, on_card)
                t = median(times)
                # the operands read once, the result written once
                nbytes = costmodel.arg_bytes((case.args, call()))
                rec = model.record(op, name, seconds=t, spread=spread(times),
                                   args=case.args, kwargs=case.kwargs,
                                   flops=case.flops, bytes_moved=nbytes)
                rows.append({"op": op, "case": case.label, "variant": name,
                             "plane": r["plane"] or "-", "dtype": dtype,
                             "seconds": t, "spread": rec["spread"],
                             "gflops": rec.get("gflops"),
                             "predicted_seconds":
                             rec.get("predicted_seconds"),
                             "ratio": t / rec["predicted_seconds"]
                             if rec.get("predicted_seconds") else None})
            if op == "flash_attention":
                rows.extend(_block_rows(case, on_card))
                if registry.select(op, *case.args,
                                   **case.kwargs).plane == "cuda":
                    bl = blocking.premeasure(
                        op, *case.args, causal=case.kwargs.get("causal",
                                                               True),
                        mask=case.kwargs.get("mask"))
                    rows.append({"op": op, "case": case.label,
                                 "premeasured": f"{bl['q']}x{bl['k']}"})
    return rows


def _fmt(rows: list[dict]) -> str:
    lines = []
    for r in rows:
        if "premeasured" in r:
            lines.append(f"{r['op']:<16} {r['case']:<34} blocks "
                         f"premeasured: {r['premeasured']}")
            continue
        sec, pred, ratio = (r.get("seconds"), r.get("predicted_seconds"),
                            r.get("ratio"))
        sec_s = f"{sec * 1e3:.5f} ms" if sec is not None else "-"
        pred_s = f"{pred * 1e3:.5f} ms" if pred else ""
        ratio_s = f"x{ratio:.2f}" if ratio else ""
        lines.append(f"{r['op']:<16} {r['case']:<34} {r['variant']:<12} "
                     f"{r.get('blocks', ''):<8} {sec_s:>14} {pred_s:>14} "
                     f"{ratio_s:>8}  {r.get('note', '')}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for costmodel.json, autotune.json and "
                         "calibrate.json (default: a new temporary one)")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke sizes (seconds, not minutes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--backend-sweep", action="store_true",
                    help="only time the variant table; write no model")
    args = ap.parse_args(argv)

    out = args.out or tempfile.mkdtemp(prefix="repro_torch_calibrate_")
    os.makedirs(out, exist_ok=True)
    os.environ["REPRO_TORCH_COSTMODEL"] = os.path.join(out,
                                                       "costmodel.json")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(out,
                                                            "autotune.json")
    os.environ["REPRO_TORCH_AUTOTUNE"] = "1"
    settings.reload()
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    cases = default_cases(tiny=args.tiny, device=dev)
    if args.backend_sweep:
        rows = backend_sweep(cases)
    else:
        rows = autotune_sweep(cases)
    print(f"calibration on {name} ({'tiny' if args.tiny else 'full'} "
          f"sizes): whole dispatched-call seconds, H100-predicted seconds, "
          f"their ratio")
    print(_fmt(rows))
    with open(os.path.join(out, "calibrate.json"), "w") as f:
        json.dump({"device": name, "rows": rows}, f, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
