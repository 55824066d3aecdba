"""Host cost of the port's dispatch and serve loop on the card, for
comparing two trees of the port in turns.

    python3 tools/host_cost.py [--src DIR] [--rounds N] [--serves N]
                               [--cpu K] [--json FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so one copy of this script measures another
tree of the port, for example its parent commit unpacked with
``git archive``.  It uses only entry points both trees have, and prints
one JSON line:

* ``dispatch_us``: host microseconds per call (median of rounds of calls,
  no sync in the loop, the garbage collector paused) of
  ``registry.dispatch("matmul", a, a)`` at 64 x 64 f32 and of
  ``ops.flash_attention`` at a 128-token bf16 prefill (1 x 16/8 heads,
  d 128, causal), each beside calling the same kernel directly;
* ``tok_s``: untraced ``ContinuousEngine.serve`` of ``chip_smoke.py``'s 8
  requests on qwen3-1.7b at full width (random weights from seed 0,
  greedy), ``--serves`` times (default :data:`SERVES`; 0 skips them)
  after one warm-up serve, each on a fresh engine.

``--rounds`` sets the samples per call kind (default :data:`ROUNDS`);
``--cpu K`` pins this process to host core K, so that turns of two trees
run on the same core.

It needs one card; no cost-model or block-cache file is read (the
``REPRO_TORCH_*`` variables point into an empty temporary directory).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: Calls per host-cost sample, and samples per call kind.
CALLS, ROUNDS = 2000, 7
#: Timed serves after the warm-up one.
SERVES = 3


def host_us(torch, fn) -> float:
    """Host microseconds per call of ``fn``: enqueue time, no sync in the
    loop, the garbage collector paused."""
    fn()
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        t = time.perf_counter()
        for _ in range(CALLS):
            fn()
        dt = time.perf_counter() - t
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return dt / CALLS * 1e6


def dispatch_us(torch, n_rounds: int = ROUNDS) -> dict:
    from repro_torch.core import registry
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ops

    a = torch.randn(64, 64, device="cuda")
    mm = registry.REGISTRY.get("matmul", "cuda").impl
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).bfloat16()
               for shape in ((1, 16, 128, 128), (1, 8, 128, 128),
                             (1, 8, 128, 128)))
    kinds = {
        "matmul_impl": lambda: mm(a, a),
        "matmul_dispatch": lambda: registry.dispatch("matmul", a, a),
        "attention_kernel": lambda: fa_k.flash_attention(
            q, k, v, causal=True, block_q=128, block_k=128),
        "attention_dispatch": lambda: ops.flash_attention(q, k, v,
                                                          causal=True),
    }
    rounds: dict = {name: [] for name in kinds}
    for _ in range(n_rounds):
        for name, fn in kinds.items():
            rounds[name].append(host_us(torch, fn))
    return {name: sorted(x)[len(x) // 2] for name, x in rounds.items()} \
        | {"rounds": rounds}


def serve_tok_s(torch, serves: int = SERVES) -> list[float]:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (ARCH, SERVE_CHUNK, SERVE_MAX_LEN, SERVE_SLOTS,
                            serve_requests)
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serve import ContinuousEngine, SamplingParams

    cfg = get_config(ARCH)
    lm = LM(cfg)
    params = lm.init(0, device="cuda")
    reqs = serve_requests(cfg.vocab_size)
    out = []
    for i in range(serves + 1):
        ce = ContinuousEngine(lm, params, num_slots=SERVE_SLOTS,
                              max_len=SERVE_MAX_LEN, chunk_size=SERVE_CHUNK,
                              sampling=SamplingParams(greedy=True))
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = ce.serve(reqs)
        torch.cuda.synchronize()
        if i:                                   # the first is a warm-up
            out.append(sum(len(x) for x in got) / (time.perf_counter() - t))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is measured")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--serves", type=int, default=SERVES)
    ap.add_argument("--cpu", type=int, default=None,
                    help="pin this process to this host core")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if args.cpu is not None:
        os.sched_setaffinity(0, {args.cpu})

    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("host_cost: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="host_cost_") as tmp:
        # set before the package is imported: a tree that reads them once,
        # at import, sees the same empty files as one that reads them on
        # every call
        for var, name in (("REPRO_TORCH_COSTMODEL", "cm.json"),
                          ("REPRO_TORCH_AUTOTUNE_CACHE", "at.json")):
            os.environ[var] = os.path.join(tmp, name)
        os.environ.pop("REPRO_TORCH_AUTOTUNE", None)
        import repro_torch

        res = {"src": args.src,
               "package": str(Path(repro_torch.__file__).parent),
               "device": torch.cuda.get_device_name(0)}
        res["dispatch_us"] = dispatch_us(torch, args.rounds)
        res["tok_s"] = serve_tok_s(torch, args.serves) if args.serves else []
    line = json.dumps(res)
    print(line)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
