"""Train and serve the dense configs whole on the card, through the
launchers a user calls, and record their peak memory.

    python3 tools/dense_whole.py [--arch A ...] [--shape BxS ...]
                                 [--no-serve] [--json FILE]

For each config (default: gemma-2b, minicpm-2b, phi3-mini-3.8b):

* ``launch.train.main`` at scale 1, 2 steps at each ``--shape`` (batch x
  sequence; default 1x512).  Where it refuses (the step's peak,
  ``train_peak_bytes``, exceeds the card less the slack), the refusal and
  the memory allocated when it came (0: it came before anything was
  allocated) are recorded, and the depth it names is trained with
  ``--layers``.  The peak allocated memory is printed beside
  ``train_peak_bytes`` and ``update_peak_bytes`` at the depth that ran (a
  run that fails, out of memory say, is recorded with its peak, and the
  next one runs).
* ``launch.serve.main`` at scale 1 (unless ``--no-serve``):
  ``Engine.generate`` on 2 prompts of 256 tokens, 16 new (seeded random
  weights, greedy), with its tok/s and peak memory.

It needs one card, and prints one JSON line last.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("gemma-2b", "minicpm-2b", "phi3-mini-3.8b")
TRAIN = ["--scale", "1.0", "--steps", "2"]
SERVE = ["--scale", "1.0", "--batch", "2", "--prompt-len", "256",
         "--new-tokens", "16"]


def run(torch, fn, argv) -> dict:
    """``fn(argv)`` with its stdout and stderr captured, a refusal
    (SystemExit) recorded, and the peak memory it allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, err = io.StringIO(), io.StringIO()
    refused = None
    failed = None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            fn(argv)
        except SystemExit as e:
            refused = str(e.code)
        except Exception as e:                  # recorded, then the next run
            failed = f"{type(e).__name__}: {str(e)[:300]}"
    torch.cuda.synchronize()
    res = {"argv": argv, "stdout": out.getvalue().strip().splitlines()[-3:],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "allocated_before_gb": before / 1e9}
    if refused is not None:
        res["refused"] = err.getvalue().strip().splitlines()[-1]
        res["allocated_at_refusal_gb"] = torch.cuda.memory_allocated() / 1e9
    if failed is not None:
        res["failed"] = failed
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None,
                    help="a training shape, batch x sequence (default 1x512)")
    ap.add_argument("--no-serve", action="store_true")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("dense_whole: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    have = torch.cuda.get_device_properties(0).total_memory
    out = {"card": smi, "total_memory_gb": have / 1e9, "archs": {}}
    for arch in args.arch or ARCHS:
        cfg = get_config(arch)
        rec = {"params": cfg.param_count(),
               "update_peak_gb": train_launch.update_peak_bytes(cfg) / 1e9,
               "train": {}}
        for shape in args.shape or ["1x512"]:
            batch, seq = (int(x) for x in shape.split("x"))
            argv = ["--arch", arch, *TRAIN, "--batch", str(batch),
                    "--seq", str(seq)]
            whole = run(torch, train_launch.main, argv)
            res = {"whole": whole}
            layers = cfg.num_layers
            if "refused" in whole:
                layers = int(whole["refused"].split("at full width ")[1]
                             .split(" of")[0])
                res["cut"] = run(torch, train_launch.main,
                                 [*argv, "--layers", str(layers)])
            at = dataclasses.replace(cfg, num_layers=layers)
            res["layers"] = layers
            res["update_peak_gb"] = train_launch.update_peak_bytes(at) / 1e9
            res["train_peak_gb"] = train_launch.train_peak_bytes(
                at, batch * seq) / 1e9
            rec["train"][shape] = res
        if not args.no_serve:
            rec["serve"] = run(torch, serve_launch.main,
                               ["--arch", arch, *SERVE])
        out["archs"][arch] = rec
        print(json.dumps({arch: rec}), flush=True)
    line = json.dumps(out)
    print(line)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
