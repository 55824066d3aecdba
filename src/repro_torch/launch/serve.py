"""Serving from the command line: init a model with seeded random weights
(or load them from a checkpoint) and run batched generation through the
fixed engine (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --scale 1.0 --batch 4 --prompt-len 512 --new-tokens 32

It runs on the card unless ``--device cpu`` is given.  ``--scale`` below 1
shrinks the architecture with :func:`reduce_config`.  ``--ckpt-dir`` loads
the parameters of the newest checkpoint there (written by either package's
``Checkpointer``; the scale must match the one it was trained at).  The
execution levels of the JAX version are not ported.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.containers import resolve_device
from repro_torch.launch.train import reduce_config
from repro_torch.models.lm import LM
from repro_torch.serve import Engine, SamplingParams

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.scale != 1.0:
        cfg = reduce_config(cfg, args.scale)
    dev = resolve_device(args.device)
    lm = LM(cfg)
    if args.ckpt_dir:
        from repro_torch.optim import adamw
        from repro_torch.optim.schedules import constant
        from repro_torch.train.state import create
        ckpt = Checkpointer(args.ckpt_dir)
        state = create(lm, adamw(constant(1e-4)), args.seed, device=dev)
        params = ckpt.restore(state).params
        print(f"loaded checkpoint step {ckpt.latest_step()}")
    else:
        params = lm.init(args.seed, device=dev)
    sp = SamplingParams(greedy=args.temperature == 0.0,
                        temperature=max(args.temperature, 1e-6))
    max_len = args.max_len or (args.prompt_len + args.new_tokens + 8)
    engine = Engine(lm, params, max_len=max_len, sampling=sp)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens,
                          seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"{cfg.name} on {dev}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, first call)")
    print("first row:", out[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
