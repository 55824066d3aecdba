"""Serving from the command line: init a model with seeded random weights
(or load them from a checkpoint) and run batched generation through the
fixed engine (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --scale 1.0 --batch 4 --prompt-len 512 --new-tokens 32

It runs on the card unless ``--device cpu`` is given.  ``--scale`` below 1
shrinks the architecture with :func:`reduce_config`; a config whose
parameters do not fit the card (arctic-480b: 476.8 B) raises unless it is
shrunk.  ``--arch qwen3-moe-30b-a3b --scale 1.0`` serves the whole MoE
model (61 GB in bf16) on one 80 GB card; ``--arch mamba2-370m`` (SSM) and
``--arch zamba2-7b`` (hybrid) serve those families (a prompt longer than
256 tokens must be a multiple of 256, the SSD chunk).  ``--arch
qwen2-vl-72b`` (VLM, M-RoPE) and ``--arch musicgen-medium`` (audio) take
seeded standard-normal frontend embeddings for their ``frontend_len``
positions ahead of the prompt; qwen2-vl-72b (145.4 GB in bf16) raises at
scale 1 and says how many of its layers would fit.  ``--ckpt-dir`` loads
the parameters of the newest checkpoint there (written by either package's
``Checkpointer``; the scale must match the one it was trained at).  The
execution levels of the JAX version are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.containers import resolve_device
from repro_torch.launch.train import reduce_config
from repro_torch.models.lm import LM
from repro_torch.obs.trace import clock
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
    if dev.type == "cuda":
        size = torch.empty((), dtype=cfg.pdtype).element_size()
        need = cfg.param_count() * size
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > have:
            fit = max((n for n in range(1, cfg.num_layers) if
                       dataclasses.replace(cfg, num_layers=n).param_count()
                       * size <= have), default=0)
            ap.error(f"{cfg.name}: {need / 1e9:.1f} GB of parameters do not "
                     f"fit the card's {have / 1e9:.1f} GB (at full width "
                     f"{fit} of its {cfg.num_layers} layers would, beside "
                     f"nothing else); pass --scale below 1")
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
    # the cache holds the frontend's positions ahead of the prompt's
    front = cfg.frontend_len if cfg.frontend is not None else 0
    max_len = args.max_len or (front + args.prompt_len + args.new_tokens + 8)
    engine = Engine(lm, params, max_len=max_len, sampling=sp)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    fe = None
    if front:
        fe = torch.randn((args.batch, front, cfg.d_model), generator=gen,
                         device=dev)
    t0 = clock()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens,
                          seed=args.seed, frontend_embeds=fe)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = clock() - t0
    toks = args.batch * args.new_tokens
    print(f"{cfg.name} on {dev}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, first call)")
    print("first row:", out[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
