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
``Checkpointer``; the scale must match the one it was trained at).

``--opt-level O3|O4`` (or ``ARBB_OPT_LEVEL``) builds the engine under the
level's mesh, which the engine pins: a prompt that the ring divides is
prefilled with ring attention (DESIGN.md §10).  The mesh spans the ranks
of a ``torch.distributed`` world:

    python -m repro_torch.launch.serve --arch qwen3-1.7b --scale 1.0 \
        --opt-level O3 --ranks 4 --prompt-len 8192

``--ranks N`` starts N ranks on this host (``launch/world.py``; on one
card they share it, gloo staging every collective through host memory).
Without it, a process group that is already initialised is used, else one
is initialised from ``torchrun``'s environment (``WORLD_SIZE`` and
``MASTER_ADDR`` set), else the level runs on the one-process mesh, where
every mesh variant degrades to its chip formulation (the output says so).
Rank 0 prints the tokens, tok/s, and the attention variants that prefill
and decode select (``registry.explain``), so that a degraded selection is
never silent.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys

import torch
import torch.distributed

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core import execlevel, registry
from repro_torch.core.containers import resolve_device
from repro_torch.core.execlevel import ExecLevel
from repro_torch.launch.train import reduce_config
from repro_torch.models.lm import LM
from repro_torch.obs.trace import clock
from repro_torch.serve import Engine, SamplingParams

__all__ = ["main"]


#: Seconds a world started by ``--ranks`` may take, model set-up included.
WORLD_TIMEOUT_S = 3600


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--opt-level", default=None, choices=["O2", "O3", "O4"],
                    help="execution level the engine pins: O3/O4 prefill "
                         "over the sequence-parallel ring (default: "
                         "ARBB_OPT_LEVEL, else O2)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="start a world of this many ranks on this host")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.ranks is not None:
        from repro_torch.launch.world import run_world

        if args.ranks < 1:
            ap.error("--ranks takes a positive count")
        argv = list(sys.argv[1:] if argv is None else argv)
        lines = run_world(_rank_main, args.ranks, args=(argv,),
                          timeout=WORLD_TIMEOUT_S)[0]
    else:
        dist = torch.distributed
        if not dist.is_initialized() and int(os.environ.get(
                "WORLD_SIZE", "1")) > 1 and "MASTER_ADDR" in os.environ:
            dist.init_process_group(
                "gloo", init_method="env://",
                timeout=datetime.timedelta(seconds=60))
        lines = _serve(ap, args)
        if dist.is_initialized() and dist.get_rank() != 0:
            return 0
    print("\n".join(lines))
    return 0


def _rank_main(rank: int, world: int, argv: list) -> list:
    """One rank of a world started by ``--ranks``: the same serve, every
    rank; the lines come back to the parent, which prints rank 0's."""
    ap = _parser()
    return _serve(ap, ap.parse_args(argv))


def _fits(ap, cfg, dev) -> None:
    """``ap.error`` when the parameters alone do not fit the card."""
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


def _selected(op: str, *args, **kwargs) -> str:
    """The variant ``op`` selects on these arguments under the ambient
    level, and, where a mesh variant lost, why."""
    rows = registry.explain(op, *args, **kwargs)
    won = next(r for r in rows if r["selected"])
    text = f"{op} -> {won['variant']} ({won['scope']} scope)"
    if won["ambient_scope"] == "mesh" and won["scope"] != "mesh":
        lost = [f"{r['variant']}: {r['reason']}" for r in rows
                if r["scope"] == "mesh"]
        text += ("; degraded, " + "; ".join(lost)) if lost \
            else "; the op has no mesh variant"
    return text


def _serve(ap, args) -> list:
    """Build the model and the engine under the level, serve the prompts,
    and return the lines to print."""
    cfg = get_config(args.arch)
    if args.scale != 1.0:
        cfg = reduce_config(cfg, args.scale)
    dev = resolve_device(args.device)
    lines = []
    if dev.type == "cuda":
        _fits(ap, cfg, dev)
        if torch.distributed.is_initialized():  # ranks may share one card
            torch.cuda.set_device(dev.index or 0)
    lm = LM(cfg)
    if args.ckpt_dir:
        from repro_torch.optim import adamw
        from repro_torch.optim.schedules import constant
        from repro_torch.train.state import create
        ckpt = Checkpointer(args.ckpt_dir)
        state = create(lm, adamw(constant(1e-4)), args.seed, device=dev)
        params = ckpt.restore(state).params
        lines.append(f"loaded checkpoint step {ckpt.latest_step()}")
    else:
        params = lm.init(args.seed, device=dev)
    sp = SamplingParams(greedy=args.temperature == 0.0,
                        temperature=max(args.temperature, 1e-6))
    # the cache holds the frontend's positions ahead of the prompt's
    front = cfg.frontend_len if cfg.frontend is not None else 0
    max_len = args.max_len or (front + args.prompt_len + args.new_tokens + 8)
    level = ExecLevel[args.opt_level] if args.opt_level \
        else execlevel.current().level
    with execlevel.use_level(level) as ctx:
        engine = Engine(lm, params, max_len=max_len, sampling=sp)
    mesh = ctx.mesh
    if mesh is None:
        lines.append("engine level O2 (one card)")
    elif isinstance(mesh, execlevel.LocalMesh):
        lines.append(f"engine level {level.name} without a process group: "
                     f"the one-process mesh {tuple(mesh.shape)}, where every "
                     f"mesh variant degrades to its chip formulation")
    else:
        from repro_torch.launch.mesh import describe
        lines.append(f"engine level {level.name} on {describe(mesh)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    fe = None
    if front:
        fe = torch.randn((args.batch, front, cfg.d_model), generator=gen,
                         device=dev)
    lines += _selections(engine, cfg, prompts, front, dev)
    t0 = clock()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens,
                          seed=args.seed, frontend_embeds=fe)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = clock() - t0
    toks = args.batch * args.new_tokens
    lines.append(f"{cfg.name} on {dev}: generated {tuple(out.shape)} in "
                 f"{dt:.2f}s ({toks / dt:.1f} tok/s, first call)")
    lines.append(f"first row: {out[0].tolist()}")
    return lines


def _selections(engine, cfg, prompts, front: int, dev) -> list:
    """What the engine's attention dispatches select, under its level."""
    if not cfg.has_attention:
        return ["attention: none (an attention-free config)"]
    B, S = prompts.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.act_dtype
    lvl = engine.active_level
    with execlevel.use_level(lvl.level, lvl.mesh):
        q = torch.empty((B, h, front + S, hd), dtype=dt, device=dev)
        k = torch.empty((B, hk, front + S, hd), dtype=dt, device=dev)
        prefill = "prefill: " + _selected(
            "flash_attention", q, k, k, causal=True,
            mask=cfg.attn_mask_spec())
    return [prefill, "decode: the fixed-cache einsum (no registry op), "
                     "outside the level"]


if __name__ == "__main__":
    sys.exit(main())
