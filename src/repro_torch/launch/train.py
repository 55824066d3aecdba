"""Training launcher: config -> data -> train loop -> checkpoints
(counterpart of ``repro.launch.train``, chip scope).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --scale 1.0 --steps 8 --batch 4 --seq 512

It runs on the card unless ``--device cpu`` is given (then with a small
``--scale``, e.g. 0.05).  The mesh (``Trainer(mesh=...)``, ZeRO-1 moment
sharding) is mesh scope (ROADMAP queue 1 item 10): ``mesh`` raises and
the JAX Trainer's ``zero1`` is not taken; the clock is
``time.perf_counter`` until ``obs`` is ported (queue 1 item 8).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.containers import resolve_device
from repro_torch.data import ByteCorpus, SyntheticLM
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine, wsd
from repro_torch.runtime import HeartbeatStore, Monitor
from repro_torch.train import create, make_train_step

__all__ = ["reduce_config", "Trainer", "main"]

clock = time.perf_counter


def reduce_config(cfg: ModelConfig, scale: float, *,
                  seq_len: int = 256) -> ModelConfig:
    """Shrink an assigned architecture into a CPU-runnable sibling (same
    family, same block structure, fewer/narrower layers): the dense branch
    of the JAX package's ``reduce_config``.  ``seq_len`` sizes the JAX
    package's frontends, which the dense family has none of."""
    def s(x, lo=1, mult=1):
        v = max(lo, int(round(x * scale)))
        return -(-v // mult) * mult

    d_model = s(cfg.d_model, 32, 16)
    heads = max(2, int(round(cfg.num_heads * scale)))
    kvh = max(1, min(cfg.num_kv_heads, heads))
    while heads % kvh:
        kvh -= 1
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-x{scale}",
        num_layers=max(2, int(round(cfg.num_layers * scale))),
        d_model=d_model, vocab_size=min(cfg.vocab_size, 2048),
        num_heads=heads, num_kv_heads=kvh,
        head_dim=max(8, d_model // heads // 2 * 2),
        d_ff=s(cfg.d_ff, 64, 16) if cfg.d_ff else 0,
        dtype="float32", param_dtype="float32",
        remat=False, scan_layers=True)


class Trainer:
    """Owns state + step + checkpointing; the loop a launcher runs.  The
    schedule is WSD for minicpm configs and cosine otherwise, as in the
    JAX package.  The state lives on ``device`` (the card unless the
    caller names another)."""

    def __init__(self, cfg: ModelConfig, *, mesh=None, microbatches: int = 1,
                 ckpt_dir: Optional[str] = None, save_every: int = 50,
                 lr: float = 3e-4, total_steps: int = 1000, seed: int = 0,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) shards the state over a mesh: mesh scope, "
                "not ported yet (ROADMAP queue 1 item 10)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lm = LM(cfg)
        sched = wsd(lr, total_steps) if cfg.name.startswith("minicpm") \
            else cosine(lr, total_steps)
        self.opt = adamw(sched)
        self.step_fn = make_train_step(self.lm, self.opt,
                                       microbatches=microbatches)
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.save_every = save_every
        self.heartbeats = HeartbeatStore()
        self.monitor = Monitor(self.heartbeats)
        self.state = create(self.lm, self.opt, seed, device=self.device)
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.state = self.ckpt.restore(self.state)
            print(f"resumed from step {int(self.state.step)}")

    def fit(self, data, steps: int, *, log_every: int = 10,
            worker: int = 0) -> dict:
        """Steps from the state's step up to ``steps``.  The history holds,
        every ``log_every`` steps and at the first, the step, its loss and
        grad norm, and the seconds since ``fit`` began (host clock, read
        after the loss, which waits for the step to finish)."""
        history = []
        start = int(self.state.step)
        t0 = clock()
        for i in range(start, steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in data.batch(i).items()}
            self.state, metrics = self.step_fn(self.state, batch)
            self.heartbeats.post(worker, i)
            if (i + 1) % log_every == 0 or i == start:
                loss = float(metrics["loss"])
                dt = clock() - t0
                print(f"step {i+1:5d} loss {loss:.4f} "
                      f"({dt/(i-start+1):.2f}s/step)")
                history.append({"step": i + 1, "loss": loss,
                                "grad_norm": float(metrics["grad_norm"]),
                                "time_s": dt})
            if self.ckpt and (i + 1) % self.save_every == 0:
                self.ckpt.save_async(i + 1, self.state)
        if self.ckpt:
            self.ckpt.wait()
            self.ckpt.save(steps, self.state)
        return {"history": history,
                "final_loss": history[-1]["loss"] if history else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", type=float, default=0.1,
                    help="reduce factor (1.0 = full config)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--corpus", default=None,
                    help="path to a text/binary file (byte-level LM); "
                         "default: synthetic tokens")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.scale != 1.0:
        cfg = reduce_config(cfg, args.scale, seq_len=args.seq)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    if args.corpus:
        with open(args.corpus, "rb") as f:
            blob = f.read()
        cfg = dataclasses.replace(cfg, vocab_size=256)
        data = ByteCorpus(blob, seq_len=args.seq, global_batch=args.batch)
    else:
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch)

    trainer = Trainer(cfg, ckpt_dir=args.ckpt_dir,
                      microbatches=args.microbatches, lr=args.lr,
                      total_steps=args.steps, device=args.device)
    out = trainer.fit(data, args.steps)
    print(f"final loss: {out['final_loss']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
