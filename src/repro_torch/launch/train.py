"""Training launcher: config -> data -> train loop -> checkpoints
(counterpart of ``repro.launch.train``, chip scope).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --scale 1.0 --steps 8 --batch 4 --seq 512

It runs on the card unless ``--device cpu`` is given (then with a small
``--scale``, e.g. 0.05).  Every family trains: dense, MoE (``--arch
qwen3-moe-30b-a3b``), SSM (``--arch mamba2-370m``), hybrid (``--arch
zamba2-7b``), VLM (``--arch qwen2-vl-72b``) and audio (``--arch
musicgen-medium``, whole on the card); the last two on synthetic batches
with seeded standard-normal frontend embeddings.  On the card a config
whose step does not fit the card's memory less :data:`TRAIN_SLACK_BYTES`
raises before anything is allocated (qwen3-moe-30b-a3b, zamba2-7b,
qwen2-vl-72b and phi3-mini-3.8b at scale 1), and names the depth that
would train: the most layers that fit by the same count (``--layers``
trains at that depth).  The count (:func:`train_peak_bytes`) is the
larger of the step's two peaks: the AdamW update's
(:func:`update_peak_bytes`, :data:`UPDATE_PEAK_BYTES` a bf16 parameter)
and the backward's start, where the gradients and moments sit beside a
microbatch's activations (:func:`activation_bytes`, which grow with
``--batch`` x ``--seq``).  The mesh
(``Trainer(mesh=...)``, ZeRO-1 moment sharding) is the LM half of mesh
scope (ROADMAP queue 1 item 10b): ``mesh`` raises and the JAX Trainer's
``zero1`` is not taken.  Step times read :func:`repro_torch.obs.trace.clock`.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.containers import resolve_device
from repro_torch.data import ByteCorpus, SyntheticLM
from repro_torch.models.lm import LM
from repro_torch.obs.trace import clock
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine, wsd
from repro_torch.runtime import HeartbeatStore, Monitor
from repro_torch.train import create, make_train_step

__all__ = ["reduce_config", "Trainer", "main", "update_peak_bytes",
           "activation_bytes", "train_peak_bytes"]

#: Bytes a bf16 parameter holds at a training step's peak, the AdamW
#: update (measured on an H100 training qwen3-moe-30b-a3b and zamba2-7b
#: cut in depth, PERF.md §6): its own 2, the gradient's and the moments'
#: 12, and 12 more that the update's transient copies hold at its peak.
#: The dense configs' measured peaks at 2 steps of 1 x 512 tokens sit
#: above it: 26.3 (phi3-mini-3.8b at 25 layers) to 27.7 (gemma-2b, with
#: its 256000-entry vocabulary) bytes a parameter, 8-9 bytes an entry of
#: the embedding matrix in all three; :data:`TRAIN_SLACK_BYTES` covers the
#: difference.
UPDATE_PEAK_BYTES = 26
#: Bytes a bf16 parameter holds before the update: its own 2, an f32
#: gradient and two f32 moments.
GRAD_AND_MOMENT_BYTES = 14
#: Activation bytes a token holds at the backward's start, per entry of
#: the (padded) vocabulary: the logits in bf16 (2), their f32 copy (4),
#: the log-softmax (4), its f32 gradient (4) and the bf16 gradient (2).
LOGIT_BYTES = 16
#: Activation bytes a token holds per layer and model dimension under
#: remat (each layer's bf16 input, kept for the recompute); without remat
#: a layer keeps its intermediates, counted as 8 such inputs.
LAYER_BYTES, LAYER_BYTES_NO_REMAT = 2, 16
#: Bytes of the card a training run cannot count on beyond that count: the
#: CUDA context, the caching allocator's reserved but unallocated blocks
#: (2.4 GB when phi3-mini-3.8b at 27 layers ran out of memory on an H100,
#: PERF.md §6) and the dense configs' excess over the update's count
#: (gemma-2b's peak was 4.3 GB above it).
TRAIN_SLACK_BYTES = 5_000_000_000


def update_peak_bytes(cfg: ModelConfig) -> int:
    """The memory training ``cfg`` holds at the AdamW update's peak:
    :data:`UPDATE_PEAK_BYTES` a bf16 parameter, the parameter's own bytes
    beside the rest at another ``cfg.pdtype`` (activations are freed by
    then)."""
    size = torch.empty((), dtype=cfg.pdtype).element_size()
    return cfg.param_count() * (UPDATE_PEAK_BYTES - 2 + size)


def activation_bytes(cfg: ModelConfig, tokens: int) -> int:
    """The activations a microbatch of ``tokens`` positions (the
    frontend's counted) holds when its backward starts: the logits' chain
    (:data:`LOGIT_BYTES` a vocabulary entry) and each layer's kept input
    (:data:`LAYER_BYTES` a model dimension, more without remat)."""
    layer = LAYER_BYTES if cfg.remat else LAYER_BYTES_NO_REMAT
    return tokens * (LOGIT_BYTES * cfg.padded_vocab
                     + layer * cfg.num_layers * cfg.d_model)


def train_peak_bytes(cfg: ModelConfig, tokens: int) -> int:
    """The memory a training step of ``cfg`` on microbatches of ``tokens``
    positions holds at its peak: the larger of the AdamW update's
    (:func:`update_peak_bytes`) and the backward's start (the parameters,
    gradients and moments, :data:`GRAD_AND_MOMENT_BYTES` a bf16 parameter,
    beside :func:`activation_bytes`)."""
    size = torch.empty((), dtype=cfg.pdtype).element_size()
    backward = cfg.param_count() * (GRAD_AND_MOMENT_BYTES - 2 + size) \
        + activation_bytes(cfg, tokens)
    return max(update_peak_bytes(cfg), backward)


def reduce_config(cfg: ModelConfig, scale: float, *,
                  seq_len: int = 256) -> ModelConfig:
    """Shrink an assigned architecture into a CPU-runnable sibling (same
    family, same block structure, fewer/narrower layers), as the JAX
    package's ``reduce_config`` does (MoE: at most 8 experts and top-2,
    ``moe_d_ff`` scaled, capacity factor 4, ``d_ff`` only with a dense
    residual; SSM and hybrid: ``ssm_state`` and ``ssm_headdim`` at most 32,
    one group, ``d_model`` at least 64 (after the heads are sized from the
    narrower width, as there); hybrid: ``attn_every`` clamped to 2-3; VLM
    and audio: ``frontend_len`` at most ``seq_len // 4``, ``grid_hw`` 4,
    and M-RoPE's sections recut to the narrower head, a quarter of
    ``head_dim / 2`` each for h and w and the rest for t)."""
    def s(x, lo=1, mult=1):
        v = max(lo, int(round(x * scale)))
        return -(-v // mult) * mult

    kw: dict = dict(
        num_layers=max(2, int(round(cfg.num_layers * scale))),
        d_model=s(cfg.d_model, 32, 16), vocab_size=min(cfg.vocab_size, 2048),
        dtype="float32", param_dtype="float32", remat=False,
        scan_layers=True)
    if cfg.has_attention:
        heads = max(2, int(round(cfg.num_heads * scale)))
        kvh = max(1, min(cfg.num_kv_heads, heads))
        while heads % kvh:
            kvh -= 1
        kw.update(num_heads=heads, num_kv_heads=kvh,
                  head_dim=max(8, kw["d_model"] // heads // 2 * 2),
                  d_ff=s(cfg.d_ff, 64, 16) if cfg.d_ff else 0)
    if cfg.family == "moe":
        kw.update(num_experts=min(cfg.num_experts, 8),
                  experts_per_token=min(cfg.experts_per_token, 2),
                  moe_d_ff=s(cfg.moe_d_ff, 32, 8),
                  d_ff=s(cfg.d_ff, 64, 16) if cfg.dense_residual else 0,
                  capacity_factor=4.0)
    if cfg.has_ssm:
        kw.update(ssm_state=min(cfg.ssm_state, 32),
                  ssm_headdim=min(cfg.ssm_headdim, 32), ssm_groups=1)
        kw["d_model"] = max(64, kw["d_model"])
    if cfg.family == "hybrid":
        kw.update(attn_every=max(2, min(cfg.attn_every, 3)))
    if cfg.frontend:
        kw.update(frontend_len=min(cfg.frontend_len, seq_len // 4),
                  grid_hw=4)
        if cfg.m_rope:
            hd2 = kw["head_dim"] // 2
            kw["mrope_sections"] = (hd2 - 2 * (hd2 // 4), hd2 // 4, hd2 // 4)
    return dataclasses.replace(cfg, name=f"{cfg.name}-x{scale}", **kw)


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
                "Trainer(mesh=...) shards the state over a mesh: the LM half "
                "of mesh scope, not ported yet (ROADMAP queue 1 item 10b)")
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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (at the "
                         "scale's width), e.g. the depth a refusal names")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.scale != 1.0:
        cfg = reduce_config(cfg, args.scale, seq_len=args.seq)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        have = torch.cuda.get_device_properties(dev).total_memory
        room = have - TRAIN_SLACK_BYTES
        tokens = -(-args.batch // args.microbatches) \
            * (args.seq + (cfg.frontend_len if cfg.frontend else 0))
        need = train_peak_bytes(cfg, tokens)
        if need > room:
            fit = max((n for n in range(1, cfg.num_layers) if
                       train_peak_bytes(dataclasses.replace(
                           cfg, num_layers=n), tokens) <= room), default=0)
            ap.error(f"{cfg.name}: {need / 1e9:.1f} GB of parameters, "
                     f"gradients, AdamW moments and the larger of the "
                     f"update's transient copies ({UPDATE_PEAK_BYTES} bytes "
                     f"a parameter at the update's peak) and the "
                     f"activations of {tokens} positions a microbatch do "
                     f"not fit the card's {have / 1e9:.1f} GB less "
                     f"{TRAIN_SLACK_BYTES / 1e9:.0f} GB of slack (at full "
                     f"width {fit} of its {cfg.num_layers} layers would, "
                     f"by the same count); pass --scale below 1 or "
                     f"--layers {fit}")
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    if args.corpus:
        with open(args.corpus, "rb") as f:
            blob = f.read()
        cfg = dataclasses.replace(cfg, vocab_size=256)
        data = ByteCorpus(blob, seq_len=args.seq, global_batch=args.batch)
    else:
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch,
                           frontend_len=cfg.frontend_len if cfg.frontend
                           else 0, d_model=cfg.d_model)

    trainer = Trainer(cfg, ckpt_dir=args.ckpt_dir,
                      microbatches=args.microbatches, lr=args.lr,
                      total_steps=args.steps, device=dev)
    out = trainer.fit(data, args.steps)
    print(f"final loss: {out['final_loss']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
