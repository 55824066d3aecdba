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
``--batch`` x ``--seq``).  Step times read
:func:`repro_torch.obs.trace.clock`.

``Trainer(cfg, mesh=make_mesh(data=D, model=M))`` trains at mesh scope,
on a world the caller started: over the data axes (pod x data) each rank
takes its rows of the batch, the AdamW moments sharded by ``zero1_specs``
(``zero1=False`` keeps them whole); over a ``model`` axis wider than 1 the
layers run split (``distributed.model_split``: Megatron's products, the
vocab-parallel logits and cross entropy, expert parallelism), each rank
holding its shard of every leaf ``param_specs`` splits over ``model``;
the step is ``train.step.make_mesh_train_step``.  Under
``use_level(O3|O4)`` attention runs over the ring on the trainer's mesh,
at the rank's heads.  A one-process mesh (no process group) with a model
axis wider than 1 raises.  Its checkpoints hold the parameters and the
moments whole, written by the mesh's first rank with the stacked
partition specs, and a restore keeps each rank's tiles for the current
mesh, which may differ from the saver's in its data axes.  The counts
take the data and model widths and the ranks that share a card: the
parameters a rank holds are counted from the specs, its moments and the
update's transients divide by the data width, and the card holds every
rank's peak.  ``main`` has no mesh option, as the JAX package's has none.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from typing import Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import execlevel
from repro_torch.core.containers import resolve_device
from repro_torch.core.sharding import NamedSharding, PartitionSpec as P
from repro_torch.core.topology import topology_of
from repro_torch.data import ByteCorpus, SyntheticLM
from repro_torch.distributed.collectives import reduce_plan
from repro_torch.distributed.model_split import split_of
from repro_torch.distributed.partition import (map_specs, model_dims,
                                               param_specs, zero1_specs)
from repro_torch.models.lm import LM
from repro_torch.obs.trace import clock
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamState
from repro_torch.optim.schedules import cosine, wsd
from repro_torch.runtime import HeartbeatStore, Monitor
from repro_torch.train import (TrainState, abstract_state, create,
                               make_train_step)
from repro_torch.train.step import (make_mesh_train_step, mesh_state,
                                    moment_dims, whole_state)
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["reduce_config", "Trainer", "main", "update_peak_bytes",
           "activation_bytes", "train_peak_bytes", "rank_param_count"]

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
#: Of those counts, the gradient's bytes (whole on every rank until the
#: mesh step reduce-scatters it), the two moments' and the update's
#: transient copies': at mesh scope the last two divide by the data width.
GRAD_BYTES, MOMENT_BYTES = 4, 8
UPDATE_TRANSIENT_BYTES = UPDATE_PEAK_BYTES - 2 - GRAD_BYTES - MOMENT_BYTES
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


def rank_param_count(cfg: ModelConfig, model_width: int = 1) -> int:
    """The parameters a rank holds at a model width: every leaf
    ``param_specs`` splits over ``model`` a ``1 / model_width`` share, the
    others whole, counted on the leaves (the padded vocabulary's rows
    included); at width 1 ``cfg.param_count()``, the analytic count the
    refusals have always used."""
    if model_width == 1:
        return cfg.param_count()
    params = LM(cfg).init(device="meta")
    dims = model_dims(param_specs(params))
    counts = tree_leaves(tree_map(
        lambda p, m: p.numel() // (1 if m is None else model_width),
        params, dims))
    return sum(counts)


def update_peak_bytes(cfg: ModelConfig, *, data_width: int = 1,
                      ranks_per_card: int = 1, model_width: int = 1) -> int:
    """The memory training ``cfg`` holds on a card at the AdamW update's
    peak: :data:`UPDATE_PEAK_BYTES` a bf16 parameter, the parameter's own
    bytes beside the rest at another ``cfg.pdtype`` (activations are freed
    by then).  At mesh scope a rank holds its parameters
    (:func:`rank_param_count` at ``model_width``) and their gradient whole
    and ``1 / data_width`` of the moments and transients, and
    ``ranks_per_card`` ranks share the card."""
    size = torch.empty((), dtype=cfg.pdtype).element_size()
    per = size + GRAD_BYTES \
        + (MOMENT_BYTES + UPDATE_TRANSIENT_BYTES) / data_width
    return int(ranks_per_card * rank_param_count(cfg, model_width) * per)


def activation_bytes(cfg: ModelConfig, tokens: int, *,
                     model_width: int = 1) -> int:
    """The activations a microbatch of ``tokens`` positions (the
    frontend's counted) holds when its backward starts: the logits' chain
    (:data:`LOGIT_BYTES` a vocabulary entry, a rank's ``1 / model_width``
    of the vocabulary) and each layer's kept input (:data:`LAYER_BYTES` a
    model dimension, more without remat; whole on every model rank)."""
    layer = LAYER_BYTES if cfg.remat else LAYER_BYTES_NO_REMAT
    return tokens * (LOGIT_BYTES * cfg.padded_vocab // model_width
                     + layer * cfg.num_layers * cfg.d_model)


def train_peak_bytes(cfg: ModelConfig, tokens: int, *, data_width: int = 1,
                     ranks_per_card: int = 1, model_width: int = 1) -> int:
    """The memory a training step of ``cfg`` on microbatches of ``tokens``
    positions (a rank's, at mesh scope) holds on a card at its peak: the
    larger of the AdamW update's (:func:`update_peak_bytes`) and the
    backward's start (the parameters a rank holds, their gradients and
    moments, :data:`GRAD_AND_MOMENT_BYTES` a bf16 parameter with the
    moments divided by ``data_width``, beside :func:`activation_bytes`,
    whose logits divide by ``model_width``), times the ``ranks_per_card``
    ranks that share the card."""
    size = torch.empty((), dtype=cfg.pdtype).element_size()
    backward = rank_param_count(cfg, model_width) * (
        size + GRAD_BYTES + MOMENT_BYTES / data_width) \
        + activation_bytes(cfg, tokens, model_width=model_width)
    return max(update_peak_bytes(cfg, data_width=data_width,
                                 ranks_per_card=ranks_per_card,
                                 model_width=model_width),
               int(ranks_per_card * backward))


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
    caller names another).  With ``mesh`` (module docstring) every rank of
    the world constructs it; ``heartbeats`` (default an in-process store)
    is where ``fit`` posts each step, a ``FileHeartbeatStore`` shared by
    the ranks letting one rank's :attr:`monitor` see them all."""

    def __init__(self, cfg: ModelConfig, *, mesh=None, microbatches: int = 1,
                 ckpt_dir: Optional[str] = None, save_every: int = 50,
                 lr: float = 3e-4, total_steps: int = 1000,
                 zero1: bool = True, seed: int = 0, device=None,
                 heartbeats: Optional[HeartbeatStore] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.plan, self.split = _mesh_plans(mesh)
        self.device = resolve_device(device)
        self.lm = LM(cfg)
        sched = wsd(lr, total_steps) if cfg.name.startswith("minicpm") \
            else cosine(lr, total_steps)
        self.opt = adamw(sched)
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.save_every = save_every
        self.heartbeats = heartbeats if heartbeats is not None \
            else HeartbeatStore()
        self.monitor = Monitor(self.heartbeats)
        if self.plan is None:
            self.step_fn = make_train_step(self.lm, self.opt,
                                           microbatches=microbatches)
            self.state = create(self.lm, self.opt, seed, device=self.device)
        else:
            a = abstract_state(self.lm, self.opt)
            self.param_specs = param_specs(a.params)
            self.moment_specs = zero1_specs(a.params, mesh) if zero1 \
                else self.param_specs
            self.dims = moment_dims(self.moment_specs, a.params, self.plan)
            self.mdims = None
            if self.split is not None:
                self.mdims = model_dims(self.param_specs)
                _check_model_split(a.params, self.mdims, self.split.size)
            self.step_fn = make_mesh_train_step(
                self.lm, self.opt, self.plan, self.dims,
                microbatches=microbatches, split=self.split,
                mdims=self.mdims)
            self.state = mesh_state(self.lm.init(seed, device=self.device),
                                    self.opt, self.plan, self.dims,
                                    self.split, self.mdims)
        if self.ckpt and self.ckpt.latest_step() is not None:
            if self.plan is None:
                self.state = self.ckpt.restore(self.state)
            else:
                self.state = self.ckpt.restore(
                    self.state, mesh=mesh, shardings=self.shardings())
            self._say(f"resumed from step {int(self.state.step)}")

    # -- mesh scope -----------------------------------------------------------

    def mesh_index(self) -> int:
        """This rank's flat index over the mesh (pod-major, the model axis
        innermost); 0 without a mesh."""
        if self.plan is None:
            return 0
        i = self.plan.shard_index()
        return i if self.split is None else \
            i * self.split.size + self.split.index

    def _say(self, text: str) -> None:
        if self.mesh_index() == 0:
            print(text)

    def shardings(self) -> TrainState:
        """The state's NamedSharding tree on the trainer's mesh (a rank
        keeps its tiles of the moments)."""
        def named(spec):
            return NamedSharding(self.mesh, spec)
        rep = named(P())
        p = map_specs(named, self.param_specs)
        m = map_specs(named, self.moment_specs)
        return TrainState(step=rep, params=p,
                          opt_state=AdamState(count=rep, mu=m, nu=m))

    def checkpoint_specs(self) -> TrainState:
        """The state's specs as the checkpointer writes them: the stacked
        ones (``stacked=True``), whose strings are the reference's."""
        a = abstract_state(self.lm, self.opt)
        p = param_specs(a.params, stacked=True)
        m = zero1_specs(a.params, self.mesh, stacked=True) \
            if self.moment_specs is not self.param_specs else p
        return TrainState(step=P(), params=p,
                          opt_state=AdamState(count=P(), mu=m, nu=m))

    def save(self, step: int) -> None:
        """Checkpoint the state: at mesh scope the parameters and moments
        gathered whole (every rank takes part) and the mesh's first rank
        writes with the stacked specs, the others waiting until it has."""
        if self.plan is None:
            self.ckpt.save(step, self.state)
            return
        whole = whole_state(self.state, self.plan, self.dims, self.split,
                            self.mdims)
        if self.mesh_index() == 0:
            self.ckpt.save(step, whole, specs=self.checkpoint_specs())
        del whole
        z = self.plan.psum_all(torch.zeros(1, device=self.device))
        if self.split is not None:                       # a barrier
            self.split.all_reduce(z)

    def fit(self, data, steps: int, *, log_every: int = 10,
            worker: Optional[int] = None) -> dict:
        """Steps from the state's step up to ``steps``.  The history holds,
        every ``log_every`` steps and at the first, the step, its loss and
        grad norm, and the seconds since ``fit`` began (host clock, read
        after the loss, which waits for the step to finish).  Heartbeats go
        out as ``worker`` (default: this rank's :meth:`mesh_index`).  At
        mesh scope under ``use_level(O3|O4)`` the steps run at that level
        on the trainer's mesh, so that attention runs over its ring."""
        if worker is None:
            worker = self.mesh_index()
        ctx = execlevel.current()
        level = execlevel.use_level(ctx.level, self.mesh) \
            if self.plan is not None and ctx.level >= execlevel.ExecLevel.O3 \
            else contextlib.nullcontext()
        history = []
        start = int(self.state.step)
        t0 = clock()
        with level:
            for i in range(start, steps):
                batch = data.batch(i)
                if self.plan is None:
                    batch = {k: torch.as_tensor(v, device=self.device)
                             for k, v in batch.items()}
                self.state, metrics = self.step_fn(self.state, batch)
                self.heartbeats.post(worker, i)
                if (i + 1) % log_every == 0 or i == start:
                    loss = float(metrics["loss"])
                    dt = clock() - t0
                    self._say(f"step {i+1:5d} loss {loss:.4f} "
                              f"({dt/(i-start+1):.2f}s/step)")
                    history.append({"step": i + 1, "loss": loss,
                                    "grad_norm": float(metrics["grad_norm"]),
                                    "time_s": dt})
                if self.ckpt and (i + 1) % self.save_every == 0:
                    if self.plan is None:
                        self.ckpt.save_async(i + 1, self.state)
                    else:
                        self.save(i + 1)
        if self.ckpt:
            self.ckpt.wait()
            self.save(steps)
        return {"history": history,
                "final_loss": history[-1]["loss"] if history else None}


def _mesh_plans(mesh):
    """(the mesh's ReducePlan over its data axes, its ModelSplit): (None,
    None) without a mesh or where every axis is one rank wide (the chip
    step then runs); the split None where the model axis is one rank wide.
    A one-process mesh with a wider model axis raises (``model_split.
    split_of``)."""
    if mesh is None:
        return None, None
    topo = topology_of(mesh)
    split = split_of(mesh, held=True)
    plan = reduce_plan(mesh, topo)
    if plan.width == 1 and split is None:
        return None, None
    return plan, split


def _check_model_split(params, mdims, width: int) -> None:
    """Every dim the spec splits over ``model`` divides into ``width``
    shards (ValueError naming the first that does not)."""
    bad = []
    tree_map(lambda p, m: bad.append((tuple(p.shape), m)) if m is not None
             and p.shape[m] % width else None, params, mdims)
    if bad:
        shape, m = bad[0]
        raise ValueError(f"a leaf of shape {shape} does not split into "
                         f"{width} shards along dim {m} (the model axis)")


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
