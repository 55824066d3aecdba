"""LM: the architecture facade of every family: dense, MoE, SSM, hybrid,
VLM and audio (counterpart of ``repro.models.lm``, chip scope).

    init               seeded random weights on the card (or the CPU)
    forward            full-sequence logits (through ``stack_apply``, with
                       remat when ``cfg.remat``)
    loss               token-mean cross entropy of a batch (training)
    prefill            prompt -> last logits + a fixed-size K/V cache
    decode_step        one token against that cache (the fixed engine)
    decode_step_paged  one token per slot against the paged cache (dense
                       and MoE only, as in the JAX package)
    prefill_chunk      one prompt chunk of one slot into the paged cache
                       (dense and MoE only)

Parameters mirror the JAX package's pytree as dicts of tensors, except
that its layer-stacked leaves become a list of per-layer dicts
(``params["layers"]``, the hybrid's ``params["tail"]``) and the hybrid's
``params["groups"]``, stacked (ngroups, attn_every, ...) there, a list of
ngroups lists of ``attn_every`` per-layer dicts.  Caches keep the JAX
layouts: the fixed cache is (layers, B, kv_heads, max_len, head_dim); the
SSM state is ``cache["ssm"] = {"conv": (layers, B, conv_width - 1, C),
"ssm": (layers, B, H, P, N) f32}``; the hybrid keeps both, with K/V for
each of its ngroups shared-block sites (one set of weights, used after
every group of ``attn_every`` mamba layers); the paged state is ``kpages``
/ ``vpages`` (layers, P, kv_heads, page_size, head_dim), ``table`` (B, n)
int32 and ``lens`` (B,) int32.  Decode steps update caches in place (the
JAX package returns updated copies) and return the same tensors.

The MoE family routes every token through ``models.moe.moe_apply``: at
``cfg.capacity_factor`` in ``forward``, ``loss`` and ``prefill``, at
:data:`DECODE_CAPACITY_FACTOR` in the decode steps and chunked prefill, as
the JAX package does.  Nothing is masked before the router: an inactive
decode slot's token and a chunk's padding are routed and take capacity
like any other, so capacity couples the requests of a batch.

The VLM and audio families are dense backbones behind a stubbed modality
frontend: ``forward``, ``loss`` (``batch["frontend_embeds"]``) and
``prefill`` take ``frontend_embeds`` (B, ``cfg.frontend_len``, d_model),
precomputed patch or frame embeddings that fill the first
``frontend_len`` positions ahead of the tokens' (a frontend config raises
ValueError without them).  Positions count the frontend's: a prefill of S
tokens fills ``frontend_len + S`` cache slots, and ``loss`` drops the
frontend positions' logits.  With ``cfg.m_rope`` (qwen2-vl) the rotary
tables come from three position streams (``layers.mrope_positions``:
patches at t = 0 on a ``grid_hw`` raster, text advancing in all three
from ``frontend_len // grid_hw``), stitched along the feature dim by
``cfg.mrope_sections``; the decode step's text position is ``cur_len -
frontend_len + frontend_len // grid_hw`` in all three streams.

Under the model axis's split (``distributed.model_split``, entered by the
mesh trainer and by the ``Engine`` on a mesh whose model axis is wider
than 1) the residual stream stays whole on every rank of a model group:
the embedding is a masked lookup of this rank's vocabulary rows, summed
over the group; the logits are this rank's vocabulary columns (tied or
not), gathered whole for ``forward``, ``prefill`` and the decode step and
kept split for ``loss``, whose cross entropy is vocab-parallel
(``model_split.vocab_cross_entropy``; the padded rows, which sit on the
last ranks, masked as ``_logits`` slices them off); the fixed cache holds
this rank's kv heads (``model_split.heads``).  The paged paths are not
split.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.containers import resolve_device
from repro_torch.distributed import model_split as ms
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (dense_init, linear, mlp,
                                       mrope_positions, rms_norm,
                                       rms_norm_init, rope)

Params = dict[str, Any]

__all__ = ["LM", "cross_entropy_loss", "DECODE_CAPACITY_FACTOR"]

#: The MoE capacity factor of the decode steps and chunked prefill (the JAX
#: package's ``_moe_decode``): few tokens a step, so a roomy buffer.
DECODE_CAPACITY_FACTOR = 4.0


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -1
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-mean CE in f32; returns (loss, n_tokens)."""
    logits = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) * mask
    n = torch.clamp(torch.sum(mask), min=1)
    return torch.sum(nll) / n, n


class MetaGenerator:
    """The generator :meth:`LM.init` hands the layers' initialisers on the
    ``meta`` device (``torch.Generator`` has no meta device): it names the
    device; ``dense_init`` draws nothing there."""
    device = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def _check_family(self) -> None:
        cfg = self.cfg
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm",
                              "audio"):
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, seed: int = 0, *, device=None) -> Params:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        made on ``device`` (the card unless the caller names another); on
        ``meta``, tensors of the weights' shapes and dtypes, nothing drawn
        or allocated."""
        self._check_family()
        cfg = self.cfg
        dev = resolve_device(device)
        if dev.type == "meta":          # shapes and dtypes only, no draws
            gen = MetaGenerator()
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        p: Params = {
            "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                scale=cfg.d_model ** -0.5, dtype=cfg.pdtype),
            "final_norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                      dtype=cfg.pdtype)
        fam = cfg.family
        if fam == "hybrid":
            ngroups, tail = self._hybrid_split()
            if ngroups:
                p["groups"] = [tf.stack_init(gen, cfg, tf.mamba_block_init,
                                             cfg.attn_every)
                               for _ in range(ngroups)]
            if tail:
                p["tail"] = tf.stack_init(gen, cfg, tf.mamba_block_init,
                                          tail)
            p["shared_attn"] = tf.dense_block_init(gen, cfg)
            return p
        block_init = {"moe": tf.moe_block_init,
                      "ssm": tf.mamba_block_init}.get(fam,
                                                      tf.dense_block_init)
        p["layers"] = tf.stack_init(gen, cfg, block_init, cfg.num_layers)
        return p

    def _hybrid_split(self) -> tuple[int, int]:
        """(full groups of attn_every mamba layers + the shared attention
        block, tail mamba layers)."""
        cfg = self.cfg
        ngroups = cfg.num_layers // cfg.attn_every
        return ngroups, cfg.num_layers - ngroups * cfg.attn_every

    # ------------------------------------------------------------------
    # embedding / positions
    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor,
               frontend_embeds=None, *, prompt: bool = True) -> torch.Tensor:
        """The tokens' embeddings in ``cfg.act_dtype``; for a prompt of a
        frontend config, ``frontend_embeds`` (B, frontend_len, d_model)
        ahead of them.  Both are scaled where the config scales."""
        cfg = self.cfg
        x = self._lookup(params["embed"], tokens)
        if prompt and cfg.frontend is not None:
            want = (x.shape[0], cfg.frontend_len, cfg.d_model)
            if frontend_embeds is None:
                raise ValueError(f"{cfg.name} requires frontend_embeds "
                                 f"{want} (the stub modality input)")
            fe = torch.as_tensor(frontend_embeds, device=x.device)
            if tuple(fe.shape) != want:
                raise ValueError(f"{cfg.name}: frontend_embeds of shape "
                                 f"{tuple(fe.shape)}, want {want}")
            x = torch.cat([fe.to(cfg.act_dtype), x], dim=1)
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.act_dtype,
                                 device=x.device)
        return x

    def _lookup(self, embed: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        """The tokens' embedding rows in ``cfg.act_dtype``; under the model
        axis's split a masked lookup of this rank's vocabulary rows, summed
        over the group (each token's row is on one rank)."""
        act = self.cfg.act_dtype
        split = ms.current()
        # F.embedding: its backward adds the rows' gradients in a fixed
        # order on the card (a sort, then segment sums), so training steps
        # give the same bits from run to run
        if split is None:
            return F.embedding(tokens.long(), embed).to(act)
        # reference constrain site: lm.py:147 (the embeddings d-sharded)
        rows = ms.local(embed, 0)
        t = tokens.long() - split.index * rows.shape[0]
        mine = (t >= 0) & (t < rows.shape[0])
        x = F.embedding(torch.where(mine, t, 0), rows) * mine[..., None]
        return ms.out_of(x.to(act))

    def _logits_local(self, params: Params, x: torch.Tensor
                      ) -> torch.Tensor:
        """Unembed (tied or not) and softcap, over the padded vocabulary:
        under the model axis's split this rank's columns of it."""
        cfg = self.cfg
        w_out = params.get("unembed")
        if w_out is None:
            w_out = ms.local(params["embed"], 0).t()
        else:
            w_out = ms.local(w_out, 1)
        logits = linear(ms.into(x), w_out)
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits.float() / c) * c
        return logits

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Unembed (tied or not), softcap, slice off vocab padding; under
        the model axis's split the ranks' columns gathered whole."""
        cfg = self.cfg
        # reference constrain site: lm.py:209 (the logits over the vocab)
        logits = ms.gather(self._logits_local(params, x), -1)
        if cfg.padded_vocab != cfg.vocab_size:
            logits = logits[..., :cfg.vocab_size]
        return logits

    def _rope_tables(self, batch: int, seq_len: int, device):
        """cos/sin (B, L, hd/2) f32 of positions 0..L-1, or (3, B, L,
        hd/2) of the M-RoPE streams."""
        cfg = self.cfg
        if not cfg.has_attention:
            return None, None
        if cfg.m_rope:
            pos = mrope_positions(seq_len, cfg.frontend_len, cfg.grid_hw,
                                  device)
            positions = pos[:, None, :].expand(3, batch, seq_len)
        else:
            positions = torch.arange(seq_len, dtype=torch.int32,
                                     device=device).expand(batch, seq_len)
        return rope(positions, cfg.head_dim, cfg.rope_theta)

    def _step_rope(self, batch: int, cur: int, device):
        """cos/sin of a decode step's one position ``cur`` (slots already
        in the cache, the frontend's included): (B, 1, hd/2), or (3, B,
        1, hd/2) for M-RoPE, whose text streams advance from the visual
        block's offset, as ``mrope_positions`` has them."""
        cfg = self.cfg
        if cfg.m_rope:
            pos = cur - cfg.frontend_len \
                + cfg.frontend_len // max(cfg.grid_hw, 1)
            shape = (3, batch, 1)
        else:
            pos, shape = cur, (batch, 1)
        positions = torch.full(shape, pos, dtype=torch.int32, device=device)
        return rope(positions, cfg.head_dim, cfg.rope_theta)

    # ------------------------------------------------------------------
    # full-sequence forward and prefill
    # ------------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor,
                frontend_embeds=None):
        """Full-sequence forward -> (logits (B, S, V), aux); S counts the
        frontend's positions."""
        x, aux = self._hidden(params, tokens, frontend_embeds)
        return self._logits(params, x), aux

    def _hidden(self, params: Params, tokens: torch.Tensor,
                frontend_embeds=None):
        """The final-normed residual stream (B, S, d) and the aux losses."""
        self._check_family()
        cfg = self.cfg
        x = self._embed(params, tokens, frontend_embeds)
        B, S, _ = x.shape
        cos, sin = self._rope_tables(B, S, x.device)
        if cfg.family == "hybrid":
            x, aux = self._hybrid_forward(params, x, cos, sin)
        elif cfg.family == "ssm":
            x, aux = tf.stack_apply(x, params["layers"], functools.partial(
                tf.mamba_block, cfg=cfg), cfg)
        else:
            block = tf.moe_block if cfg.family == "moe" else tf.dense_block
            x, aux = tf.stack_apply(x, params["layers"], functools.partial(
                block, cfg=cfg, cos=cos, sin=sin), cfg)
        return rms_norm(x, params["final_norm"]), aux

    def _hybrid_forward(self, params: Params, x, cos, sin):
        """Each group's mamba layers then the weight-shared attention block,
        then the tail's mamba layers; every block under remat when
        ``cfg.remat`` (through ``stack_apply``).  The aux losses are
        zeros."""
        cfg = self.cfg
        mamba = functools.partial(tf.mamba_block, cfg=cfg)
        shared = functools.partial(tf.dense_block, cfg=cfg, cos=cos, sin=sin)
        for group in params.get("groups", []):
            x, _ = tf.stack_apply(x, group, mamba, cfg)
            x, _ = tf.stack_apply(x, [params["shared_attn"]], shared, cfg)
        x, _ = tf.stack_apply(x, params.get("tail", []), mamba, cfg)
        return x, tf.zero_aux(x.device)

    def loss(self, params: Params, batch: dict):
        """``(loss, metrics)`` of a batch ``{"tokens", "labels"}`` (B, S)
        int (tensors, or host arrays moved to the parameters' device), with
        ``"frontend_embeds"`` for a frontend config: token-mean cross
        entropy of the next-token logits, in f32, the frontend positions'
        logits dropped (they predict no token).  The MoE family adds
        ``0.01 * aux_lb / L + 1e-3 * aux_z / L`` over its L layers and
        reports ``metrics["aux_lb"]``."""
        cfg = self.cfg
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        x, aux = self._hidden(params, tokens, batch.get("frontend_embeds"))
        split = ms.current() is not None
        # split: this rank's columns of the padded vocabulary
        logits = self._logits_local(params, x) if split \
            else self._logits(params, x)
        if cfg.frontend is not None:
            logits = logits[:, cfg.frontend_len:, :]
        loss, n = ms.vocab_cross_entropy(logits, labels, cfg.vocab_size) \
            if split else cross_entropy_loss(logits, labels)
        metrics = {"loss": loss, "tokens": n}
        if cfg.family == "moe":
            loss = loss + 0.01 * aux["aux_lb"] / cfg.num_layers \
                + 1e-3 * aux["aux_z"] / cfg.num_layers
            metrics["aux_lb"] = aux["aux_lb"]
        return loss, metrics

    def prefill(self, params: Params, tokens: torch.Tensor,
                frontend_embeds=None, max_len: Optional[int] = None):
        """Process the prompt; returns (last-position logits (B, V), cache)
        with the K/V cache padded to ``max_len`` positions, which count a
        frontend config's ``frontend_len`` ahead of the tokens (the SSM
        family keeps no K/V: its cache is the layers' ``{conv, ssm}``
        states; the hybrid's holds both, K/V for each shared-block site).
        A prompt of an SSM or hybrid config longer than ``models.ssm.CHUNK``
        tokens must be a multiple of it (ValueError otherwise)."""
        self._check_family()
        cfg = self.cfg
        x = self._embed(params, tokens, frontend_embeds)
        B, S, _ = x.shape
        max_len = max(max_len or S, S)
        cos, sin = self._rope_tables(B, S, x.device)
        cache: Params = {"cur_len": S}
        if cfg.family == "ssm":
            states = []
            for lp in params["layers"]:
                x, st = tf.mamba_block_state(x, lp, cfg)
                states.append(st)
            cache["ssm"] = _stack_states(states)
        elif cfg.family == "hybrid":
            x = self._hybrid_prefill(params, x, cos, sin, cache, max_len)
        else:
            cache["k"], cache["v"] = self._kv_cache(cfg.num_layers, B,
                                                    max_len, x.device)
            block_kv = tf.moe_block_kv if cfg.family == "moe" \
                else tf.dense_block_kv
            for i, lp in enumerate(params["layers"]):
                x, (k, v) = block_kv(x, lp, cfg, cos, sin)
                cache["k"][i, :, :, :S] = k
                cache["v"][i, :, :, :S] = v
        x = rms_norm(x, params["final_norm"])
        logits = self._logits(params, x[:, -1:, :])[:, 0, :]
        return logits, cache

    def _kv_cache(self, sites: int, batch: int, max_len: int, device,
                  dtype=None):
        """Zeroed K/V (sites, B, kv heads, max_len, hd): this rank's kv
        heads under the model axis's split."""
        cfg = self.cfg
        shape = (sites, batch, ms.heads(cfg)[1], max_len, cfg.head_dim)
        dtype = dtype or cfg.act_dtype
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def _hybrid_prefill(self, params: Params, x, cos, sin, cache: Params,
                        max_len: int):
        """The hybrid's prefill: every mamba layer's state into
        ``cache["ssm"]`` (groups' layers then the tail's, in order) and,
        when there are groups, the shared block's K/V at each site into
        ``cache["k"]`` / ``cache["v"]`` (ngroups, B, hk, max_len, hd), as
        the JAX package does.  Returns the residual stream."""
        cfg = self.cfg
        S = x.shape[1]
        states = []
        groups = params.get("groups", [])
        if groups:
            cache["k"], cache["v"] = self._kv_cache(len(groups), x.shape[0],
                                                    max_len, x.device)
        for g, group in enumerate(groups):
            for lp in group:
                x, st = tf.mamba_block_state(x, lp, cfg)
                states.append(st)
            x, (k, v) = tf.dense_block_kv(x, params["shared_attn"], cfg, cos,
                                          sin)
            cache["k"][g, :, :, :S] = k
            cache["v"][g, :, :, :S] = v
        for lp in params.get("tail", []):
            x, st = tf.mamba_block_state(x, lp, cfg)
            states.append(st)
        cache["ssm"] = _stack_states(states)
        return x

    # ------------------------------------------------------------------
    # decode (the fixed engine)
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None, *,
                   device=None) -> Params:
        """An empty fixed-size cache on ``device`` (the card by default):
        K/V for the attention families, the SSM states for the SSM family,
        both for the hybrid (K/V for max(ngroups, 1) sites)."""
        self._check_family()
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = dtype or cfg.act_dtype
        cache: Params = {"cur_len": 0}
        if cfg.has_ssm:
            cache["ssm"] = _stack_states(
                [ssm_mod.mamba2_state_init(cfg, batch, dtype, device=dev)
                 for _ in range(cfg.num_layers)])
        if cfg.family == "hybrid":
            sites = max(self._hybrid_split()[0], 1)
        elif cfg.family != "ssm":
            sites = cfg.num_layers
        else:
            return cache
        cache["k"], cache["v"] = self._kv_cache(sites, batch, max_len, dev,
                                                dtype)
        return cache

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor):
        """tokens (B, 1) -> logits (B, V); writes the token's K/V (and the
        SSM layers' new states) into the cache in place and returns the
        cache with ``cur_len`` advanced."""
        self._check_family()
        cfg = self.cfg
        B = tokens.shape[0]
        cur = int(cache["cur_len"])
        x = self._embed(params, tokens, prompt=False)
        cos = sin = None
        if cfg.has_attention:
            cos, sin = self._step_rope(B, cur, x.device)
        if cfg.family == "ssm":
            x = self._ssm_decode_stack(params["layers"], x, cache["ssm"], 0)
        elif cfg.family == "hybrid":
            x = self._hybrid_decode(params, x, cache, cur, cos, sin)
        else:
            for i, lp in enumerate(params["layers"]):
                a, _, _ = attn_mod.attention_decode(
                    rms_norm(x, lp["attn_norm"]), lp["attn"], cfg,
                    cache["k"][i], cache["v"][i], cur, cos, sin)
                x = self._step_ffn(x + a, lp)
        x = rms_norm(x, params["final_norm"])
        logits = self._logits(params, x)[:, 0, :]
        return logits, dict(cache, cur_len=cur + 1)

    def _ssm_decode_stack(self, layers: list, x, states: dict, first: int):
        """One token through mamba layers ``layers``, whose states are
        layers ``first``, ``first + 1``, ... of the stacked ``states``
        (updated in place)."""
        cfg = self.cfg
        for i, lp in enumerate(layers, start=first):
            y, st = ssm_mod.mamba2_decode(
                rms_norm(x, lp["norm"]), lp["mamba"], cfg,
                {"conv": states["conv"][i], "ssm": states["ssm"][i]})
            states["conv"][i].copy_(st["conv"])
            states["ssm"][i].copy_(st["ssm"])
            x = x + y
        return x

    def _hybrid_decode(self, params: Params, x, cache: Params, cur: int,
                       cos, sin):
        """One token through the groups (mamba layers, then the shared
        block against its site's K/V) and the tail, in place."""
        cfg = self.cfg
        shared = params["shared_attn"]
        first = 0
        for g, group in enumerate(params.get("groups", [])):
            x = self._ssm_decode_stack(group, x, cache["ssm"], first)
            first += len(group)
            a, _, _ = attn_mod.attention_decode(
                rms_norm(x, shared["attn_norm"]), shared["attn"], cfg,
                cache["k"][g], cache["v"][g], cur, cos, sin)
            x = x + a
            x = x + mlp(rms_norm(x, shared["mlp_norm"]), shared["mlp"],
                        cfg.mlp_kind)
        return self._ssm_decode_stack(params.get("tail", []), x,
                                      cache["ssm"], first)

    # ------------------------------------------------------------------
    # paged decode + chunked prefill (the continuous-batching serve tier)
    # ------------------------------------------------------------------
    def _check_paged(self) -> None:
        """Paged serving takes the dense and MoE families (the others keep
        recurrent state or need a frontend), as in the JAX package."""
        cfg = self.cfg
        self._check_family()
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"paged serving supports dense/moe families, "
                             f"not {cfg.family!r}")
        if cfg.m_rope or cfg.frontend is not None:
            raise ValueError("paged serving does not take frontend/m-rope "
                             "configs")
        if cfg.attn_window:
            raise ValueError("paged serving does not express attn_window "
                             "masks")

    def _step_ffn(self, h, lp):
        """The FFN half of a layer in the decode steps and chunked prefill,
        on the residual ``h``: the MLP, or the MoE at
        :data:`DECODE_CAPACITY_FACTOR` (every row routed, padding and
        inactive slots too)."""
        cfg = self.cfg
        if cfg.family == "moe":
            return h + tf.moe_ffn(h, lp, cfg, DECODE_CAPACITY_FACTOR)[0]
        return h + mlp(rms_norm(h, lp["mlp_norm"]), lp["mlp"], cfg.mlp_kind)

    def _paged_block(self, cfg, attn_fn):
        """The per-layer body shared by paged decode and chunked prefill:
        attention through ``attn_fn`` (which writes the page pools), then
        the family's FFN."""
        def body(h, lp, kp_l, vp_l):
            a, _, _ = attn_fn(rms_norm(h, lp["attn_norm"]), lp, kp_l, vp_l)
            return self._step_ffn(h + a, lp)
        return body

    def decode_step_paged(self, params: Params, state: Params,
                          tokens: torch.Tensor, active: torch.Tensor):
        """One continuous-batching decode step over the paged KV cache.

        ``tokens`` (B, 1) int; ``active`` (B,) int, 0 freezes a slot (its
        write goes to the trash page, its length does not advance, its
        logits are garbage the engine ignores).  Writes the pools and
        advances ``state["lens"]`` in place; every input keeps its shape
        and buffer, so admission only rewrites ``table`` / ``lens``
        contents."""
        self._check_paged()
        cfg = self.cfg
        lens = state["lens"]
        active = active.to(torch.int32)
        x = self._embed(params, tokens, prompt=False)
        cos, sin = rope(lens[:, None], cfg.head_dim, cfg.rope_theta)

        table = state["table"]
        ps = state["kpages"].shape[3]
        n = table.shape[1]
        tpos = (lens // ps).clamp(0, n - 1).long()
        write_page = table.gather(1, tpos[:, None])[:, 0]
        write_page = torch.where(active > 0, write_page, 0)
        write_off = torch.where(active > 0, lens % ps, 0)

        def attn_fn(hn, lp, kp_l, vp_l):
            return attn_mod.attention_decode_paged(
                hn, lp["attn"], cfg, kp_l, vp_l, table, lens, write_page,
                write_off, active, cos, sin)

        body = self._paged_block(cfg, attn_fn)
        h = x
        for i, lp in enumerate(params["layers"]):
            h = body(h, lp, state["kpages"][i], state["vpages"][i])
        h = rms_norm(h, params["final_norm"])
        logits = self._logits(params, h)[:, 0, :]
        lens.add_(active)
        return logits, state

    def prefill_chunk(self, params: Params, state: Params,
                      chunk: torch.Tensor, slot: int, start: int,
                      valid_len: int):
        """Prefill one chunk (C,) of one slot's prompt into the paged cache
        (pad past ``valid_len`` arbitrary).  Returns (logits (V,) at the
        chunk's last valid position, state) with ``lens[slot] = start +
        valid_len``, written in place."""
        self._check_paged()
        cfg = self.cfg
        C = chunk.shape[0]
        x = self._embed(params, chunk[None], prompt=False)
        dev = x.device
        gpos = start + torch.arange(C, dtype=torch.int32, device=dev)
        cos, sin = rope(gpos[None], cfg.head_dim, cfg.rope_theta)

        table = state["table"]
        ps = state["kpages"].shape[3]
        n = table.shape[1]
        table_row = table[slot]
        tpos = (gpos // ps).clamp(0, n - 1).long()
        valid = torch.arange(C, device=dev) < valid_len
        page_idx = torch.where(valid, table_row[tpos], 0)
        write_off = torch.where(valid, gpos % ps, 0)

        def attn_fn(hn, lp, kp_l, vp_l):
            return attn_mod.attention_chunk(
                hn, lp["attn"], cfg, kp_l, vp_l, table_row, start, page_idx,
                write_off, cos, sin)

        body = self._paged_block(cfg, attn_fn)
        h = x
        for i, lp in enumerate(params["layers"]):
            h = body(h, lp, state["kpages"][i], state["vpages"][i])
        h = rms_norm(h, params["final_norm"])
        logits = self._logits(params, h[:, valid_len - 1:valid_len])[0, 0]
        state["lens"][slot] = start + valid_len
        return logits, state


def _stack_states(states: list[dict]) -> dict:
    """Per-layer ``{conv, ssm}`` states stacked along a leading layer dim
    (the JAX package's cache layout)."""
    return {k: torch.stack([st[k] for st in states]) for k in ("conv", "ssm")}
