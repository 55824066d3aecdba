"""LM: the architecture facade for serving, dense family (counterpart of
``repro.models.lm``, chip scope).

    init               seeded random weights on the card (or the CPU)
    forward            full-sequence logits (through ``stack_apply``, with
                       remat when ``cfg.remat``)
    loss               token-mean cross entropy of a batch (training)
    prefill            prompt -> last logits + a fixed-size K/V cache
    decode_step        one token against that cache (the fixed engine)
    decode_step_paged  one token per slot against the paged cache
    prefill_chunk      one prompt chunk of one slot into the paged cache

Parameters mirror the JAX package's pytree as dicts of tensors, except
that its layer-stacked leaves become a list of per-layer dicts
(``params["layers"]``).  Caches keep the JAX layouts: the fixed cache is
(layers, B, kv_heads, max_len, head_dim); the paged state is ``kpages`` /
``vpages`` (layers, P, kv_heads, page_size, head_dim), ``table`` (B, n)
int32 and ``lens`` (B,) int32.  Decode steps update caches in place (the
JAX package returns updated copies) and return the same tensors.

The other families (moe, ssm, hybrid, vlm, audio) raise NotImplementedError
until their slices port them (ROADMAP queue 1 items 5-7).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.containers import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (dense_init, linear, mlp, rms_norm,
                                       rms_norm_init, rope)

Params = dict[str, Any]

__all__ = ["LM", "cross_entropy_loss"]


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


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def _check_family(self) -> None:
        cfg = self.cfg
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(ROADMAP queue 1 items 5-7 port the other families)")

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, seed: int = 0, *, device=None) -> Params:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        made on ``device`` (the card unless the caller names another)."""
        self._check_family()
        cfg = self.cfg
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        p: Params = {
            "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                scale=cfg.d_model ** -0.5, dtype=cfg.pdtype),
            "final_norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                      dtype=cfg.pdtype)
        p["layers"] = tf.stack_init(gen, cfg, tf.dense_block_init,
                                    cfg.num_layers)
        return p

    # ------------------------------------------------------------------
    # embedding / positions
    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        # F.embedding: its backward adds the rows' gradients in a fixed
        # order on the card (a sort, then segment sums), so training steps
        # give the same bits from run to run
        x = F.embedding(tokens.long(), params["embed"]).to(cfg.act_dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.act_dtype,
                                 device=x.device)
        return x

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Unembed (tied or not), slice off vocab padding, softcap."""
        cfg = self.cfg
        w_out = params.get("unembed")
        if w_out is None:
            w_out = params["embed"].t()
        logits = linear(x, w_out)
        if cfg.padded_vocab != cfg.vocab_size:
            logits = logits[..., :cfg.vocab_size]
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits.float() / c) * c
        return logits

    def _rope_tables(self, batch: int, seq_len: int, device):
        positions = torch.arange(seq_len, dtype=torch.int32,
                                 device=device).expand(batch, seq_len)
        return rope(positions, self.cfg.head_dim, self.cfg.rope_theta)

    # ------------------------------------------------------------------
    # full-sequence forward and prefill
    # ------------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor):
        """Full-sequence forward -> (logits (B, S, V), aux)."""
        self._check_family()
        x = self._embed(params, tokens)
        B, S, _ = x.shape
        cos, sin = self._rope_tables(B, S, x.device)
        x = tf.stack_apply(x, params["layers"], functools.partial(
            tf.dense_block, cfg=self.cfg, cos=cos, sin=sin), self.cfg)
        x = rms_norm(x, params["final_norm"])
        aux = {"aux_lb": torch.zeros((), device=x.device),
               "aux_z": torch.zeros((), device=x.device)}
        return self._logits(params, x), aux

    def loss(self, params: Params, batch: dict):
        """``(loss, metrics)`` of a batch ``{"tokens", "labels"}`` (B, S)
        int (tensors, or host arrays moved to the parameters' device):
        token-mean cross entropy of the next-token logits, in f32."""
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        logits, _ = self.forward(params, tokens)
        loss, n = cross_entropy_loss(logits, labels)
        return loss, {"loss": loss, "tokens": n}

    def prefill(self, params: Params, tokens: torch.Tensor,
                max_len: Optional[int] = None):
        """Process the prompt; returns (last-position logits (B, V), cache)
        with the K/V cache padded to ``max_len`` positions."""
        self._check_family()
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S, _ = x.shape
        max_len = max(max_len or S, S)
        cos, sin = self._rope_tables(B, S, x.device)
        shape = (cfg.num_layers, B, cfg.num_kv_heads, max_len, cfg.head_dim)
        ck = torch.zeros(shape, dtype=cfg.act_dtype, device=x.device)
        cv = torch.zeros(shape, dtype=cfg.act_dtype, device=x.device)
        for i, lp in enumerate(params["layers"]):
            x, (k, v) = tf.dense_block_kv(x, lp, cfg, cos, sin)
            ck[i, :, :, :S] = k
            cv[i, :, :, :S] = v
        x = rms_norm(x, params["final_norm"])
        logits = self._logits(params, x[:, -1:, :])[:, 0, :]
        return logits, {"cur_len": S, "k": ck, "v": cv}

    # ------------------------------------------------------------------
    # decode (the fixed engine)
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None, *,
                   device=None) -> Params:
        """An empty fixed-size cache on ``device`` (the card by default)."""
        self._check_family()
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                 cfg.head_dim)
        dev = resolve_device(device)
        dtype = dtype or cfg.act_dtype
        return {"cur_len": 0,
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor):
        """tokens (B, 1) -> logits (B, V); writes the token's K/V into the
        cache in place and returns the cache with ``cur_len`` advanced."""
        self._check_family()
        cfg = self.cfg
        B = tokens.shape[0]
        cur = int(cache["cur_len"])
        x = self._embed(params, tokens)
        pos = torch.full((B, 1), cur, dtype=torch.int32, device=x.device)
        cos, sin = rope(pos, cfg.head_dim, cfg.rope_theta)
        for i, lp in enumerate(params["layers"]):
            a, _, _ = attn_mod.attention_decode(
                rms_norm(x, lp["attn_norm"]), lp["attn"], cfg,
                cache["k"][i], cache["v"][i], cur, cos, sin)
            x = x + a
            x = x + mlp(rms_norm(x, lp["mlp_norm"]), lp["mlp"], cfg.mlp_kind)
        x = rms_norm(x, params["final_norm"])
        logits = self._logits(params, x)[:, 0, :]
        return logits, dict(cache, cur_len=cur + 1)

    # ------------------------------------------------------------------
    # paged decode + chunked prefill (the continuous-batching serve tier)
    # ------------------------------------------------------------------
    def _check_paged(self) -> None:
        cfg = self.cfg
        if cfg.attn_window:
            raise ValueError("paged serving does not express attn_window "
                             "masks")
        self._check_family()

    def _paged_block(self, cfg, attn_fn):
        """The per-layer body shared by paged decode and chunked prefill:
        attention through ``attn_fn`` (which writes the page pools), then
        the MLP."""
        def body(h, lp, kp_l, vp_l):
            a, _, _ = attn_fn(rms_norm(h, lp["attn_norm"]), lp, kp_l, vp_l)
            h = h + a
            return h + mlp(rms_norm(h, lp["mlp_norm"]), lp["mlp"],
                           cfg.mlp_kind)
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
        x = self._embed(params, tokens)
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
        x = self._embed(params, chunk[None])
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
