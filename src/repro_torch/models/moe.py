"""Mixture-of-Experts layer: top-k routing and capacity-based dispatch
(counterpart of ``repro.models.moe``, chip scope; qwen3-moe 128 experts
top-8, arctic 128 experts top-2 beside a dense residual MLP).

The dispatch is the JAX package's, step for step:

  1. router: logits (T, E) in f32 -> softmax -> top-k (lower expert index
     first among equal probabilities, as ``jax.lax.top_k``), the k weights
     renormalised;
  2. position in expert: an exclusive cumulative sum of the (T, E)
     assignment over the tokens in their order, per group;
  3. scatter the tokens into a padded (G, E, C + 1, d) buffer, capacity
     ``C = max(1, round(t * k / E * capacity_factor))`` (Python's round,
     half to even); a slot at or past C is dropped: it goes to the dustbin
     row C, which is sliced away, and its gate weight becomes 0 (the others
     are not renormalised);
  4. the experts' SwiGLU products, batched over (G, E), in x's dtype
     (cuBLAS on the card: the JAX package computes them as ``einsum`` s
     outside any Pallas kernel);
  5. gather each slot's output back and sum the k slots by gate weight.

Every tensor op is a gather, a scatter without accumulation or a sort: no
atomics, so two runs on the card give the same bits.  Only the dustbin row
may receive more than one token.  ``groups`` is 1 by default (the JAX
package's default without a mesh).  At mesh scope the JAX package takes as
many groups as the data width, each group one data shard's tokens with its
own capacity; the port's mesh trainer gives each rank its own rows
(``distributed.sharding.sharded_rows``), so a rank's one group is the
reference's group of that shard.  The load-balancing loss there is a
product of global means: inside ``sharded_rows`` the expert load is
averaged over the ranks (an all-reduce, no gradient), and the importance
stays this rank's, which the trainer's sum over the ranks makes global.

Aux losses: the load-balancing loss ``sum(load * importance) * E`` and the
router z-loss ``mean(logsumexp(logits) ** 2)``, returned for the caller to
weight.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.layers import dense_init

Params = dict[str, Any]

__all__ = ["moe_init", "moe_apply", "record_routing", "ROUTER_DTYPE"]

#: The router's dtype whatever ``cfg.param_dtype`` is: the JAX package
#: keeps it in f32 and routes in f32.  ``interop.carry_params`` keeps a
#: carried router (every ``["moe"]["router"]`` leaf) in it too.
ROUTER_DTYPE = torch.float32

_records: Optional[list] = None


@contextlib.contextmanager
def record_routing():
    """Collect the expert choices of every :func:`moe_apply` call made in
    the block: yields a list that gains, per call, the (G, t, k) int64
    expert indices of the top-k (before capacity drops), in call order.  A
    debugging hook; the computation is unchanged."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


def moe_init(gen: torch.Generator, cfg) -> Params:
    """Router (d, E) in :data:`ROUTER_DTYPE`, then the experts' wi_gate and
    wi_up (E, d, f) and wo (E, f, d) in ``cfg.pdtype``, drawn in that order
    from ``gen``.  As in the JAX package, ``dense_init`` takes the fan-in
    of a 3-D leaf from its first dim (E)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        "router": dense_init(gen, (d, e), dtype=ROUTER_DTYPE),
        "wi_gate": dense_init(gen, (e, d, f), dtype=cfg.pdtype),
        "wi_up": dense_init(gen, (e, d, f), dtype=cfg.pdtype),
        "wo": dense_init(gen, (e, f, d), dtype=cfg.pdtype),
    }


def _top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last dim and their indices, the lower
    index first among equal values (``jax.lax.top_k`` 's order; a stable
    descending sort keeps it, ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(t: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots per expert and group: ``max(1, round(t * k / e * cf))`` with
    Python's round (half to even, so 2.5 gives 2), on the host."""
    return int(max(1, round(t * k / e * capacity_factor)))


def moe_apply(x: torch.Tensor, p: Params, cfg, *,
              capacity_factor: float = 1.25, groups: int = 1
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x: (B, L, d) -> (B, L, d), aux losses ``{"aux_lb", "aux_z"}`` (f32
    scalars).  The B * L tokens are cut into ``groups`` groups of equal
    size, each dispatched into its own (E, C, d) slab."""
    B, L, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * L
    G = groups
    t = T // G
    assert t * G == T, (T, G)
    xt = x.reshape(G, t, d)

    # router (f32)
    logits = torch.matmul(xt.float(), p["router"].float())   # (G, t, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = _top_k(probs, k)                          # (G, t, k)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    if _records is not None:
        _records.append(gate_i.detach())

    # aux: load balance and z-loss (means over every token)
    assign = torch.zeros((G, t, E), dtype=torch.int64,
                         device=x.device).scatter_(2, gate_i, 1)  # (G, t, E)
    load = assign.float().mean(dim=(0, 1)) / k
    rows = sharding.rows_plan()
    if rows is not None and rows.width > 1:    # the global mean over ranks
        load = rows.psum_all(load) / rows.width
    importance = probs.mean(dim=(0, 1))
    aux_lb = torch.sum(load * importance) * E
    aux_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # position in expert: exclusive cumulative sum over the tokens
    cum = torch.cumsum(assign, dim=1) - assign
    pos = torch.gather(cum, 2, gate_i)                         # (G, t, k)

    C = capacity(t, k, E, capacity_factor)
    keep = pos < C
    gate_w = gate_w * keep
    pos_c = torch.where(keep, pos, C)                          # dustbin row

    # dispatch: scatter into (G, E, C + 1, d) rows, then drop the dustbin
    dev = x.device
    g_idx = torch.arange(G, device=dev)[:, None, None]
    slot = ((g_idx * E + gate_i) * (C + 1) + pos_c).reshape(-1)
    buf = torch.zeros((G * E * (C + 1), d), dtype=x.dtype, device=dev)
    tok = torch.arange(t, device=dev).repeat_interleave(k)
    buf[slot] = xt[:, tok].reshape(-1, d)
    buf = buf.view(G, E, C + 1, d)[:, :, :C]

    # expert compute, batched over (G, E)
    wg = p["wi_gate"].to(x.dtype)
    wu = p["wi_up"].to(x.dtype)
    wo = p["wo"].to(x.dtype)
    gate = torch.einsum("gecd,edf->gecf", buf, wg)
    up = torch.einsum("gecd,edf->gecf", buf, wu)
    act = F.silu(gate.float()).to(x.dtype) * up
    out_buf = torch.einsum("gecf,efd->gecd", act, wo)          # (G, E, C, d)

    # combine: gather each slot back (the dustbin reads a zero row) and sum
    # the k slots by gate weight, in x's dtype
    out_buf = F.pad(out_buf, (0, 0, 0, 1)).reshape(-1, d)
    gathered = out_buf[slot].view(G, t, k, d)
    y = torch.sum(gathered * gate_w[..., None].to(x.dtype), dim=2)
    return y.reshape(B, L, d), {"aux_lb": aux_lb, "aux_z": aux_z}
