"""Parameter partition rules: one place that decides how every weight leaf of
every assigned architecture shards over the (pod, data, model) mesh
(counterpart of ``repro.distributed.partition``).

Rules are path-based (a leaf is addressed by its key path, e.g.
``layers/3/attn/wq``).  This is the Megatron 1D-TP pattern expressed as
data, not code:

    column-parallel up-projections  (d, f)      -> P(None, 'model')
    row-parallel down-projections   (f, d)      -> P('model', None)
    embeddings                      (V, d)      -> P('model', None)   (vocab)
    unembed                         (d, V)      -> P(None, 'model')
    MoE expert banks                (E, d, f)   -> P('model', ...)    (EP)
    norms / scalars                             -> replicated

The port keeps a model's layers as a list of per-layer dicts (the hybrid's
``groups`` as a list of such lists), where the JAX package stacks each
layer leaf along one (two) leading dims; so a port leaf
``layers/<i>/attn/wq`` takes the rule as it is, without the stacking
entries the reference prepends.  The checkpointer writes stacked leaves,
so its manifest takes the stacked specs: ``stacked=True`` gives them, in a
tree whose layer lists are collapsed into one dict of stacked leaves, and
their strings equal the reference's (``str(spec)``), ``zero1_specs``'s
choice of the stacking dim included.

Optimizer state (AdamW mu/nu) mirrors the parameter specs leaf for leaf;
:func:`zero1_specs` adds the data axes to the largest still-replicated dim
that they divide.  A mesh here is anything with ``mesh_dim_names`` and
``shape`` (a ``DeviceMesh``, a ``LocalMesh``).
"""
from __future__ import annotations

import re
from typing import Any

from repro_torch.core.sharding import NamedSharding, PartitionSpec as P
from repro_torch.core.topology import topology_of

__all__ = ["param_specs", "param_shardings", "batch_spec", "data_axes",
           "zero1_specs", "fsdp_specs", "map_specs", "model_dims",
           "kv_split_at_rest", "RULES"]

Pytree = Any

# (path regex, spec entries *without* the stacking dim). The first match wins.
# Spec entries name logical axes; 'model' resolves to the mesh's model axis,
# None replicates. Entries are per-dim of the unstacked leaf.
RULES: list[tuple[str, tuple]] = [
    # --- embeddings ---------------------------------------------------------
    (r"^embed$",                      ("model", None)),      # (V, d) vocab-sharded
    (r"^unembed$",                    (None, "model")),      # (d, V)
    (r"^final_norm/",                 ()),                   # replicate
    # --- attention ----------------------------------------------------------
    (r"/attn/wq$",                    (None, "model")),
    (r"/attn/wk$",                    (None, "model")),
    (r"/attn/wv$",                    (None, "model")),
    (r"/attn/wo$",                    ("model", None)),
    (r"/attn/(q|k)_norm/",            ()),
    # --- dense MLP (incl. arctic dense_residual) ----------------------------
    (r"/(mlp|dense_mlp)/wi_gate$",    (None, "model")),
    (r"/(mlp|dense_mlp)/wi_up$",      (None, "model")),
    (r"/(mlp|dense_mlp)/wo$",         ("model", None)),
    # --- MoE ----------------------------------------------------------------
    (r"/moe/router$",                 (None, "model")),      # (d, E) over E
    (r"/moe/wi_gate$",                ("model", None, None)),  # (E, d, f) EP
    (r"/moe/wi_up$",                  ("model", None, None)),
    (r"/moe/wo$",                     ("model", None, None)),
    # --- Mamba2 --------------------------------------------------------------
    (r"/mamba/in_proj$",              (None, "model")),
    (r"/mamba/out_proj$",             ("model", None)),
    (r"/mamba/conv_w$",               (None, "model")),
    (r"/mamba/conv_b$",               ("model",)),
    (r"/mamba/(A_log|D|dt_bias)$",    ()),                   # (H,) tiny, replicate
    (r"/mamba/norm/",                 ()),
    # --- norms anywhere -------------------------------------------------------
    (r"norm/",                        ()),
    (r"norm$",                        ()),
]

# Shard a weight dim over the 16-way model axis only if each shard keeps at
# least one full lane (128).  Below that, sharding trades a tiny memory win
# for per-op collectives (gemma's MQA wk/wv, 2048 -> 256).
MODEL_AXIS_WIDTH = 16
LANE = 128


def kv_split_at_rest(out_dim: int) -> bool:
    """Whether the spec splits an attention ``wk`` / ``wv`` of ``out_dim``
    output columns over ``model``: only where a shard of the 16-way axis
    keeps a whole lane (the lane floor)."""
    return out_dim >= LANE * MODEL_AXIS_WIDTH


def _spec_for_path(path_s: str, shape: tuple[int, ...], n_stack: int,
                   replicate_attn: bool = False) -> P:
    ndim = len(shape)
    for pat, entries in RULES:
        if re.search(pat, path_s):
            entries = (None,) * n_stack + tuple(entries)
            # pad/truncate defensively to the leaf rank
            entries = entries[:ndim] + (None,) * max(0, ndim - len(entries))
            if replicate_attn and re.search(r"/attn/w[qkvo]$", path_s):
                entries = (None,) * ndim
            # lane floor: replicate KV projections whose sharded dim would
            # fall under one lane per shard (MQA/GQA with few kv heads)
            elif re.search(r"/attn/w[kv]$", path_s):
                if not kv_split_at_rest(shape[-1]):
                    entries = entries[:-1] + (None,)
            return P(*entries)
    # default: replicate
    return P(*((None,) * ndim))


def _replicate_attention(cfg) -> bool:
    """Replicate the WHOLE attention block when (a) heads don't divide the
    model axis (sub-head sharding forces per-attention collectives) and
    (b) total attention params stay small (< 2 GiB a device replicated).
    gemma-2b (8 heads), minicpm (36), musicgen (24): yes.  arctic (56
    heads but 9+ GiB of attention): no, it keeps flat-dim sharding."""
    if cfg is None or not getattr(cfg, "num_heads", 0):
        return False
    if cfg.num_heads % MODEL_AXIS_WIDTH == 0:
        return False
    d, h, hd, hk = (cfg.d_model, cfg.num_heads, cfg.head_dim,
                    cfg.num_kv_heads)
    per_layer = (h * hd + 2 * hk * hd) * d + h * hd * d
    n_attn_layers = (cfg.num_layers if cfg.family != "hybrid" else 1)
    return per_layer * n_attn_layers * 2 < 2 * (1 << 30)


def _is_layer_list(x) -> bool:
    """A non-empty list of per-layer dicts, or of such lists."""
    return isinstance(x, list) and bool(x) and (
        all(isinstance(e, dict) for e in x)
        or all(_is_layer_list(e) for e in x))


def _stack_shape(x) -> tuple[int, ...]:
    """The stacked shape of a layer list's leaf entry (a nested list of the
    layers' leaves)."""
    if isinstance(x, list):
        return (len(x),) + _stack_shape(x[0])
    return tuple(x.shape)


def _collapse(tree):
    """A layer list as one dict of nested lists of its layers' leaves (the
    checkpointer's stacking), recursively; other nodes unchanged."""
    if _is_layer_list(tree):
        layers = [_collapse(x) for x in tree]
        return _zip_layers(layers)
    if isinstance(tree, dict):
        return {k: _collapse(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_collapse(getattr(tree, f))
                            for f in tree._fields))
    return tree


def _zip_layers(layers: list):
    """Per-layer dicts -> one dict whose leaves list the layers' leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _zip_layers([lay[k] for lay in layers]) for k in first}
    return _Stacked(layers)


class _Stacked(list):
    """A stacked leaf: the layers' leaves (or nested lists of them)."""


def _map(fn, tree, path: str, stacked: bool):
    """``fn(path, shape)`` over the leaves of a parameter tree, the path
    '/'-joined (list indices included unless ``stacked``)."""
    if tree is None:
        return None
    if stacked and isinstance(tree, _Stacked):
        shape = _stack_shape(tree)
        depth, x = 0, tree
        while isinstance(x, list):
            depth, x = depth + 1, x[0]
        return fn(path, shape, depth)
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}" if path else str(k), stacked)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f),
                                 f"{path}/{f}" if path else f, stacked)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, f"{path}/{i}" if path else str(i),
                               stacked) for i, x in enumerate(tree))
    return fn(path, tuple(tree.shape), 0)


def param_specs(params: Pytree, cfg=None, *, stacked: bool = False
                ) -> Pytree:
    """PartitionSpec tree matching ``params`` (tensors, meta tensors or
    anything with ``.shape``).  ``cfg`` (optional ModelConfig) enables the
    shape-aware head heuristic.  ``stacked``: the checkpointer's view, the
    layer lists collapsed into dicts of stacked leaves (module
    docstring)."""
    rep_attn = _replicate_attention(cfg)
    tree = _collapse(params) if stacked else params
    return _map(lambda path, shape, n_stack: _spec_for_path(
        path, shape, n_stack, rep_attn), tree, "", stacked)


def fsdp_specs(params: Pytree, mesh, cfg=None, *, stacked: bool = False
               ) -> Pytree:
    """ZeRO-3/FSDP: the parameters themselves sharded as
    :func:`zero1_specs` shards the moments (the reference's rule; no trainer
    of the port takes it)."""
    return zero1_specs(params, mesh, cfg, stacked=stacked)


def param_shardings(mesh, params: Pytree) -> Pytree:
    """NamedSharding tree for ``params`` on ``mesh``."""
    return map_specs(lambda s: NamedSharding(mesh, s), param_specs(params))


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _data_width(mesh) -> int:
    topo = topology_of(mesh)
    w = 1
    for a in data_axes(mesh):
        w *= topo.size(a)
    return w


def zero1_specs(params: Pytree, mesh, cfg=None, *, stacked: bool = False
                ) -> Pytree:
    """ZeRO-1: optimizer-moment specs = param specs with the largest still-
    replicated dim that the data axes' width divides additionally sharded
    over the data axes (pod x data, pod-major).  Gradients reduce-scatter
    onto this sharding, each data shard updates its slice, and the
    parameters are all-gathered after the update: moments drop from
    replicated to 1/(pod*data)."""
    daxes = data_axes(mesh)
    width = _data_width(mesh)
    dentry = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    rep_attn = _replicate_attention(cfg)

    def spec(path, shape, n_stack):
        base = _spec_for_path(path, shape, n_stack, rep_attn)
        if width <= 1:
            return base
        entries = list(base) + [None] * (len(shape) - len(base))
        best = None
        for i, (e, d) in enumerate(zip(entries, shape)):
            if e is None and d % width == 0:
                if best is None or d > shape[best]:
                    best = i
        if best is not None:
            entries[best] = dentry
        return P(*entries)

    tree = _collapse(params) if stacked else params
    return _map(spec, tree, "", stacked)


def batch_spec(mesh, extra_dims: int = 1) -> P:
    """P over the batch dim (pod+data axes) plus ``extra_dims`` replicated."""
    axes = data_axes(mesh)
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)
    return P(lead, *(None,) * extra_dims)


def map_specs(fn, specs):
    """``fn`` over the PartitionSpec leaves of a spec tree (a spec is a
    tuple, so the generic tree walkers would descend into it)."""
    if specs is None or isinstance(specs, P):
        return None if specs is None else fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, getattr(specs, f))
                             for f in specs._fields))
    return type(specs)(map_specs(fn, x) for x in specs)


def model_dims(specs: Pytree) -> Pytree:
    """Per leaf of a spec tree, the dim its spec splits over ``model``, or
    None where the spec replicates it over ``model``."""
    def dim(spec):
        for i, e in enumerate(spec):
            names = e if isinstance(e, tuple) else (e,)
            if "model" in names:
                return i
        return None
    return map_specs(dim, specs)
