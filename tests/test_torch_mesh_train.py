"""The port's training at mesh scope over the data axes (ring attention's
backward, ``Trainer(mesh=...)`` with ZeRO-1 moments, ``compressed_psum``,
checkpoint specs and the elastic re-mesh, heartbeats across ranks) against
the JAX package's on the same numpy inputs.

The port runs on 8 gloo ranks of one spawned world (one per test module),
on the meshes (data 8), (pod 2, data 4), (data 4) over the first four
ranks, and (data 4, model 2); the JAX side runs the same calls on the 8
forced host devices while the world runs.  Both sides start from the
port's seeded parameters: the ranks draw them, the JAX side gets them
restacked (no JAX init).  A spawned rank imports this module by name, so
it imports no JAX at top level.

Bars: the JAX suites' f32 tolerance, 1e-5, on losses and ring gradients;
the int8 exchange within one quantisation step per participant
(tests/test_compress.py's bound); parameters, every rank's, bitwise.
"""
import os
import re

import numpy as np
import pytest
import torch

WORLD = 8
#: ``reduce_config(qwen3-1.7b, 0.05, seq_len=64)``, a global batch of 8.
SCALE, SEQ, BATCH, STEPS = 0.05, 64, 8, 3
#: tests/test_models.py's ``tiny("moe")``, at capacity factor 1 (its own
#: 4.0 never drops a token), so that every dispatch group drops tokens.
TINY_MOE = dict(name="tiny-moe", family="moe", num_layers=2, d_model=32,
                vocab_size=64, dtype="float32", param_dtype="float32",
                remat=False, num_heads=4, num_kv_heads=2, head_dim=8,
                d_ff=0, num_experts=4, experts_per_token=2, moe_d_ff=32,
                capacity_factor=4.0)
MOE_CFS = (1.0,)
HEADS = {"gqa": (4, 2), "mqa": (4, 1), "mha": (4, 4)}
#: (heads, name, causal, order): zig-zag causal and contiguous full, over
#: GQA, MQA and MHA.
RING_CASES = (("gqa", "causal", True, "zigzag"),
              ("gqa", "full", False, "contiguous"),
              ("mqa", "causal", True, "zigzag"),
              ("mha", "full", False, "contiguous"))
TOL = dict(rtol=1e-5, atol=1e-5)


def _qwen(pkg):
    """The reduced qwen3 config of package ``pkg`` (the port's or the
    JAX package's ``configs`` and ``launch.train``)."""
    import importlib

    configs = importlib.import_module(f"{pkg}.configs")
    train = importlib.import_module(f"{pkg}.launch.train")
    return train.reduce_config(configs.get_config("qwen3-1.7b"), SCALE,
                               seq_len=SEQ)


def _moe(cls, cf):
    return cls(**{**TINY_MOE, "name": f"tiny-moe-cf{cf}",
                  "capacity_factor": cf})


def _data(cls, vocab):
    return cls(vocab_size=vocab, seq_len=SEQ, global_batch=BATCH)


def _qkv(H, HK, B=BATCH, L=64, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, L, D)).astype(np.float32)
    k = rng.standard_normal((B, HK, L, D)).astype(np.float32)
    v = rng.standard_normal((B, HK, L, D)).astype(np.float32)
    do = rng.standard_normal((B, H, L, D)).astype(np.float32)
    return q, k, v, do


def _compress_inputs():
    return np.random.default_rng(9).standard_normal((WORLD, 64)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# the port's side: one world of 8 ranks runs every case
# ---------------------------------------------------------------------------

def _digest(tree) -> str:
    import hashlib

    from repro_torch.utils.tree import tree_leaves

    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _port_cases(rank, meshes, tmp):
    """(results every rank must share bit for bit, this rank's own)."""
    import contextlib
    import shutil

    import torch.distributed as dist

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import ExecLevel, use_level
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import attention as tattn
    from repro_torch.distributed.collectives import reduce_plan
    from repro_torch.distributed.sharding import sharded_rows
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.runtime import FileHeartbeatStore, Monitor, replan
    from repro_torch.utils.tree import tree_leaves

    m8, m24, m4, m42 = meshes
    O3, O4 = ExecLevel.O3, ExecLevel.O4
    shared, own = {}, {}

    def record(where, name, fn):
        try:
            where[name] = fn()
        except Exception as e:                  # the test reads it
            where[name] = {"raised": f"{type(e).__name__}: {e}"}

    def ring_rows():
        """Each rank's row of the batch through the ring and back."""
        got = {}
        for heads, name, causal, order in RING_CASES:
            q, k, v, do = (torch.as_tensor(x[rank:rank + 1])
                           for x in _qkv(*HEADS[heads]))
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            with use_level(O3, m8), sharded_rows(reduce_plan(m8)):
                out = tattn.ring_attention(*leaves, causal=causal,
                                           order=order)
            grads = torch.autograd.grad(out, leaves, do)
            got[f"{heads} {name}"] = [out.detach().numpy()] + [
                g.numpy() for g in grads]
        return got
    record(own, "ring", ring_rows)

    def trainer_run(cfg, mesh, level, steps, **kw):
        ctx = use_level(level, mesh) if level else contextlib.nullcontext()
        with ctx:
            t = Trainer(cfg, mesh=mesh, device="cpu", **kw)
            hist = t.fit(_data(SyntheticLM, cfg.vocab_size), steps,
                         log_every=1)["history"]
        mu = t.state.opt_state.mu
        return t, {"losses": [h["loss"] for h in hist],
                   "digest": _digest(t.state.params),
                   "moment_numel": sum(x.numel() for x in tree_leaves(mu)),
                   "param_numel": sum(x.numel() for x in
                                      tree_leaves(t.state.params))}

    qcfg = _qwen("repro_torch")
    hb = os.path.join(tmp, "heartbeats")

    def qwen():
        got = {}
        store = FileHeartbeatStore(hb)
        t, got["data8"] = trainer_run(qcfg, m8, None, 4, heartbeats=store)
        dist.barrier()
        got["monitor"] = sorted((w, s.value) for w, s in
                                Monitor(store).verdicts().items())
        _, got["data8 O3"] = trainer_run(qcfg, m8, O3, STEPS)
        _, got["data8 zero1=False"] = trainer_run(qcfg, m8, None, STEPS,
                                                  zero1=False)
        _, got["O4"] = trainer_run(qcfg, m24, O4, STEPS)
        return got
    record(shared, "qwen", qwen)

    def moe():
        return {cf: trainer_run(_moe(ModelConfig, cf), m8, None, STEPS)[1]
                for cf in MOE_CFS}
    record(shared, "moe", moe)

    ck = os.path.join(tmp, "ckpt")

    def checkpoints():
        """Save at 2 on (data 8); resume there to 4 (bitwise the
        uninterrupted run); restore on (data 4) with replan's
        microbatches and go on to 4 (ranks 4-7 sit that one out)."""
        got = {}
        _, got["saved"] = trainer_run(qcfg, m8, None, 2, ckpt_dir=ck)
        if rank == 0:
            shutil.copytree(ck, ck + "-elastic")
        dist.barrier()
        _, got["resumed"] = trainer_run(qcfg, m8, None, 4, ckpt_dir=ck)
        plan = replan(4, model=1, global_batch=BATCH, per_replica_batch=1)
        got["replan"] = (plan.data, plan.microbatches)
        if rank < 4:
            t, run = trainer_run(qcfg, m4, None, 4, ckpt_dir=ck + "-elastic",
                                 microbatches=plan.microbatches)
            got["elastic"] = run["losses"]
            got["elastic_mu"] = tuple(
                t.state.opt_state.mu["layers"][0]["mlp"]["wi_up"].shape)
        dist.barrier()
        return got
    record(own, "checkpoints", checkpoints)

    def compress():
        x = torch.as_tensor(_compress_inputs()[rank])
        with use_level(O4, m24):
            return compressed_psum(x, "pod").numpy()
    record(own, "compress", compress)

    def model_axis():
        Trainer(qcfg, mesh=m42, device="cpu")
    record(shared, "model_axis", model_axis)
    return shared, own


def _port_world(rank: int, world: int, tmp: str):
    from repro_torch.launch.mesh import make_mesh

    # eight ranks share the host's cores: one thread each
    torch.set_num_threads(1)
    meshes = (make_mesh(data=world, device_type="cpu"),
              make_mesh(data=4, pod=2, device_type="cpu"),
              make_mesh(data=4, device_type="cpu"),
              make_mesh(data=4, model=2, device_type="cpu"))
    return _port_cases(rank, meshes, tmp)


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_params(cfg):
    """The port's seeded parameters of ``cfg`` (as every rank draws them),
    restacked in the JAX package's layout."""
    import jax.numpy as jnp

    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.models.lm import LM

    tree: dict = {}
    for path, leaf in ckpt_mod._paths(LM(cfg).init(0, device="cpu")):
        keys = re.findall(r"\['([^']+)'\]", path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(ckpt_mod._stack(leaf).numpy())
    return tree


def _jax_cases(tmp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs.base import ModelConfig as JCfg
    from repro.core import ExecLevel, compat, use_level
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.distributed import attention as rattn
    from repro.distributed.partition import param_specs, zero1_specs
    from repro.launch.train import Trainer as JTrainer
    from repro.optim.adamw import AdamState
    from repro.optim.compress import compressed_psum
    from repro.train import TrainState
    from repro_torch.configs.base import ModelConfig

    mesh8 = compat.make_mesh((8, 1), ("data", "model"))
    mesh24 = compat.make_mesh((2, 4, 1), ("pod", "data", "model"))
    O3, O4 = ExecLevel.O3, ExecLevel.O4
    out = {}

    for heads, name, causal, order in RING_CASES:
        q, k, v, do = (jnp.asarray(x) for x in _qkv(*HEADS[heads]))
        with use_level(O3, mesh8):
            o, vjp = jax.vjp(lambda *a: rattn.ring_attention(
                *a, causal=causal, order=order), q, k, v)
            grads = vjp(do)
        out[f"ring {heads} {name}"] = [np.asarray(o)] + [
            np.asarray(g) for g in grads]

    def run(jcfg, params, mesh, level, steps, **kw):
        data = _data(JSyntheticLM, jcfg.vocab_size)
        params = jax.tree_util.tree_map(jnp.copy, params)  # the step donates
        with (use_level(level, mesh) if level else _Null()):
            t = JTrainer(jcfg, mesh=mesh, **kw)
            t.state = TrainState(step=jnp.zeros((), jnp.int32),
                                 params=params,
                                 opt_state=t.opt.init(params))
            hist = t.fit(data, steps, log_every=1)["history"]
        return [h["loss"] for h in hist]

    qcfg = _qwen("repro")
    qp = _jax_params(_qwen("repro_torch"))
    out["qwen data8"] = run(qcfg, qp, mesh8, None, STEPS)
    out["qwen data8 O3"] = run(qcfg, qp, mesh8, O3, STEPS)
    out["qwen data8 zero1=False"] = run(qcfg, qp, mesh8, None, STEPS,
                                        zero1=False)
    out["qwen O4"] = run(qcfg, qp, mesh24, O4, STEPS)
    for cf in MOE_CFS:
        out[f"moe {cf}"] = run(_moe(JCfg, cf),
                               _jax_params(_moe(ModelConfig, cf)), mesh8,
                               None, STEPS)

    # the manifest the reference writes with its trainer's specs
    opt = JTrainer(qcfg, mesh=mesh8).opt
    state = TrainState(step=jnp.zeros((), jnp.int32), params=qp,
                       opt_state=opt.init(qp))
    m = zero1_specs(qp, mesh8)
    specs = TrainState(step=JP(), params=param_specs(qp),
                       opt_state=AdamState(count=JP(), mu=m, nu=m))
    JCheckpointer(os.path.join(tmp, "jax-ckpt")).save(2, state, specs=specs)
    out["manifest"] = _manifest(os.path.join(tmp, "jax-ckpt"), 2)

    x = jnp.asarray(_compress_inputs())
    out["compress"] = np.asarray(jax.jit(jax.shard_map(
        lambda v: compressed_psum(v, "pod"), mesh=mesh24,
        in_specs=JP(("pod", "data")), out_specs=JP(("pod", "data"))))(x))
    return out


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _manifest(directory, step):
    import json

    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(rank 0's shared results, every rank's own, the JAX package's):
    the 8-rank gloo world runs while the JAX side computes; the shared
    results must be the same bits on every rank."""
    from repro_torch.launch.world import start_world

    tmp = str(tmp_path_factory.mktemp("mesh-train"))
    world = start_world(_port_world, WORLD, args=(tmp,), timeout=240)
    try:
        jx = _jax_cases(tmp)
    finally:
        ranks = world.join()
    for r, (shared, _) in enumerate(ranks[1:], 1):
        assert _same_bits(shared, ranks[0][0]), \
            f"rank {r} differs from rank 0"
    return ranks[0][0], [own for _, own in ranks], jx, tmp


def _ok(res):
    assert not (isinstance(res, dict) and res.get("raised")), res["raised"]
    return res


# ---------------------------------------------------------------------------
# partition specs, replan, the memory count (no world)
# ---------------------------------------------------------------------------

def _config_names():
    from repro.configs import REGISTRY

    return sorted(REGISTRY)


@pytest.mark.parametrize("arch", _config_names())
def test_specs_match_reference_for_every_config(arch):
    """param_specs and zero1_specs, leaf for leaf, on abstract parameters:
    the port's stacked view equals the reference's strings, each per-layer
    leaf takes the rule without the stacking entries, and the abstract
    shapes and dtypes equal ``jax.eval_shape``'s."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.core import compat
    from repro.distributed import partition as rpart
    from repro.models.lm import LM as JLM
    from repro.optim import adamw as j_adamw
    from repro.train.state import abstract_state as j_abstract
    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.configs import get_config
    from repro_torch.core.topology import LocalMesh
    from repro_torch.distributed import partition as tpart
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw
    from repro_torch.train import abstract_state

    jcfg, cfg = j_get_config(arch), get_config(arch)
    ja = j_abstract(JLM(jcfg), j_adamw(lambda c: 1e-3))
    ta = abstract_state(LM(cfg), adamw(lambda c: 1e-3))
    jleaves = jax.tree_util.tree_flatten_with_path(ja.params)[0]
    tleaves = ckpt_mod._paths(ta.params)
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == \
        [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        shape = ()
        while isinstance(t, list):          # a layer list's stacked dims
            shape, t = shape + (len(t),), t[0]
        assert shape + tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert t.device.type == "meta"

    jmesh = compat.make_mesh((2, 4, 1), ("pod", "data", "model"))
    tmesh = LocalMesh(("pod", "data", "model"), (2, 4, 1))
    for want, got in (
            (rpart.param_specs(ja.params, jcfg),
             tpart.param_specs(ta.params, cfg, stacked=True)),
            (rpart.zero1_specs(ja.params, jmesh, jcfg),
             tpart.zero1_specs(ta.params, tmesh, cfg, stacked=True))):
        assert [str(s) for s in jax.tree_util.tree_leaves(want)] == \
            [str(s) for _, s in ckpt_mod._paths(got)]
    # per layer: the reference's spec without its stacking entries
    n_stack = {"layers": 1, "tail": 1, "groups": 2}
    flat = tpart.param_specs(ta.params, cfg)
    for path, spec in zip([p for p, _ in jleaves],
                          jax.tree_util.tree_leaves(
                              rpart.param_specs(ja.params, jcfg))):
        keys = re.findall(r"\['([^']+)'\]", jax.tree_util.keystr(path))
        node, drop = flat, n_stack.get(keys[0], 0)
        for k in keys[:1]:
            node = node[k]
        for _ in range(drop):
            node = node[0]
        for k in keys[1:]:
            node = node[k]
        assert tuple(node) == tuple(spec)[drop:], jax.tree_util.keystr(path)


@pytest.mark.parametrize("case", [(8, 1, 8, 1, 0), (6, 1, 8, 1, 0),
                                  (7, 2, 64, 4, 2), (3, 4, 16, 2, 0),
                                  (1, 1, 4, 1, 0)])
def test_replan_matches_reference(case):
    from repro.runtime.elastic import replan as j_replan
    from repro_torch.runtime import replan

    avail, model, gb, per, pods = case
    kw = dict(model=model, global_batch=gb, per_replica_batch=per, pods=pods)
    if avail < model:                   # too few survivors: both refuse
        for fn in (j_replan, replan):
            with pytest.raises(ValueError, match="cannot host"):
                fn(avail, **kw)
        return
    want, got = j_replan(avail, **kw), replan(avail, **kw)
    assert (got.pod, got.data, got.model, got.microbatches) == \
        (want.pod, want.data, want.model, want.microbatches)
    assert got.mesh_shape() == want.mesh_shape()
    assert got.axis_names() == want.axis_names()


def test_train_peak_bytes_at_data_4_by_hand():
    """qwen3-1.7b at 4 layers, 4 ranks on one card at data width 4, 2048
    positions a rank: bf16 parameters (2) and the f32 gradient (4) whole,
    the moments (8) and the update's transients (12) a quarter each."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=4)
    n, tokens = cfg.param_count(), 2048
    update = 4 * n * (2 + 4 + (8 + 12) / 4)
    act = tokens * (16 * cfg.padded_vocab + 2 * 4 * cfg.d_model)
    backward = 4 * (n * (2 + 4 + 8 / 4) + act)
    assert train.update_peak_bytes(cfg, data_width=4, ranks_per_card=4) \
        == int(update)
    assert train.train_peak_bytes(cfg, tokens, data_width=4,
                                  ranks_per_card=4) \
        == max(int(update), int(backward))
    # one rank on its own card: the chip count
    assert train.update_peak_bytes(cfg) == n * train.UPDATE_PEAK_BYTES


# ---------------------------------------------------------------------------
# ring attention's backward, rows sharded over the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,case", [c[:2] for c in RING_CASES])
def test_ring_grads_match_jax_vjp(both, heads, case):
    """Each rank's row of a batch of 8 through the ring (an all-to-all to
    the sequence shards and back): o, dq, dk and dv, the rows gathered,
    against ``jax.vjp`` of the reference's ring on mesh8."""
    _, own, jx, _ = both
    got = [np.concatenate([_ok(o["ring"])[f"{heads} {case}"][i]
                           for o in own]) for i in range(4)]
    for g, w in zip(got, jx[f"ring {heads} {case}"]):
        np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# the mesh trainer against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,shards", [("data8", WORLD),
                                        ("data8 O3", WORLD),
                                        ("O4", WORLD),
                                        ("data8 zero1=False", 1)])
def test_trainer_losses_match_reference(both, key, shards):
    shared, _, jx, _ = both
    got = _ok(shared["qwen"])[key]
    np.testing.assert_allclose(got["losses"][:STEPS], jx[f"qwen {key}"],
                               **TOL)
    # ZeRO-1: a rank holds 1/W of the moments (every dim here divides);
    # zero1=False keeps them whole
    assert got["moment_numel"] * shards == got["param_numel"]


@pytest.mark.parametrize("cf", MOE_CFS)
def test_moe_groups_match_reference(both, cf):
    """tiny("moe") at (data 8): a rank's one dispatch group over its own
    rows is the reference's group of that data shard (capacity per group;
    at capacity factor 1 every group drops tokens), and the load-balancing
    loss takes the global expert load."""
    shared, _, jx, _ = both
    np.testing.assert_allclose(_ok(shared["moe"])[cf]["losses"],
                               jx[f"moe {cf}"], **TOL)


def test_model_axis_raises_naming_10b_iii(both):
    got = both[0]["model_axis"]
    assert "queue 1 item 10b-iii" in got["raised"]


def test_heartbeats_from_every_rank_reach_the_monitor(both):
    assert _ok(both[0]["qwen"])["monitor"] == [(w, "healthy")
                                               for w in range(WORLD)]


# ---------------------------------------------------------------------------
# checkpoints: specs, resume, the elastic re-mesh
# ---------------------------------------------------------------------------

def test_manifest_specs_match_reference(both):
    _, _, jx, tmp = both
    got = _manifest(os.path.join(tmp, "ckpt"), 2)
    want = jx["manifest"]
    assert [e["path"] for e in got["leaves"]] == \
        [e["path"] for e in want["leaves"]]
    assert got["specs"] == want["specs"]
    assert got["specs"] is not None and \
        "PartitionSpec(None, 'data')" in got["specs"]


def test_resume_on_data8_is_bitwise(both):
    shared, own, _, _ = both
    got = _ok(own[0]["checkpoints"])
    assert got["resumed"]["digest"] == _ok(shared["qwen"])["data8"]["digest"]


def test_restore_on_data4_with_replan(both):
    """The (data 8) checkpoint of step 2 restored on (data 4), each rank
    keeping its quarter of the moments, at replan's 2 microbatches: the
    losses of steps 3-4 within 1e-5 of the uninterrupted (data 8) run."""
    shared, own, _, _ = both
    want = _ok(shared["qwen"])["data8"]["losses"][2:]
    for r in range(4):
        got = _ok(own[r]["checkpoints"])
        assert got["replan"] == (4, 2)
        np.testing.assert_allclose(got["elastic"], want, **TOL)
        assert got["elastic_mu"] == (28, 320)     # (d / 4, d_ff)


# ---------------------------------------------------------------------------
# compressed_psum over pod at O4
# ---------------------------------------------------------------------------

def test_compressed_psum_matches_reference(both):
    """Each rank's int8 exchange over ``pod`` on (pod 2, data 4): equal to
    the reference's under shard_map, and within one quantisation step a
    participant of the exact sum (tests/test_compress.py's bound)."""
    _, own, jx, _ = both
    x = _compress_inputs().reshape(2, 4, -1)
    exact = x.sum(0)
    scale = np.abs(x).max(axis=(0, 2)) / 127.0
    for r in range(WORLD):
        got = _ok(own[r]["compress"])
        np.testing.assert_allclose(got, jx["compress"][r], rtol=1e-6,
                                   atol=1e-6)
        d = r % 4
        assert np.abs(got - exact[d]).max() <= 2 * scale[d]
