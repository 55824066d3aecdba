"""The port's collectives plane (repro_torch.distributed.collectives),
topology and meshes against the JAX package's.

Structure, for the same axis names and sizes: the ReducePlan, RingPlan and
CannonPlan fields, ``schedule()``, ``perm``, ``width`` and ``data_width``
equal the JAX plans'; ``MeshTopology.describe()`` and the ``axis_roles``
declaration behave the same.  Execution, on a spawned 4-rank gloo world:
each plan's collectives against numpy on the same shards, in the
transport the plan names, and the meshes ``launch.mesh`` builds.
"""
import collections

import numpy as np
import pytest

from repro_torch.core import topology as ttopo
from repro_torch.distributed import collectives as tcoll

#: A stand-in for a DeviceMesh: the topology reads only these two fields.
FakeMesh = collections.namedtuple("FakeMesh", "mesh_dim_names shape")

MESHES = [((8, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((2, 4, 1), ("pod", "data", "model")),
          ((4, 2), ("pod", "model")),
          ((1, 8), ("data", "model")),
          ((2, 4), ("replica", "shard"))]


def _jmesh(shape, names):
    from repro.core import compat

    return compat.make_mesh(shape, names)


def _plans(shape, names):
    from repro.distributed import collectives as jcoll

    jm, tm = _jmesh(shape, names), FakeMesh(names, shape)
    return ((jcoll.reduce_plan(jm), tcoll.reduce_plan(tm)),
            (jcoll.ring_plan(jm), tcoll.ring_plan(tm)),
            (jcoll.cannon_plan(jm), tcoll.cannon_plan(tm)))


@pytest.mark.parametrize("shape,names", MESHES)
def test_reduce_plan_matches_the_reference(shape, names):
    (j, t), _, _ = _plans(shape, names)
    for f in ("pod_axes", "data_axes", "batch_axes", "width", "data_width",
              "hierarchical"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.spec_entry() == j.spec_entry()
    assert t.data_spec_entry() == j.data_spec_entry()
    for terminal in ("all_reduce", "reduce_scatter"):
        assert t.schedule(terminal) == j.schedule(terminal)


@pytest.mark.parametrize("shape,names", MESHES)
def test_ring_plan_matches_the_reference(shape, names):
    _, (j, t), _ = _plans(shape, names)
    assert (t.axes, t.size, t.perm, t.schedule(), t.spec_entry()) == \
        (j.axes, j.size, j.perm, j.schedule(), j.spec_entry())


@pytest.mark.parametrize("shape,names", MESHES)
def test_cannon_plan_matches_the_reference(shape, names):
    _, _, (j, t) = _plans(shape, names)
    for f in ("row_axes", "col_axes", "rows", "cols", "size", "all_axes"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.schedule() == j.schedule()
    assert (t.row_spec_entry(), t.pair_spec_entry()) == \
        (j.row_spec_entry(), j.pair_spec_entry())


@pytest.mark.parametrize("roles", [{}, {"replica": "pod", "shard": "data"},
                                   {"shard": "model"},
                                   {"replica": "pod", "shard": "model"}])
def test_describe_and_roles_match_the_reference(roles):
    from repro.core import topology as jtopo

    shape, names = (2, 4), ("replica", "shard")
    jm, tm = _jmesh(shape, names), FakeMesh(names, shape)
    with jtopo.axis_roles(**roles), ttopo.axis_roles(**roles):
        j, t = jtopo.topology_of(jm), ttopo.topology_of(tm)
        assert t == ttopo.MeshTopology(j.axis_names, j.axis_sizes, j.roles)
        assert t.describe() == j.describe()
        assert (t.rank, t.extent("pod", "data"), t.axes("model")) == \
            (j.rank, j.extent("pod", "data"), j.axes("model"))
        assert dict(ttopo.declared_roles()) == dict(jtopo.declared_roles())
    assert ttopo.declared_roles() == {} == dict(jtopo.declared_roles())
    # an explicit mapping wins over the scoped declaration
    assert ttopo.topology_of(tm, {"replica": "model"}).roles[0] == \
        jtopo.topology_of(jm, {"replica": "model"}).roles[0] == "model"


def test_axis_roles_nest_and_refuse_unknown_roles():
    from repro.core import topology as jtopo

    for topo in (ttopo, jtopo):
        with topo.axis_roles(x="pod"):
            with topo.axis_roles(y="data"):
                assert dict(topo.declared_roles()) == {"x": "pod",
                                                       "y": "data"}
            assert dict(topo.declared_roles()) == {"x": "pod"}
        with pytest.raises(ValueError, match="unknown axis role"):
            with topo.axis_roles(x="tensor"):
                pass
    assert ttopo.topology_of(None) is None


def test_axis_roles_declaration_drives_the_plan():
    """Exotic axis names become a hierarchy via the scoped role map, as in
    the reference's test of the same name."""
    mesh = FakeMesh(("replica", "shard"), (2, 4))
    with ttopo.axis_roles(replica="pod", shard="data"):
        plan = tcoll.reduce_plan(mesh)
    assert plan.hierarchical and plan.pod_axes == ("replica",)
    flat = tcoll.reduce_plan(mesh)
    assert not flat.hierarchical and flat.width == 8


def test_transport_by_backend_and_device():
    assert tcoll.transport_of("nccl", "cuda") == "nccl"
    assert tcoll.transport_of("gloo", "cuda") == "gloo-host"
    assert tcoll.transport_of("gloo", "cpu") == "gloo"


class _StubDist:
    """``torch.distributed`` as the low-level collectives call it, for one
    rank: each call records the devices of the buffers it is handed."""

    class ReduceOp:
        SUM, MAX = "sum", "max"

    class P2POp:
        def __init__(self, fn, tensor, peer):
            self.fn, self.tensor = fn, tensor

    class _Req:
        def wait(self):
            return True

    def __init__(self):
        self.devices = []

    def _seen(self, *tensors):
        self.devices.append(tuple(t.device for t in tensors))

    def all_reduce(self, out, op=None, group=None):
        self._seen(out)

    def reduce_scatter_tensor(self, out, x, group=None):
        self._seen(out, x)

    def all_gather_into_tensor(self, out, x, group=None):
        self._seen(out, x)

    def all_to_all_single(self, out, x, group=None):
        self._seen(out, x)

    def get_rank(self, group=None):
        return 0

    def get_global_rank(self, group, r):
        return r

    def isend(self):
        pass

    def irecv(self):
        pass

    def batch_isend_irecv(self, ops):
        self._seen(*(op.tensor for op in ops))
        return [self._Req() for _ in ops]


COLLECTIVE_CALLS = {
    "all_reduce": lambda x, t: tcoll.all_reduce(x, None, t),
    "reduce_scatter": lambda x, t: tcoll.reduce_scatter(x, None, 2, t, 1),
    "all_gather": lambda x, t: tcoll.all_gather(x, None, 2, t, 1),
    "all_to_all": lambda x, t: tcoll.all_to_all(x, None, 2, t, 0, 1),
    "rotate": lambda x, t: tcoll.rotate(x, None, 2, t)}


@pytest.mark.parametrize("transport,device", [("nccl", "meta"),
                                              ("gloo", "cpu")])
@pytest.mark.parametrize("kind", sorted(COLLECTIVE_CALLS))
def test_result_buffers_stay_on_the_tensors_device(monkeypatch, kind,
                                                   transport, device):
    """Unstaged (NCCL on the card, gloo on the host) every buffer a
    collective hands the transport lies on the input's device, and so
    does its result (``meta`` stands in for the card); while the tracer
    is on, the call is one ``collective:<kind>`` span with its operand
    bytes and transport."""
    import torch

    from repro_torch.obs import trace as obs_trace

    stub = _StubDist()
    monkeypatch.setattr(tcoll, "_dist", lambda: stub)
    x = torch.empty((4, 6), dtype=torch.bfloat16, device=device)
    tracer = obs_trace.TRACER
    tracer.clear()
    with tracer.tracing():
        out = COLLECTIVE_CALLS[kind](x, transport)
    assert out.device == x.device
    assert stub.devices and all(d == x.device for call in stub.devices
                                for d in call), stub.devices
    spans = [e for e in tracer.events() if e["ph"] == "X"
             and e["name"].startswith("collective:")]
    tracer.clear()
    assert [(e["name"], e["args"]["bytes"], e["args"]["transport"])
            for e in spans] == [(f"collective:{kind}", 48, transport)]


# ---------------------------------------------------------------------------
# execution on a 4-rank gloo world
# ---------------------------------------------------------------------------

def _data(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _collectives_world(rank, world):
    """Every plan's collectives on a (pod 2, data 2, model 1) and a
    (data 2, model 2) mesh; this rank's results."""
    import torch

    from repro_torch.launch.mesh import describe, make_mesh

    out = {}
    m4 = make_mesh(data=2, model=1, pod=2, device_type="cpu")
    m22 = make_mesh(data=2, model=2, device_type="cpu")
    out["describe"] = (describe(m4), describe(m22))
    plan = tcoll.reduce_plan(m4)
    out["transports"] = plan.transports()
    out["shard_index"] = plan.shard_index()
    x = torch.as_tensor(_data(rank, 8, 3))
    out["psum"] = plan.psum(x).numpy()
    out["psum_scatter"] = plan.psum_scatter(x, 0).numpy()
    out["psum_scatter1"] = plan.psum_scatter(
        torch.as_tensor(_data(rank, 3, 8)), 1).numpy()
    out["all_gather"] = plan.all_gather(x[:2]).numpy()
    z = torch.as_tensor(_data(rank, 4, 6) + 1j * _data(rank + 9, 4, 6)) \
        .to(torch.complex64)
    out["all_to_all"] = plan.all_to_all(z, "data", split_dim=1,
                                        concat_dim=0).numpy()
    ring = tcoll.ring_plan(m4)
    out["ring_index"] = ring.ring_index()
    out["shift"] = ring.shift(x).numpy()
    out["ring_psum"] = ring.psum(x).numpy()
    out["ring_pmax"] = ring.pmax(x).numpy()
    cannon = tcoll.cannon_plan(m22)
    out["pair_index"] = cannon.pair_index()
    out["reduce_partials"] = cannon.reduce_partials(x).numpy()
    out["coords"] = dict(tcoll.mesh_groups(m22).coords)
    return out


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch.world import run_world

    return run_world(_collectives_world, 4, timeout=180)


def test_meshes_over_the_world(world):
    assert world[0]["describe"] == (
        "Mesh(pod=2, data=2, model=1; 4 devices)",
        "Mesh(data=2, model=2; 4 devices)")
    assert all(r["transports"] == {k: "gloo" for k in (
        "all_reduce", "reduce_scatter", "all_gather", "all_to_all")}
        for r in world)
    # ranks are laid out row-major: (pod, data, model) and (data, model)
    assert [r["shard_index"] for r in world] == [0, 1, 2, 3]
    assert [r["coords"] for r in world] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]


def test_reduce_plan_collectives(world):
    """(pod 2, data 2): rank r = 2 pod + data.  psum sums all four;
    psum_scatter keeps this data coordinate's half of the four-way sum
    (tiled, any dim); all_gather reassembles pod-major; the all-to-all
    turns within the data axis only."""
    xs = [_data(r, 8, 3) for r in range(4)]
    total = np.sum(xs, axis=0)
    for r, res in enumerate(world):
        d = r % 2
        np.testing.assert_allclose(res["psum"], total, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["psum_scatter"],
                                   total[4 * d:4 * d + 4], rtol=1e-6,
                                   atol=1e-6)
        t1 = np.sum([_data(q, 3, 8) for q in range(4)], axis=0)
        np.testing.assert_allclose(res["psum_scatter1"],
                                   t1[:, 4 * d:4 * d + 4], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            res["all_gather"], np.concatenate([x[:2] for x in xs]))
        pod = r // 2
        zs = [(_data(q, 4, 6) + 1j * _data(q + 9, 4, 6)).astype(np.complex64)
              for q in (2 * pod, 2 * pod + 1)]
        np.testing.assert_array_equal(
            res["all_to_all"], np.concatenate([z[:, 3 * d:3 * d + 3]
                                               for z in zs]))
    # every rank holds the same bits of a reduction
    for k in ("psum", "all_gather"):
        assert all(np.array_equal(r[k], world[0][k]) for r in world)


def test_ring_and_cannon_plans(world):
    xs = [_data(r, 8, 3) for r in range(4)]
    for r, res in enumerate(world):
        assert res["ring_index"] == r
        np.testing.assert_array_equal(res["shift"], xs[(r - 1) % 4])
        np.testing.assert_allclose(res["ring_psum"], np.sum(xs, axis=0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(res["ring_pmax"],
                                      np.max(xs, axis=0))
        # (data 2, model 2): sum over model, reduce-scatter rows over data
        d = r // 2
        assert res["pair_index"] == r
        part = xs[2 * d] + xs[2 * d + 1]
        other = xs[2 * (1 - d)] + xs[2 * (1 - d) + 1]
        np.testing.assert_allclose(res["reduce_partials"],
                                   (part + other)[4 * d:4 * d + 4],
                                   rtol=1e-6, atol=1e-6)


def test_production_mesh_names_the_world_it_needs():
    from repro_torch.launch import mesh as tmesh

    with pytest.raises(RuntimeError, match="needs a world of 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs a world of 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(data=2)


# ---------------------------------------------------------------------------
# sharding rules, scope keys and explain, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", MESHES[:4])
@pytest.mark.parametrize("tensor", [(), (64,), (64, 32), (8, 3, 16), (5, 7)])
def test_auto_spec_matches_the_reference(shape, names, tensor):
    from repro.core import sharding as jsh
    from repro_torch.core import sharding as tsh

    jm, tm = _jmesh(shape, names), FakeMesh(names, shape)
    assert tuple(tsh.auto_spec(tensor, tm)) == tuple(jsh.auto_spec(tensor,
                                                                   jm))
    assert tsh.batch_axes(tm) == jsh.batch_axes(jm)


@pytest.mark.parametrize("entries", [("batch", None), ("batch", "model"),
                                     (None, "model"), ("data",),
                                     ("batch", "absent")])
def test_named_matches_the_reference(entries):
    from repro.distributed import sharding as jds
    from repro_torch.distributed import sharding as tds

    shape, names = (2, 2, 2), ("pod", "data", "model")
    got = tds.named(FakeMesh(names, shape), *entries)
    want = jds.named(_jmesh(shape, names), *entries)
    assert tuple(got.spec) == tuple(want.spec)


def test_sharding_helpers_are_no_ops_without_a_mesh():
    import torch

    from repro_torch.core import sharding as tsh
    from repro_torch.distributed import sharding as tds

    x = torch.ones(4, 4)
    assert tds.active_mesh() is None and tds.batch_axes() == ()
    assert tds.constrain(x, "batch", "model") is x
    assert tds.gather(x) is x
    assert tuple(tds.spec("batch", "model", None)) == (None, None, None)
    assert tsh.auto_sharding((4,), None) is None
    with pytest.raises(ValueError, match="not in the mesh's order"):
        tsh.NamedSharding(FakeMesh(("pod", "data"), (2, 2)),
                          tsh.P(("data", "pod")))


def test_scope_keys_match_the_reference():
    """Cost-model and block-cache keys end in ``mesh|<describe>`` under a
    mesh, letter for letter the reference's: here the (1, 1) mesh that
    use_level(O3) builds without a process group, against the reference's
    (1, 1) mesh."""
    from repro.core import ExecLevel as JL
    from repro.core import blocking as jblk
    from repro.core import compat
    from repro.core import use_level as juse
    from repro_torch.core import ExecLevel, blocking, registry, use_level

    assert blocking.ambient_scope_key() == jblk.ambient_scope_key() \
        == ("chip", "-")
    with use_level(ExecLevel.O3), juse(JL.O3, compat.make_mesh(
            (1, 1), ("data", "model"))):
        got = blocking.ambient_scope_key()
        assert got == jblk.ambient_scope_key() == ("mesh", "data1xmodel1")
        assert registry.scope_key(registry.select_context()) == got
        assert blocking.AutotuneCache.key("op", {"n": 4}, "float32", *got) \
            == jblk.AutotuneCache.key("op", {"n": 4}, "float32", *got) \
            == "op|n=4|float32|mesh|data1xmodel1"


def test_an_out_sharding_hook_that_raises_fails_the_dispatch():
    """A variant's ``out_sharding`` hook is run on its result: a layout it
    declines (None) leaves the result unannotated, one that raises fails
    the dispatch instead of returning a result with no layout, and
    explain reports the exception in its row."""
    import torch

    from repro_torch.core import registry

    def hook(ctx, x):
        if x.shape[0] > 2:
            raise KeyError("no layout for this")
        return "layout" if x.shape[0] == 2 else None

    reg = registry.OperatorRegistry()
    reg.register("op", "v", lambda x: x * 2, out_sharding=hook)
    assert reg.dispatch("op", torch.ones(2)).out_sharding == "layout"
    assert not hasattr(reg.dispatch("op", torch.ones(1)), "out_sharding")
    with pytest.raises(KeyError, match="no layout"):
        reg.dispatch("op", torch.ones(3))
    with pytest.raises(KeyError, match="no layout"):
        reg.dispatch("op", torch.ones(3), variant="v")
    row, = reg.explain("op", torch.ones(3))
    assert row["selected"] and row["out_sharding"] == \
        "out_sharding hook raised KeyError: 'no layout for this'"


@pytest.mark.parametrize("level", ["O2", "O3"])
def test_explain_reasons_match_the_reference_for_mesh_variants(level):
    """The matmul candidates' scope and verdicts: at O2 the mesh variants
    are scope mismatches; on a mesh with no batch axis (the one-process
    mesh, the reference's (1, 1) mesh) their available-predicate says no,
    in both packages."""
    import jax.numpy as jnp
    import torch

    from repro.core import ExecLevel as JL
    from repro.core import compat
    from repro.core import registry as jreg
    from repro.core import use_level as juse
    from repro_torch.core import ExecLevel, registry, use_level

    def verdicts(rows):
        return {r["variant"]: (r["scope"], r["reason"].split(":")[0])
                for r in rows if r["scope"] == "mesh"}

    a, ja = torch.ones(64, 64), jnp.ones((64, 64), jnp.float32)
    if level == "O2":
        got, want = registry.explain("matmul", a, a), \
            jreg.explain("matmul", ja, ja)
    else:
        with use_level(ExecLevel.O3), juse(JL.O3, compat.make_mesh(
                (1, 1), ("data", "model"))):
            got, want = registry.explain("matmul", a, a), \
                jreg.explain("matmul", ja, ja)
    assert verdicts(got) == verdicts(want)
    assert {r["ambient_scope"] for r in got} == \
        {r["ambient_scope"] for r in want}


def _fails_or_hangs(rank, world, how):
    import time

    if rank == 1 and how == "raise":
        raise ValueError("rank one fails on purpose")
    time.sleep(120)                     # the other rank is killed


@pytest.mark.parametrize("how,timeout,match", [
    ("raise", 120,
     r"rank 1 raised:[\s\S]*ValueError: rank one fails on purpose"),
    ("hang", 2, "did not finish in 2 s")])
def test_a_failing_world_fails_with_the_rank_and_ends(how, timeout, match):
    """A rank that raises fails the world with its traceback; a world past
    its deadline fails too; either way no rank outlives the call."""
    from repro_torch.launch.world import WorldError, start_world

    world = start_world(_fails_or_hangs, 2, args=(how,), timeout=timeout)
    with pytest.raises(WorldError, match=match):
        world.join()
    assert not any(p.is_alive() for p in world.procs)
