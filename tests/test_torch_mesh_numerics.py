"""The port's mesh scope (repro_torch.distributed.numerics under
``use_level(O3|O4)``) against the JAX package's on the same numpy inputs.

The port runs on 8 gloo ranks of one spawned world (one per test module):
every rank builds the O3 mesh (data 8, model 1) and the O4 mesh (pod 2,
data 2, model 2) over the world, runs every case below on them through the
normal entry points (``ops.matmul``, ``ops.fft``, ``solver_spmv``,
``cg_solve``, ``cg_block_solve``, ``sparse.spmm``, ``sparse.spgemm``),
gathers each result whole and sends it back.  The JAX side runs the same
calls on the 8 forced host devices (``mesh8``, ``mesh222``).  Held: the
selected variant names equal, the results at the JAX suites' tolerances
(tests/test_distributed_numerics.py, tests/test_sparse.py,
tests/test_spgemm.py), every rank's gathered result the same bits, and a
second run on the same inputs the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.numerics.sparse import banded_spd

WORLD = 8


# ---------------------------------------------------------------------------
# inputs: numpy, the same for both packages
# ---------------------------------------------------------------------------

def _banded(n=256, bw=31, seed=3):
    a = banded_spd(n, bw, seed=seed)
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return a, x


def _mm_operands(n_cols=96):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, n_cols)).astype(np.float32)
    return a, b


def _signal():
    rng = np.random.default_rng(0)
    return (rng.standard_normal(512) + 1j * rng.standard_normal(512)) \
        .astype(np.complex64)


def _rhs(n, k=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)) \
        .astype(np.float32)


def _sparse_banded(n=256, bw=15, seed=1):
    return banded_spd(n, bw, seed=seed).astype(np.float32)


def _blocked(n=128, block=8, frac=0.3, seed=2):
    rng = np.random.default_rng(seed)
    nb = n // block
    occ = rng.random((nb, nb)) < frac
    d = rng.standard_normal((n, n)).astype(np.float32)
    return np.where(np.kron(occ, np.ones((block, block), bool)), d, 0.0) \
        .astype(np.float32)


CG_TABLE2_O3 = ((128, 3), (256, 31), (512, 63))
CG_TABLE2_O4 = ((256, 31),)


# ---------------------------------------------------------------------------
# the port's side: one world of 8 ranks runs every case
# ---------------------------------------------------------------------------

def _np(x):
    from repro_torch.core import unwrap
    from repro_torch.distributed.sharding import gather

    return gather(unwrap(x)).detach().cpu().numpy()


def _placements(ps) -> list:
    return [(type(p).__name__, getattr(p, "dim", None)) for p in ps]


def _port_cases(mesh8, mesh222):
    """Every case's results on this rank, keyed by the test that reads
    them."""
    from repro_torch.core import ExecLevel, bind, registry, use_level
    from repro_torch.kernels import ops
    from repro_torch.numerics import solvers, sparse
    import repro_torch.sparse as S

    cpu = "cpu"
    O3, O4 = ExecLevel.O3, ExecLevel.O4
    out = {}

    def record(name, fn):
        try:
            out[name] = fn()
        except Exception as e:                  # the test reads it
            out[name] = {"raised": f"{type(e).__name__}: {e}"}

    def mats(a):
        csr = sparse.csr_from_dense(a, device=cpu)
        return {"csr": csr, "ell": sparse.ell_from_csr(csr),
                "dia": sparse.dia_from_dense(a, device=cpu)}

    def t(x):
        return torch.as_tensor(x)

    # -- scope selection (mesh8) ---------------------------------------------
    def variant_under_mesh():
        a, x = _banded()
        ell = mats(a)["ell"]
        xb = bind(x, device=cpu)
        got = [registry.select("solver_spmv", ell, xb).name]
        with use_level(O3, mesh8):
            got.append(registry.select("solver_spmv", ell, xb).name)
        got.append(registry.select("solver_spmv", ell, xb).name)
        return got
    record("variant_under_mesh", variant_under_mesh)

    def all_layouts():
        a, x = _banded()
        xb = bind(x, device=cpu)
        with use_level(O3, mesh8):
            return {k: registry.select("solver_spmv", m, xb).name
                    for k, m in mats(a).items()}
    record("all_layouts", all_layouts)

    def pins():
        a, x = _banded()
        dia, xb = mats(a)["dia"], bind(x, device=cpu)
        with use_level(O3, mesh8):
            names = [registry.select("solver_spmv", dia, xb,
                                     variant="dia").name,
                     registry.select("solver_spmv", dia, xb,
                                     variant="mesh_dia").name]
            chip = registry.dispatch("solver_spmv", dia, xb, variant="dia")
            mesh = registry.dispatch("solver_spmv", dia, xb,
                                     variant="mesh_dia")
        return {"names": names, "chip": _np(chip), "mesh": _np(mesh)}
    record("pins", pins)

    def indivisible():
        a = sparse.banded_spd(100, 3, seed=1)
        x = np.random.default_rng(1).standard_normal(100).astype(np.float32)
        with use_level(O3, mesh8):
            return registry.select("solver_spmv", mats(a)["ell"],
                                   bind(x, device=cpu)).name
    record("indivisible", indivisible)

    def matmul_fft_scope():
        a = torch.ones(64, 64)
        z = torch.ones(256, dtype=torch.complex64)
        got = {"chip": [registry.select("matmul", a, a).scope,
                        registry.select("fft", z).scope]}
        with use_level(O3, mesh8):
            odd = torch.ones(30, 30)
            got["mesh"] = [registry.select("matmul", a, a).name,
                           registry.select("fft", z).name,
                           registry.select("matmul", odd, odd).scope]
            # length 40: the mesh variant refuses it; so do the port's chip
            # variants, whose domain is powers of two
            got["fft40"] = {r["variant"]: r["reason"].split(":")[0]
                            for r in registry.explain("fft", torch.ones(
                                40, dtype=torch.complex64))}
        return got
    record("matmul_fft_scope", matmul_fft_scope)

    def outranks_plane():
        a = torch.ones(64, 64)
        with use_level(O3, mesh8), registry.use_backend("torch"):
            return registry.select("matmul", a, a).name
    record("outranks_plane", outranks_plane)

    def default_meshes():
        """use_level without a mesh builds the reference's default mesh
        over the world: (n, 1) at O3, (2, n / 2, 1) at O4."""
        a = torch.ones(64, 64)
        got = {}
        for level in (O3, O4):
            with use_level(level) as ctx:
                got[level.name] = (tuple(ctx.mesh.mesh_dim_names),
                                   tuple(ctx.mesh.shape),
                                   registry.select("matmul", a, a).name)
        return got
    record("default_meshes", default_meshes)

    # -- numerics (mesh8) ------------------------------------------------------
    def spmv_layouts(mesh, level):
        a, x = _banded()
        xb = bind(x, device=cpu)
        got = {}
        for k, m in mats(a).items():
            with use_level(level, mesh):
                name = registry.select("solver_spmv", m, xb).name
                got[k] = (name, _np(registry.dispatch("solver_spmv", m, xb)))
        return got
    record("spmv_o3", lambda: spmv_layouts(mesh8, O3))
    record("spmv_o4", lambda: spmv_layouts(mesh222, O4))

    def matmul(mesh, level, n_cols=96):
        a, b = _mm_operands(n_cols)
        with use_level(level, mesh):
            name = registry.select("matmul", t(a), t(b)).name
            first = _np(ops.matmul(t(a), t(b)))
            again = _np(ops.matmul(t(a), t(b)))
        return {"name": name, "c": first,
                "same_bits": bool(np.array_equal(first, again))}
    record("matmul_o3", lambda: matmul(mesh8, O3))
    record("matmul_o4", lambda: matmul(mesh222, O4))
    record("matmul_o4_cyclic", lambda: matmul(mesh222, O4, 512))

    def fft(mesh, level):
        z = t(_signal())
        with use_level(level, mesh):
            return {"name": registry.select("fft", z).name,
                    "x": _np(ops.fft(z))}
    record("fft_o3", lambda: fft(mesh8, O3))
    record("fft_o4", lambda: fft(mesh222, O4))

    def cg(mesh, level, cases):
        got = {}
        for n, bw in cases:
            a = sparse.banded_spd(n, bw, seed=n + bw)
            b = bind(np.random.default_rng(n).standard_normal(n)
                     .astype(np.float32), device=cpu)
            dia = sparse.dia_from_dense(a, device=cpu)
            chip = solvers.cg_solve(dia, b, stop=1e-12, max_iters=2 * n)
            with use_level(level, mesh):
                res = solvers.cg_solve(dia, b, stop=1e-12, max_iters=2 * n)
            got[(n, bw)] = {"x": _np(res.x), "k": int(res.iterations),
                            "chip_x": _np(chip.x),
                            "chip_k": int(chip.iterations)}
        return got
    record("cg_o3", lambda: cg(mesh8, O3, CG_TABLE2_O3))
    record("cg_o4", lambda: cg(mesh222, O4, CG_TABLE2_O4))

    def cg_csr_ell():
        n = 256
        a = sparse.banded_spd(n, 7, seed=9)
        b = bind(np.random.default_rng(9).standard_normal(n)
                 .astype(np.float32), device=cpu)
        m = mats(a)
        chip = solvers.cg_solve(m["csr"], b, stop=1e-12, max_iters=2 * n)
        got = {"chip": _np(chip.x)}
        for k in ("csr", "ell"):
            with use_level(O3, mesh8):
                got[k] = _np(solvers.cg_solve(m[k], b, stop=1e-12,
                                              max_iters=2 * n).x)
        return got
    record("cg_csr_ell", cg_csr_ell)

    def mismatched_pin():
        a, _ = _banded(128, 3)
        b = bind(np.random.default_rng(0).standard_normal(128)
                 .astype(np.float32), device=cpu)
        with use_level(O3, mesh8):
            solvers.cg_solve(mats(a)["dia"], b, backend="mesh_ell")
        return {"raised": None}
    record("mismatched_pin", mismatched_pin)

    def twiddles():
        from repro_torch.distributed import numerics as dnum

        z = t(_signal())
        dnum._fft_twiddles.cache_clear()
        with use_level(O3, mesh8):
            ops.fft(z)
            ops.fft(z)
        info = dnum._fft_twiddles.cache_info()
        return (info.currsize, info.hits)
    record("twiddles", twiddles)

    def backend_pin():
        n = 128
        a = sparse.banded_spd(n, 3, seed=2)
        b = bind(np.random.default_rng(2).standard_normal(n)
                 .astype(np.float32), device=cpu)
        dia = mats(a)["dia"]
        with use_level(O3, mesh8):
            pinned = solvers.cg_solve(dia, b, backend="dia",
                                      max_iters=2 * n)
            auto = solvers.cg_solve(dia, b, max_iters=2 * n)
        return {"pinned": _np(pinned.x), "auto": _np(auto.x),
                "pinned_sharded": type(pinned.x.data).__name__}
    record("backend_pin", backend_pin)

    # -- hierarchy (mesh222) -----------------------------------------------
    def context():
        with use_level(O4, mesh222):
            ctx = registry.select_context()
        return {"rank": ctx.mesh_rank, "roles": ctx.topology.roles,
                "describe": ctx.topology.describe(),
                "after": registry.select_context().mesh_rank}
    record("context", context)

    def o4_matmul_names():
        a = torch.ones(64, 64)
        got = [registry.select("matmul", a, a).scope]
        with use_level(O4, mesh222):
            got += [registry.select("matmul", a, a).name,
                    registry.select("matmul", a, torch.ones(64, 95)).name,
                    registry.select("matmul", torch.ones(63, 63),
                                    torch.ones(63, 63)).scope]
        with use_level(O3, mesh8):
            got.append(registry.select("matmul", a, a).name)
        return got
    record("o4_matmul_names", o4_matmul_names)

    def o4_indivisible():
        a = sparse.banded_spd(250, 3, seed=1)
        x = np.random.default_rng(1).standard_normal(250).astype(np.float32)
        with use_level(O4, mesh222):
            return registry.select("solver_spmv", mats(a)["ell"],
                                   bind(x, device=cpu)).name
    record("o4_indivisible", o4_indivisible)

    # -- mesh_spmm and block CG (test_sparse.py) -----------------------------
    def spmm(mesh, level, fmts):
        a = _sparse_banded()
        x = _rhs(a.shape[0])
        got = {}
        for fmt in fmts:
            m = S.matrix(a, format=fmt, device=cpu) if fmt else \
                S.matrix(a, device=cpu)
            want = _np(S.spmm(m, t(x)))
            with use_level(level, mesh):
                name = registry.select("spmm", m, bind(x, device=cpu)).name
                got[fmt or "auto"] = (name, _np(S.spmm(m, t(x))), want)
        return got
    record("spmm_o3", lambda: spmm(mesh8, O3, ("csr", "ell", "dia")))
    record("spmm_o4", lambda: spmm(mesh222, O4, (None,)))

    def spmm_degrade():
        bsr = S.matrix(_sparse_banded(), format="bsr", device=cpu)
        odd = S.matrix(_sparse_banded(100, 3), format="ell", device=cpu)
        with use_level(O3, mesh8):
            return [registry.select("spmm", bsr,
                                    bind(_rhs(256), device=cpu)).scope,
                    registry.select("spmm", odd,
                                    bind(_rhs(100), device=cpu)).scope]
    record("spmm_degrade", spmm_degrade)

    def block_cg():
        n = 256
        a = banded_spd(n, 31, seed=5).astype(np.float32)
        b = _rhs(n, 4, seed=5)
        m = S.matrix(a, device=cpu)
        chip = solvers.cg_block_solve(m, t(b), stop=1e-12, max_iters=2 * n)
        with use_level(O3, mesh8):
            mesh = solvers.cg_block_solve(m, t(b), stop=1e-12,
                                          max_iters=2 * n)
        return {"x": _np(mesh.x), "k": int(mesh.iterations),
                "chip_x": _np(chip.x), "chip_k": int(chip.iterations)}
    record("block_cg", block_cg)

    # -- mesh_spgemm (test_spgemm.py) ----------------------------------------
    def spgemm(mesh, level, seed, n=128, frac=0.35):
        A = _blocked(n, seed=seed, frac=frac)
        B = _blocked(n, seed=seed + 1, frac=frac)
        a = S.bsr_from_dense(A, device=cpu)
        b = S.bsr_from_dense(B, device=cpu)
        chip = S.spgemm(a, b, variant="bsr_torch").todense()
        with use_level(level, mesh):
            name = registry.select("spgemm", a, b).name
            c = S.spgemm(a, b)
            again = S.spgemm(a, b).todense()
        sh = c.out_sharding
        return {"name": name, "c": c.todense(), "chip": chip,
                "same_bits": bool(np.array_equal(c.todense(), again)),
                "spec": None if sh is None else tuple(sh.spec),
                "placements": None if sh is None
                else _placements(sh.placements),
                "values_placements": _placements(c.values.placements)
                if hasattr(c.values, "placements") else None}
    record("spgemm_o3", lambda: spgemm(mesh8, O3, 30))
    record("spgemm_o4", lambda: spgemm(mesh222, O4, 31))

    def spgemm_indivisible():
        A, B = _blocked(72, seed=32, frac=0.5), _blocked(72, seed=33,
                                                         frac=0.5)
        a = S.bsr_from_dense(A, device=cpu)
        b = S.bsr_from_dense(B, device=cpu)
        with use_level(O3, mesh8):
            name = registry.select("spgemm", a, b).name
            c = S.spgemm(a, b)
        return {"name": name, "out_sharding": c.out_sharding,
                "c": c.todense(), "want": A @ B}
    record("spgemm_indivisible", spgemm_indivisible)
    return out


def _port_world(rank, world):
    """One rank: both meshes over the world, every case."""
    from repro_torch.launch.mesh import make_mesh

    mesh8 = make_mesh(data=8, model=1, device_type="cpu")
    mesh222 = make_mesh(data=2, model=2, pod=2, device_type="cpu")
    return _port_cases(mesh8, mesh222)


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
# the JAX side: the same calls on the 8 forced host devices
# ---------------------------------------------------------------------------

def _jax_cases():
    """The JAX package's results for the cases that compare with it."""
    import jax.numpy as jnp

    import repro.core as C
    from repro import sparse as S
    from repro.core import ExecLevel, compat, registry, use_level
    from repro.kernels import ops
    from repro.numerics import solvers, sparse

    mesh8 = compat.make_mesh((8, 1), ("data", "model"))
    mesh222 = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
    O3, O4 = ExecLevel.O3, ExecLevel.O4
    out = {}

    def mats(a):
        csr = sparse.csr_from_dense(a)
        return {"csr": csr, "ell": sparse.ell_from_csr(csr),
                "dia": sparse.dia_from_dense(a)}

    a, x = _banded()
    ell, xb = mats(a)["ell"], C.bind(x)
    got = [registry.select("solver_spmv", ell, xb).name]
    with use_level(O3, mesh8):
        got.append(registry.select("solver_spmv", ell, xb).name)
        out["all_layouts"] = {k: registry.select("solver_spmv", m, xb).name
                              for k, m in mats(a).items()}
        out["pins"] = registry.dispatch(
            "solver_spmv", mats(a)["dia"], xb, variant="mesh_dia").read()
    got.append(registry.select("solver_spmv", ell, xb).name)
    out["variant_under_mesh"] = got

    a2 = jnp.ones((64, 64), jnp.float32)
    z = jnp.ones(256, jnp.complex64)
    out["chip_scope"] = [registry.select("matmul", a2, a2).scope,
                         registry.select("fft", z).scope]
    with use_level(O3, mesh8):
        odd = jnp.ones((30, 30), jnp.float32)
        out["mesh_scope"] = [registry.select("matmul", a2, a2).name,
                             registry.select("fft", z).name,
                             registry.select("matmul", odd, odd).scope,
                             registry.select("fft", jnp.ones(
                                 40, jnp.complex64)).scope]

    for key, mesh, level in (("o3", mesh8, O3), ("o4", mesh222, O4)):
        res = {}
        for k, m in mats(a).items():
            with use_level(level, mesh):
                res[k] = (registry.select("solver_spmv", m, xb).name,
                          registry.dispatch("solver_spmv", m, xb).read())
        out[f"spmv_{key}"] = res
        zz = jnp.asarray(_signal())
        with use_level(level, mesh):
            out[f"fft_{key}"] = (registry.select("fft", zz).name,
                                 np.asarray(ops.fft(zz)))

    for key, mesh, level, n_cols in (("matmul_o3", mesh8, O3, 96),
                                     ("matmul_o4", mesh222, O4, 96),
                                     ("matmul_o4_cyclic", mesh222, O4, 512)):
        ma, mb = (jnp.asarray(v) for v in _mm_operands(n_cols))
        with use_level(level, mesh):
            out[key] = (registry.select("matmul", ma, mb).name,
                        np.asarray(ops.matmul(ma, mb)))

    for key, mesh, level, cases in (("cg_o3", mesh8, O3, CG_TABLE2_O3),
                                    ("cg_o4", mesh222, O4, CG_TABLE2_O4)):
        res = {}
        for n, bw in cases:
            sa = sparse.banded_spd(n, bw, seed=n + bw)
            b = C.bind(np.random.default_rng(n).standard_normal(n)
                       .astype(np.float32))
            with use_level(level, mesh):
                r = solvers.cg_solve(sparse.dia_from_dense(sa), b,
                                     stop=1e-12, max_iters=2 * n)
            res[(n, bw)] = (r.x.read(), int(r.iterations))
        out[key] = res

    with use_level(O4, mesh222):
        ctx = registry.select_context()
        out["context"] = (ctx.mesh_rank, ctx.topology.roles,
                          ctx.topology.describe())
    names = [registry.select("matmul", a2, a2).scope]
    with use_level(O4, mesh222):
        names += [registry.select("matmul", a2, a2).name,
                  registry.select("matmul", a2, jnp.ones(
                      (64, 95), jnp.float32)).name,
                  registry.select("matmul", jnp.ones((63, 63)),
                                  jnp.ones((63, 63))).scope]
    with use_level(O3, mesh8):
        names.append(registry.select("matmul", a2, a2).name)
    out["o4_matmul_names"] = names

    sb = _sparse_banded()
    rhs = _rhs(sb.shape[0])
    for key, mesh, level, fmts in (("spmm_o3", mesh8, O3,
                                    ("csr", "ell", "dia")),
                                   ("spmm_o4", mesh222, O4, (None,))):
        res = {}
        for fmt in fmts:
            m = S.matrix(sb, format=fmt) if fmt else S.matrix(sb)
            with use_level(level, mesh):
                res[fmt or "auto"] = (
                    registry.select("spmm", m, C.bind(rhs)).name,
                    S.spmm(m, rhs).read())
        out[key] = res

    for key, mesh, level, seed in (("spgemm_o3", mesh8, O3, 30),
                                   ("spgemm_o4", mesh222, O4, 31)):
        A = _blocked(128, seed=seed, frac=0.35)
        B = _blocked(128, seed=seed + 1, frac=0.35)
        ga, gb = S.bsr_from_dense(A), S.bsr_from_dense(B)
        with use_level(level, mesh):
            name = registry.select("spgemm", ga, gb).name
            c = S.spgemm(ga, gb)
        out[key] = (name, c.todense(), A @ B, tuple(c.out_sharding.spec))
    return out


@pytest.fixture(scope="module")
def both():
    """(the port's results, the JAX package's): the 8-rank gloo world runs
    while the JAX side computes; every rank must return the same bits."""
    from repro_torch.launch.world import start_world

    world = start_world(_port_world, WORLD, timeout=240)
    try:
        jx = _jax_cases()
    finally:
        ranks = world.join()
    for r, res in enumerate(ranks[1:], 1):
        assert _same_bits(res, ranks[0]), f"rank {r} differs from rank 0"
    return ranks[0], jx


def _ok(res):
    assert not (isinstance(res, dict) and res.get("raised")), res["raised"]
    return res


# ---------------------------------------------------------------------------
# scope-aware selection
# ---------------------------------------------------------------------------

class TestScopeSelection:
    def test_default_mesh_over_the_world(self, both):
        from repro.core.execlevel import ExecLevel, default_mesh_for

        got = _ok(both[0]["default_meshes"])
        for level in ("O3", "O4"):
            jm = default_mesh_for(ExecLevel[level])
            assert got[level][:2] == (tuple(jm.axis_names),
                                      tuple(jm.devices.shape))
        assert got == {"O3": (("data", "model"), (8, 1), "mesh_psum"),
                       "O4": (("pod", "data", "model"), (2, 4, 1),
                              "mesh_psum")}

    def test_mesh_variant_under_mesh_chip_without(self, both):
        port, jx = both
        assert _ok(port["variant_under_mesh"]) == jx["variant_under_mesh"] \
            == ["ell", "mesh_ell", "ell"]

    def test_all_layouts_route_to_their_mesh_variant(self, both):
        port, jx = both
        assert _ok(port["all_layouts"]) == jx["all_layouts"] == {
            "csr": "mesh_csr", "ell": "mesh_ell", "dia": "mesh_dia"}

    def test_explicit_variant_pins_chip_under_mesh(self, both):
        port, jx = both
        got = _ok(port["pins"])
        assert got["names"] == ["dia", "mesh_dia"]
        np.testing.assert_allclose(got["chip"], got["mesh"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["mesh"], jx["pins"], rtol=1e-5,
                                   atol=1e-5)

    def test_indivisible_rows_degrade_to_chip(self, both):
        assert _ok(both[0]["indivisible"]) == "ell"

    def test_matmul_and_fft_scope_selection(self, both):
        port, jx = both
        got = _ok(port["matmul_fft_scope"])
        assert got["chip"] == jx["chip_scope"] == ["chip", "chip"]
        assert got["mesh"] == jx["mesh_scope"][:3] == [
            "mesh_psum", "mesh_transpose", "chip"]
        # length 40: the mesh variant refuses it in both packages; the
        # reference's chip plane takes it, the port's chip variants take
        # powers of two only
        assert jx["mesh_scope"][3] == "chip"
        assert got["fft40"] == {"mesh_transpose": "accepts-predicate",
                                "cuda": "plane-unavailable",
                                "torch": "accepts-predicate"}

    def test_mesh_scope_outranks_requested_plane(self, both):
        """Scope beats the plane request: with the port's plain plane
        requested (the reference requests 'interpret'), the sharded
        formulation wins under a mesh."""
        assert _ok(both[0]["outranks_plane"]) == "mesh_psum"


# ---------------------------------------------------------------------------
# numerics: mesh == chip == the JAX package's mesh
# ---------------------------------------------------------------------------

def _spmv_check(port, jx, key):
    a, x = _banded()
    want = a.astype(np.float32) @ x
    for k, (name, y) in _ok(port[key]).items():
        assert name == jx[key][k][0] == f"mesh_{k}"
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y, jx[key][k][1], rtol=1e-4, atol=1e-4)


def _matmul_check(port, jx, key, name, n_cols=96):
    got = _ok(port[key])
    a, b = _mm_operands(n_cols)
    assert got["name"] == jx[key][0] == name and got["same_bits"]
    np.testing.assert_allclose(got["c"], a @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["c"], jx[key][1], rtol=1e-4, atol=1e-4)


def _fft_check(port, jx, key):
    got = _ok(port[key])
    assert got["name"] == jx[key][0] == "mesh_transpose"
    np.testing.assert_allclose(got["x"], np.fft.fft(_signal()), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(got["x"], jx[key][1], rtol=1e-3, atol=1e-2)


def _cg_check(port, jx, key, n, bw, trajectory_slack):
    """Sharded CG == single-card CG to 1e-5 on a paper Table-2 system,
    the same trajectory (up to ``trajectory_slack`` iterations where the
    hierarchical sums add in another order), and == the JAX package's."""
    got = _ok(port[key])[(n, bw)]
    jxx, jk = jx[key][(n, bw)]
    np.testing.assert_allclose(got["x"], got["chip_x"], rtol=1e-5,
                               atol=1e-5)
    assert abs(got["k"] - got["chip_k"]) <= trajectory_slack
    np.testing.assert_allclose(got["x"], jxx, rtol=1e-5, atol=1e-5)
    assert abs(got["k"] - jk) <= 1
    a = banded_spd(n, bw, seed=n + bw).astype(np.float32)
    b = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    assert np.linalg.norm(a @ got["x"] - b) / np.linalg.norm(b) < 1e-3


class TestMeshNumerics:
    def test_mesh_spmv_matches_chip_all_layouts(self, both):
        _spmv_check(*both, "spmv_o3")

    def test_mesh_matmul_matches_chip(self, both):
        _matmul_check(*both, "matmul_o3", "mesh_psum")

    def test_mesh_fft_matches_reference(self, both):
        _fft_check(*both, "fft_o3")

    @pytest.mark.parametrize("n,bw", CG_TABLE2_O3)
    def test_mesh_cg_matches_chip_on_table2(self, both, n, bw):
        _cg_check(*both, "cg_o3", n, bw, 0)

    def test_mesh_cg_via_csr_and_ell(self, both):
        got = _ok(both[0]["cg_csr_ell"])
        for k in ("csr", "ell"):
            np.testing.assert_allclose(got[k], got["chip"], rtol=1e-5,
                                       atol=1e-5)

    def test_mesh_cg_rejects_mismatched_pin(self, both):
        raised = both[0]["mismatched_pin"]["raised"]
        assert raised is not None and raised.startswith("ValueError") \
            and "row-partitions" in raised

    def test_fft_twiddle_cache_hit_across_calls(self, both):
        currsize, hits = _ok(both[0]["twiddles"])
        assert currsize == 1 and hits >= 1

    def test_mesh_cg_backend_pin_still_runs_chip(self, both):
        got = _ok(both[0]["backend_pin"])
        assert got["pinned_sharded"] == "Tensor"       # the chip loop ran
        np.testing.assert_allclose(got["pinned"], got["auto"], rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# hierarchy: the O4 (2,2,2) mesh
# ---------------------------------------------------------------------------

class TestHierarchicalO4:
    def test_select_context_carries_topology(self, both):
        port, jx = both
        got = _ok(port["context"])
        assert (got["rank"], got["roles"], got["describe"]) == \
            jx["context"] == (3, ("pod", "data", "model"),
                              "pod2xdata2xmodel2")
        assert got["after"] == 0

    def test_o4_selects_2d_matmul_and_degrades(self, both):
        port, jx = both
        assert _ok(port["o4_matmul_names"]) == jx["o4_matmul_names"] == [
            "chip", "mesh_psum_2d", "mesh_psum", "chip", "mesh_psum"]

    def test_o4_matmul_2d_matches_chip(self, both):
        _matmul_check(*both, "matmul_o4", "mesh_psum_2d")

    def test_o4_spmv_all_layouts_match_dense(self, both):
        _spmv_check(*both, "spmv_o4")

    def test_o4_fft_matches_reference(self, both):
        _fft_check(*both, "fft_o4")

    @pytest.mark.parametrize("n,bw", CG_TABLE2_O4)
    def test_o4_cg_matches_chip_on_table2(self, both, n, bw):
        _cg_check(*both, "cg_o4", n, bw, 1)

    def test_o4_indivisible_rows_degrade(self, both):
        """250 rows % 4 (pod*data) != 0 -> chip formulation."""
        assert _ok(both[0]["o4_indivisible"]) == "ell"


# ---------------------------------------------------------------------------
# the blocked-sparse plane at mesh scope (tests/test_sparse.py:274-350)
# ---------------------------------------------------------------------------

def _spmm_check(port, jx, key, fmt):
    name, y, want = _ok(port[key])[fmt]
    jname, jy = jx[key][fmt]
    assert name == jname == "mesh_spmm"
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y, jy, rtol=1e-4, atol=1e-4)


class TestMeshSpmm:
    @pytest.mark.parametrize("fmt", ["csr", "ell", "dia"])
    def test_mesh_spmm_matches_chip(self, both, fmt):
        _spmm_check(*both, "spmm_o3", fmt)

    def test_o4_mesh_spmm_matches_chip(self, both):
        _spmm_check(*both, "spmm_o4", "auto")

    def test_bsr_and_indivisible_degrade_to_chip(self, both):
        assert _ok(both[0]["spmm_degrade"]) == ["chip", "chip"]

    def test_mesh_block_cg_matches_chip(self, both):
        got = _ok(both[0]["block_cg"])
        np.testing.assert_allclose(got["x"], got["chip_x"], rtol=1e-5,
                                   atol=1e-5)
        assert abs(got["k"] - got["chip_k"]) <= 1


class TestBlockCyclic:
    def test_perm_deals_panels_round_robin(self):
        from repro.distributed.numerics import block_cyclic_perm as jperm
        from repro_torch.distributed.numerics import block_cyclic_perm

        perm, inv = block_cyclic_perm(512, 2, 128)
        assert sorted(set(perm[:256] // 128)) == [0, 2]
        assert sorted(set(perm[256:] // 128)) == [1, 3]
        np.testing.assert_array_equal(perm[inv], np.arange(512))
        for got, want in zip((perm, inv), jperm(512, 2, 128)):
            np.testing.assert_array_equal(got, want)

    def test_perm_degenerates_gracefully(self):
        from repro_torch.distributed.numerics import block_cyclic_perm

        assert block_cyclic_perm(256, 2, 128) is None
        assert block_cyclic_perm(96, 2, 128) is None
        assert block_cyclic_perm(512, 1, 128) is None

    def test_cyclic_2d_matmul_matches_chip(self, both):
        """N = 512 over 2 model tiles: a real cyclic assignment; the
        numerics do not change."""
        _matmul_check(*both, "matmul_o4_cyclic", "mesh_psum_2d", 512)


# ---------------------------------------------------------------------------
# mesh SpGEMM (tests/test_spgemm.py:229-250)
# ---------------------------------------------------------------------------

class TestMeshSpgemm:
    def _check(self, port, jx, key):
        got = _ok(port[key])
        name, jc, want, jspec = jx[key]
        assert got["name"] == name == "mesh_spgemm" and got["same_bits"]
        np.testing.assert_allclose(got["c"], got["chip"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["c"], want, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["c"], jc, rtol=1e-5, atol=1e-4)
        assert got["spec"] == jspec
        return got

    def test_mesh8_selected_and_matches_chip(self, both):
        got = self._check(*both, "spgemm_o3")
        # the decided layout, the reference's P('data'), is the values'
        assert got["spec"] == ("data",)
        assert got["placements"] == got["values_placements"] \
            == [("Shard", 0), ("Replicate", None)]

    def test_mesh222_hierarchical_matches_chip(self, both):
        got = self._check(*both, "spgemm_o4")
        assert got["spec"] == (("pod", "data"),)

    def test_no_mesh_degrades_to_chip(self):
        import repro_torch.sparse as S
        from repro_torch.core import registry

        A, B = _blocked(128, seed=30, frac=0.35), _blocked(128, seed=31,
                                                           frac=0.35)
        a = S.bsr_from_dense(A, device="cpu")
        b = S.bsr_from_dense(B, device="cpu")
        assert registry.select("spgemm", a, b).name == "bsr_torch"

    def test_indivisible_rows_degrade_to_chip(self, both):
        got = _ok(both[0]["spgemm_indivisible"])
        assert got["name"] == "bsr_torch" and got["out_sharding"] is None
        np.testing.assert_allclose(got["c"], got["want"], rtol=1e-5,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# no process group: O3 and O4 degrade to chip with equal bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", ["O3", "O4"])
def test_no_process_group_degrades_to_chip_bitwise(level):
    """Without an initialised world, use_level(O3|O4) builds the
    one-process mesh (as the reference's (1, 1) mesh on one device):
    scope 'mesh', every mesh variant unavailable, the chip variants'
    results bit for bit, and nothing waits for a peer."""
    import torch.distributed as dist

    from repro_torch.core import ExecLevel, bind, registry, use_level
    from repro_torch.kernels import ops
    from repro_torch.numerics import solvers, sparse

    assert not dist.is_initialized()
    lvl = ExecLevel[level]
    a, b = (torch.as_tensor(v) for v in _mm_operands())
    z = torch.as_tensor(_signal())
    A, x = _banded()
    dia = sparse.dia_from_dense(A, device="cpu")
    xb = bind(x, device="cpu")
    chip = (ops.matmul(a, b), ops.fft(z),
            solvers.cg_solve(dia, xb, stop=1e-12, max_iters=512).x.data)
    with use_level(lvl) as ctx:
        sel = registry.select_context()
        assert sel.scope == "mesh" and sel.mesh_rank == 0
        assert ctx.mesh.shape == ((1, 1) if level == "O3" else (1, 1, 1))
        assert registry.select("matmul", a, b).scope == "chip"
        got = (ops.matmul(a, b), ops.fft(z),
               solvers.cg_solve(dia, xb, stop=1e-12, max_iters=512).x.data)
    for g, w in zip(got, chip):
        assert torch.equal(g, w)
