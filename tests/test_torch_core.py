"""The port's DSL layer (repro_torch.core) against the JAX package's
(repro.core) on the same numpy inputs, plus the port's own rules: the device
rule of bind, the registry's plane selection, O2-only execution levels, and
the package's independence from JAX."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core import registry

CPU = "cpu"


def _bind(x):
    return T.bind(x, device=CPU)


def _same(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.read(), np.asarray(want.read()),
                               rtol=rtol, atol=atol)


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    return {"m": rng.standard_normal((6, 5)).astype(np.float32),
            "v": rng.standard_normal(16).astype(np.float32),
            "w": rng.standard_normal(16).astype(np.float32),
            "c": rng.standard_normal(6).astype(np.float32)}


class TestContainers:
    def test_bind_narrows_like_jnp_asarray(self):
        for host in (np.ones(3, np.float64), np.ones(3, np.complex128),
                     np.ones(3, np.int32)):
            assert str(_bind(host).dtype).split(".")[-1] == \
                str(jnp.asarray(host).dtype)
        assert _bind(np.ones(3)).dtype == torch.float32
        assert T.bind(np.ones(3), dtype=torch.float64,
                      device=CPU).dtype == torch.float64

    def test_bind_without_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.bind(np.ones(3))
        with pytest.raises(RuntimeError):
            T.Dense.zeros(3)
        assert T.bind(np.ones(3), device=CPU).device.type == "cpu"

    def test_wrap_refuses_host_arrays(self):
        with pytest.raises(TypeError, match="bind"):
            T.wrap(np.ones(3))

    def test_elementwise_and_accessors(self, data):
        a, b = data["m"], data["m"][::-1].copy()
        A, B = _bind(a), _bind(b)
        JA, JB = J.bind(a), J.bind(b)
        for f in (lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
                  lambda x, y: x / y, lambda x, y: -x, lambda x, y: 2.0 * x,
                  lambda x, y: x @ y.T, lambda x, y: x.row(2),
                  lambda x, y: x.col(1), lambda x, y: x.T,
                  lambda x, y: x.set((1, 2), 99.0)):
            _same(f(A, B), f(JA, JB), rtol=1e-5)
        A.set((1, 2), 99.0)
        assert A.read()[1, 2] == pytest.approx(a[1, 2])   # functional write


class TestOps:
    def test_reductions(self, data):
        for name in ("add_reduce", "max_reduce", "min_reduce"):
            for axis in (None, 0, 1):
                _same(getattr(T, name)(_bind(data["m"]), axis),
                      getattr(J, name)(J.bind(data["m"]), axis), rtol=1e-5)
        _same(T.mul_reduce(_bind(data["c"])), J.mul_reduce(J.bind(data["c"])),
              rtol=1e-5)

    @pytest.mark.parametrize("start,length,stride", [(0, 8, 2), (1, 8, 2),
                                                     (3, 5, 1), (2, 4, 3)])
    def test_section(self, data, start, length, stride):
        _same(T.section(_bind(data["v"]), start, length, stride),
              J.section(J.bind(data["v"]), start, length, stride))

    def test_broadcast_replace_cat(self, data):
        v, m, c = data["v"][:5], data["m"], data["c"]
        _same(T.repeat_row(_bind(v), 3), J.repeat_row(J.bind(v), 3))
        _same(T.repeat_col(_bind(v), 3), J.repeat_col(J.bind(v), 3))
        _same(T.repeat(_bind(v), 3), J.repeat(J.bind(v), 3))
        _same(T.replace_col(_bind(m), 2, _bind(c)),
              J.replace_col(J.bind(m), 2, J.bind(c)))
        _same(T.replace_row(_bind(m), 1, _bind(v)),
              J.replace_row(J.bind(m), 1, J.bind(v)))
        _same(T.cat(_bind(v), _bind(c)), J.cat(J.bind(v), J.bind(c)))

    @pytest.mark.parametrize("offset", [2, -2, 0, 15])
    def test_shift_gather_dot(self, data, offset):
        v, w = data["v"], data["w"]
        _same(T.shift(_bind(v), offset), J.shift(J.bind(v), offset))
        idx = np.array([3, 0, 15, 3], np.int32)
        _same(T.gather(_bind(v), _bind(idx)), J.gather(J.bind(v), idx))
        _same(T.dot(_bind(v), _bind(w)), J.dot(J.bind(v), J.bind(w)),
              rtol=1e-5)


class TestControlFlow:
    @pytest.mark.parametrize("unroll", [1, 3, 4, 8, 16])
    def test_arbb_for_unroll_with_remainder(self, unroll):
        """Blocks of ``unroll`` then the remainder, visiting the same
        indices in the same order as the JAX loop."""
        def body(i, acc):
            return acc * 3 + (i + 1)

        got = T.arbb_for(2, 13, body, 0, unroll=unroll)
        want = J.arbb_for(2, 13, lambda i, a: a * 3 + (i + 1),
                          jnp.int32(0), unroll=unroll)
        assert got == int(want)
        seen = T.arbb_for(0, 11, lambda i, s: s + [i], [], step=2,
                          unroll=unroll)
        assert seen == [0, 2, 4, 6, 8, 10]

    def test_arbb_for_rejects_bad_knobs(self):
        with pytest.raises(ValueError):
            T.arbb_for(0, 4, lambda i, s: s, 0, step=0)
        with pytest.raises(ValueError):
            T.arbb_for(0, 4, lambda i, s: s, 0, unroll=0)

    def test_while_and_if(self):
        x = torch.tensor(1.0)
        out = T.arbb_while(lambda s: s < 100, lambda s: s * 2, x)
        want = J.arbb_while(lambda s: s < 100, lambda s: s * 2,
                            jnp.float32(1.0))
        assert float(out) == float(want)
        assert T.arbb_if(torch.tensor(True), lambda a: a + 1,
                         lambda a: a - 1, 5) == 6
        assert T.unrolled(3) == range(3)


class TestClosure:
    def test_emap_masked_loop_matches_vmap(self):
        """A per-element ``_for`` with data-dependent bounds runs as one
        masked loop over all elements, like JAX's vmap of a fori_loop."""
        from repro.numerics.spmv import arbb_for_dynamic as j_for
        from repro_torch.numerics.spmv import arbb_for_dynamic as t_for

        vals = np.arange(1, 11, dtype=np.float32)
        lo = np.array([0, 3, 3, 9], np.int32)
        hi = np.array([3, 3, 9, 10], np.int32)

        def make(loop, arr, zero):
            return lambda ri, rj: loop(ri, rj,
                                       lambda i, acc: acc + arr[i] * arr[i],
                                       zero)

        tv = torch.as_tensor(vals)
        got = T.emap(make(t_for, tv, torch.zeros(())), (0, 0))(
            _bind(lo), _bind(hi))
        jv = jnp.asarray(vals)
        want = J.emap(make(j_for, jv, jnp.zeros(())), (0, 0))(
            J.bind(lo), J.bind(hi))
        _same(got, want)

    def test_emap_checks_arity_and_axes(self):
        with pytest.raises(TypeError):
            T.emap(lambda a: a, (0,))(torch.ones(2), torch.ones(2))
        with pytest.raises(ValueError):
            T.emap(lambda a: a, (1,))

    def test_call_and_capture(self, data):
        f = T.call(lambda a, b: a + b)
        _same(f(_bind(data["v"]), _bind(data["w"])),
              J.call(lambda a, b: a + b)(J.bind(data["v"]), J.bind(data["w"])))
        cl = T.capture(lambda v: T.section(v, 0, 8, 2) + 1, _bind(data["v"]))
        assert cl.gather_free() and cl.op_counts()["slice"] == 1
        cl = T.capture(lambda v: T.gather(v, torch.tensor([1, 2])),
                       _bind(data["v"]))
        assert not cl.gather_free()


class TestExecLevel:
    def test_o2_only(self):
        assert T.current().level == T.ExecLevel.O2
        with T.use_level(T.ExecLevel.O2) as ctx:
            assert not ctx.is_distributed
        for level in (T.ExecLevel.O3, T.ExecLevel.O4):
            with pytest.raises(NotImplementedError, match="mesh-scope"):
                with T.use_level(level):
                    pass


class TestRegistry:
    @pytest.fixture
    def toy(self):
        calls = []
        registry.register("toy", "k", lambda x: calls.append("k") or "k",
                          plane="cuda", cost=registry.Cost.CUDA)
        registry.register("toy", "p", lambda x: calls.append("p") or "p",
                          plane="torch", cost=registry.Cost.TORCH)
        registry.register("toy", "dsl", lambda x: "dsl", cost=50.0,
                          accepts=lambda x: x.ndim == 2)
        yield calls
        registry.unregister("toy")

    def test_host_tensors_select_torch(self, toy):
        assert registry.dispatch("toy", torch.ones(3)) == "p"
        assert registry.resolve_backend(torch.ones(3)) == "torch"

    def test_explicit_variant_wins(self, toy):
        assert registry.dispatch("toy", torch.ones(3, 3), variant="dsl") \
            == "dsl"
        with registry.use_backend("torch"):
            assert registry.dispatch("toy", torch.ones(3),
                                     variant="dsl") == "dsl"

    def test_cuda_on_host_raises(self, toy):
        with registry.use_backend("cuda"):
            with pytest.raises(RuntimeError, match="host"):
                registry.dispatch("toy", torch.ones(3))
            with pytest.raises(RuntimeError, match="host"):
                registry.resolve_backend(torch.ones(3))
        with pytest.raises(RuntimeError, match="host"):
            registry.dispatch("toy", torch.ones(3), variant="k")
        assert toy == []

    def test_cuda_operands_never_fall_to_torch(self, toy):
        """On CUDA operands the torch plane is admissible only when asked
        for: without a cuda variant that accepts, selection fails rather
        than quietly running the plain version."""
        ctx = registry.SelectContext(level=T.ExecLevel.O2, device="cuda")
        table = registry.REGISTRY._table("toy")
        assert table["k"].is_available(ctx)
        assert not table["p"].is_available(ctx)
        asked = registry.SelectContext(level=T.ExecLevel.O2, device="cuda",
                                       requested="torch")
        assert table["p"].is_available(asked)
        assert registry.REGISTRY._ranked(asked, table)[0].name == "p"

    def test_registration_errors(self, toy):
        with pytest.raises(ValueError, match="duplicate"):
            registry.register("toy", "k", lambda x: x, plane="cuda")
        with pytest.raises(ValueError, match="plane"):
            registry.register("toy", "bad", lambda x: x, plane="pallas")
        with pytest.raises(ValueError):
            with registry.use_backend("xla"):
                pass
        with pytest.raises(LookupError):
            registry.dispatch("no_such_op", torch.ones(1))
        with pytest.raises(ValueError, match="no variant"):
            registry.dispatch("toy", torch.ones(1), variant="missing")

    def test_device_type_of_containers(self):
        from repro_torch.numerics import sparse
        dia = sparse.dia_from_dense(np.eye(3), device=CPU)
        assert registry.device_type_of(dia, (torch.ones(1),)) == "cpu"
        assert registry.device_type_of(_bind(np.ones(2))) == "cpu"


def test_port_imports_neither_jax_nor_repro():
    code = ("import repro_torch.numerics.solvers, repro_torch.kernels.ops, "
            "repro_torch.interop, sys; "
            "assert 'jax' not in sys.modules and not any(m == 'repro' or "
            "m.startswith('repro.') for m in sys.modules), sorted(m for m in "
            "sys.modules if m.startswith(('jax', 'repro.')))")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
