"""The port's utilities against the JAX package's: ``utils/roofline.py``
(``model_flops`` for all ten configs, ``RooflineTerms`` through
``save_jsonl``/``load_jsonl``, ``analyze`` of a step), ``utils/profile.py``
(the counterpart of ``utils/hlo.py``: ``collective_bytes``, ``count_ops``
and ``result_bytes`` on a recorded 2-rank gloo trace) and
``configs/euroben.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.utils import profile as tprof
from repro_torch.utils import roofline as troof

CONFIGS = ("qwen3-1.7b", "gemma-2b", "minicpm-2b", "phi3-mini-3.8b",
           "qwen2-vl-72b", "musicgen-medium", "qwen3-moe-30b-a3b",
           "arctic-480b", "mamba2-370m", "zamba2-7b")


def test_the_ten_configs_are_both_packages():
    from repro.configs import list_configs as jlist
    from repro_torch.configs import list_configs as tlist

    assert sorted(tlist()) == sorted(jlist()) == sorted(CONFIGS)


@pytest.mark.parametrize("name", CONFIGS)
def test_model_flops_equal_the_reference(name):
    from repro.configs import get_config as jget
    from repro.utils import roofline as jroof
    from repro_torch.configs import get_config as tget

    jc, tc = jget(name), tget(name)
    assert tc.active_param_count() == jc.active_param_count()
    for n_tokens, training in ((2048, True), (512, False), (1, True)):
        assert troof.model_flops(tc, n_tokens, training=training) == \
            jroof.model_flops(jc, n_tokens, training=training)


def _terms(mod, **kw):
    fields = dict(arch="qwen3-1.7b", shape="4x512", mesh="chip",
                  flops_per_chip=2.5e13, hbm_bytes_per_chip=9.0e10,
                  coll_bytes_per_chip=4.0e6,
                  coll_breakdown={"reduce-scatter": 4000000},
                  t_compute=2.5e13 / 989e12, t_memory=9.0e10 / 3.35e12,
                  t_collective=4.0e6 / 450e9, model_flops_total=2.1e13,
                  useful_ratio=0.84, argument_bytes=1, temp_bytes=2,
                  output_bytes=3)
    fields.update(kw)
    return mod.RooflineTerms(**fields)


def test_roofline_terms_round_trip_and_equal_the_reference(tmp_path):
    from repro.utils import roofline as jroof

    t, j = _terms(troof), _terms(jroof)
    troof.save_jsonl(str(tmp_path / "t.jsonl"), [t, _terms(troof, mesh="x")])
    back = troof.load_jsonl(str(tmp_path / "t.jsonl"))
    assert back[0] == t.to_json() and back[1]["mesh"] == "x"
    jroof.save_jsonl(str(tmp_path / "j.jsonl"), [j])
    want = jroof.load_jsonl(str(tmp_path / "j.jsonl"))[0]
    assert back[0].keys() == want.keys()
    # every field and derived term but the MFU bound, whose peak is the
    # card's (the reference's is a TPU v5e's)
    for k in want:
        if k != "mfu_bound":
            assert back[0][k] == want[k], k
    assert back[0]["dominant"] == "memory"
    assert back[0]["mfu_bound"] == pytest.approx(
        t.flops_per_chip * t.useful_ratio
        / (t.step_time * troof.H100.peak_flops))


def test_euroben_constants_equal_the_reference():
    from repro.configs import euroben as j
    from repro_torch.configs import euroben as t

    for name in ("MOD2AM_SIZES", "MOD2F_SIZES", "WESTMERE_CORE_PEAK_GFLOPS",
                 "WESTMERE_NODE_PEAK_GFLOPS"):
        assert getattr(t, name) == getattr(j, name), name


def test_analyze_counts_a_training_step():
    """A small qwen3 step on the CPU: the counted FLOPs are the aten
    products' (the 6·N·D model FLOPs are their bulk), bytes every eager
    op's, no collectives; the terms are the counts over the H100's
    rates."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import Trainer, reduce_config

    cfg = dataclasses.replace(reduce_config(get_config("qwen3-1.7b"), 0.05),
                              num_layers=1)
    tr = Trainer(cfg, device="cpu")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    batch = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    t = troof.analyze(lambda: tr.step_fn(tr.state, batch), arch=cfg.name,
                      shape="2x16", cfg=cfg, n_tokens=32, dtype="float32")
    assert t.model_flops_total == troof.model_flops(cfg, 32)
    assert 0.5 < t.useful_ratio < 1.5
    assert t.coll_bytes_per_chip == 0 and t.coll_breakdown == {}
    assert t.t_compute == t.flops_per_chip / troof.H100.peak_flops_f32
    assert t.t_memory == t.hbm_bytes_per_chip / troof.H100.hbm_bw
    # the step's parameters are read at least once
    assert t.hbm_bytes_per_chip > 4 * cfg.param_count()


def test_the_counting_pass_reckons_kernel_calls():
    """The port's kernels launch through ctypes, out of a dispatch mode's
    sight: a 'cuda' variant's call is reckoned by the registry while a
    counting pass is open (here the variant is selected on host tensors
    with the device rule patched, and runs its plain version)."""
    from repro_torch.core import costmodel, registry

    a, b = torch.ones(64, 32), torch.ones(32, 16)
    orig = registry.device_type_of
    registry.device_type_of = lambda *ops: "cuda"
    try:
        with troof.count_pass() as c:
            registry.dispatch("matmul", a, b)
    finally:
        registry.device_type_of = orig
    assert c.kernels.calls == {"matmul": (1, 2.0 * 64 * 32 * 16,
                                          4.0 * (64 * 32 + 32 * 16
                                                 + 64 * 16))}
    assert c.flops >= 2.0 * 64 * 32 * 16
    assert costmodel.COUNTING is None
    assert c.prof is None           # no process group: no trace to read
    q = torch.ones(1, 2, 8, 4)
    assert costmodel.call_flops("flash_attention", (q, q, q),
                                {"causal": True}) == 4.0 * 2 * 4 * 36


# ---------------------------------------------------------------------------
# a recorded 2-rank gloo trace
# ---------------------------------------------------------------------------

def _trace_world(rank, world):
    """Five collectives of known sizes under the profiler, and one mesh
    matmul under ``analyze``; this rank's counts."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ExecLevel, use_level
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(data=2, model=1, device_type="cpu")
    plan = tcoll_plan(mesh)
    x = torch.ones(64, 32)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        plan.psum(x)                                    # all-reduce 8192 B
        plan.psum_scatter(x)                            # reduce-scatter
        plan.all_gather(x[:16])                         # all-gather 2048 B
        plan.all_to_all(torch.ones(16, 8, dtype=torch.complex64), "data",
                        split_dim=0, concat_dim=0)      # all-to-all 1024 B
        from repro_torch.distributed.collectives import ring_plan
        ring_plan(mesh).shift(torch.ones(8))            # permute 32 B
    out = {"bytes": tprof.collective_bytes(p),
           "results": tprof.result_bytes(p),
           "count": {n: tprof.count_ops(p, n) for n in (
               "c10d::allreduce_", "c10d::_reduce_scatter_base_",
               "c10d::_allgather_base_", "c10d::alltoall_base_",
               "c10d::send", "c10d::recv_", "aten::mm")}}
    a, b = torch.ones(32, 64), torch.ones(64, 48)
    with use_level(ExecLevel.O3, mesh):
        terms = troof.analyze(lambda: ops.matmul(a, b), arch="mod2am",
                              shape="32x64x48", mesh_name="data2xmodel1",
                              n_chips=world, dtype="float32")
    out["analyze"] = (terms.flops_per_chip, terms.coll_breakdown,
                      terms.t_collective)
    dist.barrier()
    return out


def tcoll_plan(mesh):
    from repro_torch.distributed.collectives import reduce_plan

    return reduce_plan(mesh)


@pytest.fixture(scope="module")
def traces():
    from repro_torch.launch.world import run_world

    return run_world(_trace_world, 2, timeout=180)


def test_collective_bytes_of_a_recorded_trace(traces):
    for res in traces:
        assert res["bytes"] == {"all-reduce": 8192, "reduce-scatter": 8192,
                                "all-gather": 2048, "all-to-all": 1024,
                                "collective-permute": 32,
                                "total": 8192 + 8192 + 2048 + 1024 + 32}


def test_result_bytes_and_count_ops_of_a_recorded_trace(traces):
    for res in traces:
        assert res["results"] == {
            "c10d::allreduce_": 8192, "c10d::_reduce_scatter_base_": 4096,
            "c10d::_allgather_base_": 4096, "c10d::alltoall_base_": 1024,
            "c10d::send": 32, "c10d::recv_": 32}
        assert res["count"] == {
            "c10d::allreduce_": 1, "c10d::_reduce_scatter_base_": 1,
            "c10d::_allgather_base_": 1, "c10d::alltoall_base_": 1,
            "c10d::send": 1, "c10d::recv_": 1, "aten::mm": 0}


def test_analyze_reads_a_mesh_matmul(traces):
    """mesh_psum over (data 2): each rank multiplies its K half (a
    32 x 32 x 48 product on the plain plane, seen by the FLOP counter) and
    reduce-scatters the 32 x 48 f32 partial."""
    for res in traces:
        flops, coll, t_coll = res["analyze"]
        assert flops == 2.0 * 32 * 32 * 48
        assert coll == {"reduce-scatter": 32 * 48 * 4}
        assert t_coll == 32 * 48 * 4 / troof.H100.link_bw
