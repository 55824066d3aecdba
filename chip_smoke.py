#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sparse-shapes   # the sparse kernels' A/B hook
    python3 chip_smoke.py --backward-shapes # the backward kernels' A/B hook

1. Print the card's name and power limit, and build the CUDA kernels from
   src/repro_torch/kernels/csrc with nvcc (timed).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones: spmm_ell also with each row's
   columns shuffled, the SpMM suite's ragged rows, width 1, an inf in
   X[0, :] (NaN in the padded rows) and the same bits from two calls; both
   BSR kernels at block edges 1, 4, 8, 12, 16, 32 and 64 and at 96 (run on
   sub-blocks of 48), each bitwise from call to call; spgemm_bsr at the
   suite's clustered 0.2 case at bs 32.  The three attention backward
   kernels (fa_bwd_delta, fa_bwd_dkdv, fa_bwd_dq) through the autograd
   wrapper against flash_attention_tiles_bwd_plain: causal tiles at the
   training shape in bf16 and f32, head_dim 96, 112 and 256, a ragged
   length, a window, a bias layout and the dense grid (f32 also at 112);
   in bf16 every layout kind (also dead rows) at every head_dim; at d 112
   a dO that is zero but in columns 96-111 (a lane's fourth column), in
   both dtypes; the same bits from two backward passes.  moe_apply at
   qwen3-moe-30b-a3b's width and ssd_chunked at zamba2-7b's, each
   backward twice in bf16: the same bits (check (e) of phase g rests on
   it).  The lens and tiles kernels also at the MoE configs' heads
   (32/4 and 56/8, d 128) at the serve paths' shapes.  The three forward
   attention kernels at every head_dim a config needs: 128, phi3-mini's 96,
   zamba2's 112 (32/32) and gemma's 256, each with the tiles == dense
   causal bitwise check in f32 and bf16.  The tiles forward and the three
   backward kernels at the frontend configs' attention, in f32 and bf16:
   musicgen-medium's (24/24, GQA group 1, d 64, 768 positions) and
   qwen2-vl-72b's heads (64/8, d 128) over 1536 positions.
3. Run the paths of the port, each with data made from fixed seeds and
   validated as benchmarks/*.py does, and each with the launch counts set
   to 0 just before it and read just after; every kernel of a path must
   have launched during that path.
   a. The paper's four Euroben suites at their largest configurations:
     mod2am  n = 1024 via ops.matmul and arbb_mxm1/2a/2b (arbb_mxm0 at 256)
     mod2as  n = 10240, 5.72 % fill via ops.spmv_ell, arbb_spmv1/2
     mod2f   n = 2^20 via ops.fft and split_stream_fft
     CG      Table-2 conf 18 (n = 1024, half-bandwidth 511) with the spmv2
             and dia formulations, plus ops.spmv_dia on the same matrix
   b. The blocked-sparse plane at the suites' full sizes:
     SpMM    benchmarks/spmm.py: n = 1024, the four format classes through
             sparse.matrix (the selector must pick dia/bsr/ell/csr) and
             sparse.spmm at k = 8 and 64, max error < 1e-3
     block-CG the suite's CG_BLOCK systems (auto format: DIA), plus
             (512, 127, 8) pinned to BSR and to ELL, relative residual
             < 1e-5
     SpGEMM  benchmarks/spgemm.py: n = 2048, block 8, clustered 0.02 /
             0.08 / 0.2 and banded bw 31 / 127, relative error < 1e-3
   j. The paths of a and b at mesh scope (after b; j, k and l run in one
      world of 4 ranks, spawned once): 4 ranks on the one
      card, gloo with every collective staged through host memory (NCCL
      refuses two ranks on one card; the plans print their transports),
      over the meshes O3 (data 4), (data 2, model 2) and O4 (pod 2, data
      2): mod2am via mesh_psum and mesh_psum_2d, mod2as via mesh_csr and
      mesh_ell, mod2f via mesh_transpose, CG conf 18 through cg_mesh
      (mesh_dia, mesh_csr), SpMM at k 8 and 64 via mesh_spmm, SpGEMM (the
      clustered 0.2 case) via mesh_spgemm.  On each rank: the selected
      variant, the gathered result against the O2 result at the JAX
      suites' tolerances, one matmul launch a mesh product, mesh_psum's
      profiled collective bytes against its plan's schedule; the ranks'
      results the same bits; then, in this process (no process group),
      use_level(O3) runs chip variants with the O2 bits.  Its times are
      not scaling numbers.
   k. Serving at mesh scope (after j), 4 ranks on the one card as in j:
      (k1) ring_attention at O3, O4 and (data 2, model 2) on B 4, 16/8
      heads, L 512, d 128, bf16 and f32, zig-zag, contiguous and full,
      against the chip flash_attention at the JAX suite's tolerances, with
      the zig-zag and full launches reckoned; paged_ring_attention at O4
      against the gather variant at c's paged-decode shape; the state
      kernels against their plain versions at (k2)'s per-shard shapes
      (1024 and 2048 x 1024, 1024 x 2048; tiles and dense grid) and the
      lens state kernel over every shard's view of (k3)'s pool.  (k2)
      qwen3-1.7b whole through the Engine at O3 on one prompt of 8192
      tokens, 32 new: prefill selects ring, its last logits within (a)'s
      bound of the O2 Engine's, one generate's launches a rank held to 28
      x 2 tiles-state and 28 x 4 dense-grid.  (k3) c's requests through
      the ContinuousEngine at O3 (the pool striped over the ring): in f32
      at 2 layers token-equal to O2's; in bf16 whole the first decode
      step within (a)'s bound, launches equal to O2's, the pool a rank
      O2's pages over 4 up to the ring rounding.  Every result the same
      bits on every rank.  Not scaling numbers.
   l. Training at mesh scope (after k, in its world): (l1) ring
      attention's backward on O3 (data 4) and O4 (pod 2, data 2), each
      rank its row of B 4, 16/8 heads, L 512, d 128 (the mesh trainer's
      layout), bf16 and f32, zig-zag causal and contiguous full, against
      the chip backward on the same rows, the forward and backward
      launches a rank held to the count reckoned from the pieces; the
      backward kernels against the plain backward at (l2)'s per-shard
      shapes.  (l2) qwen3-1.7b at full width, cut to the depth the
      mesh-aware training count fits and capped at 4 layers, through
      Trainer(mesh=make_mesh(data=4)) at O3 for 4 steps of 4 x 2048
      tokens of the learnable pattern (ZeRO-1 moments, the ring forward
      and backward on the kernels, launches reckoned), against the O2
      Trainer at the same depth on rank 0: losses falling and within 2e-2
      of O2's, every rank the same parameter bits after each step, the
      moments a rank a quarter of O2's, step times, peak memory, the
      collectives' bytes (the ZeRO-1 reduce-scatter and all-gather
      against the plan) and host seconds from their trace spans; in f32 at 2 layers the
      gradients within 1e-4 of O2's and 3 steps' losses within 1e-5
      relative.  (l3) f32, 2 layers: a save at 2, a crash before step 3
      and a resume on (data 4) bitwise equal to the uninterrupted run; the
      same
      checkpoint at O2 on one rank with replan's 4 microbatches, losses
      within 1e-5.  (l4) compressed_psum over pod at O4 within one int8
      step a participant of the exact sum.  Not scaling numbers.
   m. The model axis's compute split (after l, in its world; one spawn
      for j, k, l and m): (m1) qwen3-1.7b's MLP and attention blocks at
      full width (d 2048, ff 6144, 16/8 heads of 128; B 4, L 512) in bf16
      and f32, forward and backward, split over (data 2, model 2) at O3
      (the data ring at 8/4 heads) and over (model 4) (the chip kernels
      at 4/2 heads), each against the O2 block on the rank's rows: the
      output, the input's and every parameter's gradient (the shards'
      gathered) within the JAX suites' f32 tolerance and phase l's ring
      bar in bf16, the all-reduce bytes a rank equal to the count
      reckoned from distributed/model_split.py's pairs, the attention
      launches a rank as reckoned at the local heads; the tiles, dense
      grid and lens kernels at 4/2 heads and the backward kernels at
      (m2)'s ring shard shapes at 8/4 against their plain versions.  (m2)
      qwen3-1.7b at full width cut to 4 layers through
      Trainer(mesh=make_mesh(data=2, model=2)) at O3, 3 steps of 4 x 1024
      tokens of the learnable pattern, against the O2 Trainer on rank 0:
      losses falling and within 2e-2 of O2's, the ranks at one model
      coordinate the same parameter bits after each step, parameter bytes
      a rank as reckoned from the specs, moment bytes beside O2's, step
      times, peak memory, collective bytes and host seconds by kind from
      the spans; in f32 at 2 layers the gradients within 1e-4 of O2's and
      3 losses within 1e-5 relative.  (m3) qwen3-moe-30b-a3b at full width
      cut to 2 layers, 64 experts a rank, one step at (data 2, model 2):
      the loss within 2e-2 and aux_lb within 1e-3 of O2's at the mesh's
      dispatch groups.  (m4) qwen3-1.7b whole through the Engine at O3 on
      (model 4), 4 prompts of 512, 32 new, greedy, in bf16, and in f32 at
      2 layers: the prefill's last logits within (a)'s bound of O2's
      (a-f32's in f32), tokens equal to O2's or the rows parting where
      O2's top-2 margin is 1e-3 or less in f32 and within that logit
      bound in bf16,
      tiles launches a rank one a layer and no lens launch (the fixed
      Engine's decode attends by einsum), the KV cache a rank a quarter
      of O2's, every rank the same tokens.  Not scaling numbers.
   c. Serving qwen3-1.7b at full width (28 layers, bf16, seeded random
      weights): Engine.generate on 4 prompts of 512 tokens, 32 new tokens,
      greedy (the prefill runs the tiles kernel), and ContinuousEngine.serve
      on 8 requests of 64-1024 prompt tokens and 16-64 new tokens, 4 slots,
      chunks of 128 (the tiles-state kernel and both lens kernels: decode
      for the decode steps, prefix for a chunk's prefix).  Checks: the
      Engine's prefill logits on the cuda plane against the torch plane on
      the same tensors; and, at full width in f32 with 2 layers, the
      ContinuousEngine's greedy tokens equal the fixed Engine's per request
      (a differing token must sit at a top-2 logit margin <= 1e-3).  Then
      the ContinuousEngine serves the same requests again under the span
      tracer (repro_torch.obs) with the serve and dispatch metrics reset
      and a heartbeat store: the four serve spans, serve.tokens equal to
      the tokens emitted, 8 submitted, admitted, recycled and first-token
      times, the heartbeat's step equal to the loop's iterations, the
      dispatch counters of paged_attention, chunk_attention and
      flash_attention_state equal to the lens and tiles launches, and the
      tokens bitwise equal to the untraced run's; tok/s traced and
      untraced in turns; the Chrome trace goes to chiprun_out/.
   d. Training qwen3-1.7b at full width (28 layers, bf16 parameters, f32
      AdamW moments, remat): Trainer.fit for 8 steps of 4 x 512 tokens of
      the learnable next-token pattern at lr 3e-4, each step's loss,
      grad_norm and time, tokens/s, peak memory, a profiled step and its
      roofline terms (utils.roofline.analyze: FLOPs, bytes and
      useful_ratio from one counting pass, beside the measured step); per
      step the tiles forward launches 28 x 2 times and each backward
      kernel 28 times.  Checks: (c) losses finite and the last below the
      first; (d) at 2 layers in f32, every parameter's gradient on the
      cuda plane against the torch plane; (e) at 2 layers, a save at step
      3 and a crash at 5 through TrainingSupervisor, resumed in a fresh
      state, bitwise equal to an uninterrupted run.
   e. Serving the MoE family (run after step 4, once the card is free of
      the earlier phases' models): qwen3-moe-30b-a3b at full width cut to
      12 of its 48 layers (128 experts, top-8, 8.1 B parameters in bf16
      with f32 routers) through the Engine and the ContinuousEngine
      at phase c's sizes (the tiles, tiles-state and both lens kernels),
      its decode step beside the time to read its weights once, peak
      memory and a profile with the MoE ops in a group of their own; then
      arctic-480b at full width with 2 of its 35 layers (56/8 heads)
      through both engines.  Checks: (a-moe) at 2 layers in f32 the
      prefill logits and every token's top-k expert sets in every layer,
      cuda plane against the torch plane; (f) two ContinuousEngine runs
      give the same tokens bitwise; the share of top-k sets that agree
      between the planes at that depth in bf16 is printed, not held.
   f. Serving the SSM and hybrid families (after e, once its models are
      dropped): mamba2-370m (48 layers, attention-free, f32 parameters,
      bf16 activations) and zamba2-7b (81 layers: 13 groups of 6 mamba2
      layers, each followed by the one weight-shared attention block at
      32/32 heads of 112, and a tail of 3; bf16, 6.75 B parameters), whole,
      through the Engine on 4 prompts of 512 tokens (a multiple of the SSD
      chunk, 256), 32 new, greedy: tok/s, time to first token, decode step,
      peak memory and a profile with the mamba2 work under an ``ssm``
      group; zamba2's prefill launches the tiles kernel at d 112 once per
      shared-block site (13).  Checks, in f32 at full width (mamba2 at 2
      layers, zamba2 at 7: a group and a tail of 1): (a-ssm) prefill
      logits cuda vs torch plane and (g) a 256-token prefill then 256
      teacher-forced decode steps against the 512-token prefill's last
      logits, each within 1e-3 of the largest.
   g. Training the MoE, SSM and hybrid families (after f, once its models
      are dropped), each at full width through Trainer.fit as in d (8
      steps of 4 x 512 tokens, bf16 activations, f32 AdamW moments, remat)
      and cut in depth to what one card holds beside its gradients and
      moments: qwen3-moe-30b-a3b at 3 of 48 layers, mamba2-370m whole,
      zamba2-7b at 21 of 81 (3 groups of 6 and a tail of 3).  The launches
      over the 8 steps equal the count reckoned from the code, printed
      before the run (tiles twice and each backward kernel once per
      attention site a step: 48 and 24 for qwen3-moe and zamba2, none for
      mamba2).  Checks (c), (d) and (e) as in d, at 2 layers (zamba2: 7, a
      group of 6 and a tail of 1, so that the f32 backward runs at d 112);
      for the MoE (d) first holds every top-k set equal on both planes.
   h. The VLM and audio families (after g, once its models are dropped),
      each behind its stub frontend (seeded standard-normal embeddings
      for the first frontend_len positions): qwen2-vl-72b (M-RoPE over a
      32 x 32 patch raster, 64/8 heads of 128) at full width, cut to the
      depth that the card's free memory holds beside the embeddings, two
      K/V caches and the largest transient of its checks (34-38 of 80
      layers on an H100 80GB HBM3, by what the earlier phases leave free;
      the depth and its terms are printed), and musicgen-medium
      (48 layers, 24/24 heads of 64) whole, each through the Engine on 4
      requests of the frontend (1024 patches, 256 frames) + 512 tokens,
      32 new, greedy: tok/s, time to first token, decode step against its
      weight-read bound, peak memory, a profile, tiles launches equal to
      the layers (one prefill).  Checks: (a) bf16 prefill logits cuda vs
      torch plane within 8 bf16 ulps; (a-f32) the same in f32 at 2
      layers within 1e-3 of the largest; (g-frontend) in f32 at 2 layers
      the frontend + 256 tokens' prefill and 256 teacher-forced decode
      steps against the frontend + 512 tokens' prefill, last logits within
      1e-3 (the M-RoPE decode offset).  Then musicgen-medium trains whole
      as in d (8 steps of 4 x (256 frames + 512 tokens)) with (c), (d) and
      (e), launches reckoned as there; qwen2-vl-72b's training path gets
      (d) alone, in f32 at 2 layers on 2 x (1024 + 512) positions (one of
      its layers with the embeddings is 3.37 B parameters, 87.6 GB at the
      26 bytes a parameter a training step holds: no depth trains on one
      card).
   i. Measured dispatch (last; REPRO_TORCH_* point into a temporary
      directory for the phase only): (i1) repro_torch.launch.calibrate's
      autotune sweep at the sources' sizes (matmul n 1024, spmv_ell at
      mod2as n 10240, spmv_dia and solver_spmv on CG's conf 18 in each
      container, fft 2^20, spmm n 1024 at k 8 and 64, spgemm n 2048 bs 8,
      flash_attention at the training shape causal, with a window of L/4
      and a 16-block pattern, over every candidate block the kernels
      take), printed with the H100-predicted seconds; (i2) for every
      case explain's selected variant is the one dispatch ran (its
      counter), and where calibration ranks two variants (no oracle) the
      pick is re-timed against the runner-up in turns: confirmed when it
      wins by more than the margin and the spreads, unresolved when
      neither does, and the phase fails when the runner-up does; (i3) CG
      through the calibrated formulation within phase a's residual bar, and
      attention at the measured blocks against its plain version at those
      blocks (attn_tol) and against the torch plane; (i4) every case
      re-dispatched 5 times under drift.collect() flags nothing at ratio
      4, and a matmul entry made 100x slower is flagged; (i5) host
      microseconds per dispatch (no model, a memoised model, the tracer
      on) against calling the variant's impl, and per block resolve (a
      cache hit; no cache with autotune off).
      At most 60 s.
4. Time each kernel, its plain version and the library call (CUDA events
   around each call, with the L2 scrubbed between calls so that inputs come
   from HBM), read the kernel's own device time from a torch.profiler
   trace (``kernel_ms``); lens at paged decode and at a chunk's prefix;
   spmm_ell's launches per call, and the CTAs of the three sparse kernels
   as the trace records their grids; the device time of spmm_ell at the
   path's other ELL shapes, of spmm_bsr at the path's BSR shapes, of
   spgemm_bsr at the SpGEMM suite's five cases, and of each sparse kernel
   summed over one run of phase 2b's path
   (also alone with --sparse-shapes, which a copy of this script in a
   checkout of an older commit runs to time that tree's kernels);
   the attention forward kernels also at d 96, 112 and 256 (lens decode's
   kernel time at 112 too);
   the backward kernels at the training shape, at zamba2's (B 4, 32/32,
   L 512, d 112) and at musicgen-medium's (B 4, 24/24, L 768, d 64, with
   the tiles forward beside SDPA causal) beside SDPA's backward pinned to
   one backend, and the delta kernel beside torch.linalg.vecdot (also
   alone with --backward-shapes, the same A/B hook for them);
   print what ptxas said of the kernels' registers and spills; profile a
   short window of each engine's work (device time by kernel group, the
   device's idle share); print one JSON line of kernel records.
5. Print the contract line {"ok": true, "device": {...}} last.

Any failure raises and exits nonzero before the last line.  Without a CUDA
device, or without the repository around it, it exits 1 and prints no
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth, the
# float32 FMA rate outside the tensor cores, the bf16 tensor-core rate.
# load_peaks() reads them from repro_torch.utils.roofline.H100, their one
# source, once the port is importable.
PEAK_BYTES_PER_S = PEAK_F32_FLOP_PER_S = PEAK_BF16_FLOP_PER_S = None
L2_SCRUB_BYTES = 256 << 20
#: Kernels whose ptxas report (registers, spills) the build prints; a
#: name with "Li256" or "Li112" is that head_dim's instantiations alone
#: (the first name a symbol holds wins).
PTXAS_NAMES = ("flash_attention_lens_decode_kernelIfLi112",
               "flash_attention_lens_decode_kernelI13__nv_bfloat16Li112",
               "flash_attention_lens_decode_kernel",
               "flash_attention_lens_prefix_kernelILi112",
               "flash_attention_lens_prefix_kernelILi256",
               "flash_attention_lens_prefix_kernel",
               "flash_attention_kernelIfLi112",
               "flash_attention_bf16_kernelILi112",
               "flash_attention_bf16_kernelILi256",
               "flash_attention_bf16_kernel",
               "flash_attention_tiles_kernelIfLi112",
               "flash_attention_tiles_bf16_kernelILi112",
               "flash_attention_tiles_bf16_kernelILi256",
               "flash_attention_tiles_bf16_kernel",
               "fa_bwd_delta_kernelIfLi112",
               "fa_bwd_delta_kernelI13__nv_bfloat16Li112",
               "fa_bwd_dkdv_kernelIfLi112", "fa_bwd_dq_kernelIfLi112",
               "fa_bwd_dkdv_wgmma_kernelILi112",
               "fa_bwd_dq_wgmma_kernelILi112",
               "fa_bwd_dkdv_wgmma_kernelILi256", "fa_bwd_dkdv_wgmma_kernel",
               "fa_bwd_dq_wgmma_kernelILi256", "fa_bwd_dq_wgmma_kernel",
               "fa_bwd_dkdv_kernel", "fa_bwd_dq_kernel",
               "fa_bwd_delta_kernel", "matmul_kernel",
               "spmm_ell_kernel", "spmm_bsr_kernel", "spgemm_bsr_kernel")
#: Profiler sessions a trace-read measurement tries: a session now and then
#: records no device event for a kernel that ran.
TRACE_TRIES = 3
#: BSR block edges phase 1 holds both BSR kernels at: edges the kernels
#: run as they are (1..64), and one above that the wrappers re-cut.
BSR_EDGES = (1, 4, 8, 12, 16, 32, 64, 96)


def log(*parts) -> None:
    print(*parts, flush=True)


def load_peaks() -> None:
    global PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S, PEAK_BF16_FLOP_PER_S
    from repro_torch.utils.roofline import H100

    PEAK_BYTES_PER_S = H100.hbm_bw
    PEAK_F32_FLOP_PER_S = H100.peak_flops_f32
    PEAK_BF16_FLOP_PER_S = H100.peak_flops


def bound_ms(nbytes: float, flops: float,
             peak_flops: float | None = None) -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the operations'
    at ``peak_flops`` (the f32 FMA rate unless given), in ms."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (peak_flops or PEAK_F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scrub_buffer(torch):
    """A buffer five times the H100's 50 MB L2.  Reading it all before a
    timed call leaves no line of the call's inputs in L2, so every call
    reads them from HBM and the HBM bound holds.  A read leaves clean
    lines, so the timed call pays for no write-back of the scrub."""
    return torch.ones(L2_SCRUB_BYTES // 4, device="cuda")


def time_ms(torch, fn, iters: int, scrub) -> float:
    """Mean device time of one call with a cold L2: CUDA events around each
    call alone, after a warm-up, with ``scrub`` read between calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        scrub.sum()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def kernel_ms(torch, fn, iters: int, kernel: str, scrub, launches: int = 1):
    """Device time per call of ``fn`` spent in CUDA kernels whose name holds
    ``kernel``, from a torch.profiler trace, with a cold L2 as in
    :func:`time_ms`.  Each of ``fn``'s calls launches such kernels
    ``launches`` times.  A trace may lose events: with torch 2.11 on an
    H100 one call's worth in every trace (19 of 20), more now and then.
    So a trace counts if it holds the events of all ``iters`` calls or of
    all but one, and the time is their sum over the calls they cover
    (dividing by ``iters`` would read low).  None if no trace of
    TRACE_TRIES counts.  Unlike :func:`time_ms`, this leaves out the gaps
    in which the device waits for the host to launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                scrub.sum()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if kernel in e.key and e.device_time_total > 0]
        count = sum(e.count for e in evs)
        calls, rest = divmod(count, launches)
        if not rest and iters - 1 <= calls <= iters:
            return sum(e.device_time_total for e in evs) / calls / 1e3
        seen.append(count)
    log(f"kernel_ms {kernel}: traces held {seen} events, not "
        f"{iters * launches} or one call's fewer; no time kept")
    return None


def launch_grids(torch, fn, kernel: str) -> list:
    """The grid of each launch of a CUDA kernel whose name holds ``kernel``
    in one call of ``fn``, as the torch.profiler trace records it (kineto's
    kernel events carry their launch's grid and block; the trace is read
    back from a temporary file); empty if no trace of TRACE_TRIES shows
    such a launch."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            events = json.loads(Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)
        grids = [e["args"]["grid"] for e in events
                 if e.get("cat") == "kernel" and kernel in e.get("name", "")
                 and "grid" in e.get("args", {})]
        if grids:
            return grids
    return []


def path_kernel_device_ms(torch, fn, kernels: tuple) -> dict:
    """Device time and launches of each kernel in ``kernels`` over one run
    of ``fn``, from a torch.profiler trace: {name: (ms, launches)}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for name in kernels:
        evs = [e for e in prof.key_averages() if f"{name}_kernel" in e.key
               and e.device_time_total > 0]
        out[name] = (sum(e.device_time_total for e in evs) / 1e3,
                     sum(e.count for e in evs))
    return out


def max_err(torch, got, want, rtol: float, atol: float, what: str) -> float:
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    return float((got.to(want.dtype) - want).abs().max())


# The blocked-sparse suites' inputs, with their seeds (benchmarks/spmm.py,
# benchmarks/spgemm.py; copied, since this script imports nothing of the
# JAX package).
SPMM_N = 1024
SPMM_RHS = (8, 64)
CG_BLOCK = ((256, 31, 4), (512, 63, 4), (512, 127, 8))
SPGEMM_N = 2048
SPGEMM_BLOCK = 8


def spmm_classes(sparse, n: int):
    """(label, dense f32 matrix, format the selector must pick) per class."""
    banded = sparse.banded_spd(n, 31, seed=1).astype(np.float32)
    rng = np.random.default_rng(2)
    nb, block = n // 8, 8
    blocked = np.zeros((n, n), np.float32)
    for p in rng.choice(nb * nb, size=max(1, int(nb * nb * 0.06)),
                        replace=False):
        i, j = divmod(int(p), nb)
        blocked[i * block:(i + 1) * block, j * block:(j + 1) * block] = \
            rng.standard_normal((block, block))
    rng = np.random.default_rng(3)
    uniform = np.zeros((n, n), np.float32)
    for i in range(n):
        uniform[i, rng.choice(n, size=16, replace=False)] = \
            rng.standard_normal(16)
    ragged = sparse.random_sparse(n, 2.0, seed=4).astype(np.float32)
    rng = np.random.default_rng(5)
    for i in rng.choice(n, size=4, replace=False):
        ragged[i, :] = rng.standard_normal(n)
    return (("banded", banded, "dia"), ("blocked", blocked, "bsr"),
            ("uniform", uniform, "ell"), ("ragged", ragged, "csr"))


def clustered(n: int, frac: float, seed: int,
              block: int = SPGEMM_BLOCK) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nb = n // block
    occ = rng.random((nb, nb)) < frac
    d = rng.standard_normal((n, n)).astype(np.float32)
    return np.where(np.kron(occ, np.ones((block, block), bool)),
                    d, 0.0).astype(np.float32)


def spgemm_cases(sparse, n: int):
    for frac in (0.02, 0.08, 0.2):
        yield (f"clustered_f{frac}", clustered(n, frac, 1),
               clustered(n, frac, 2))
    for bw in (31, 127):
        yield (f"banded_bw{bw}",
               sparse.banded_spd(n, bw, seed=3).astype(np.float32),
               sparse.banded_spd(n, bw, seed=4).astype(np.float32))


def random_bsr(S, torch, rng, nbrows: int, nbcols: int, bs: int,
               fill: float, empty_rows=()):
    """A random BSR on the card with the block-rows in ``empty_rows``
    empty."""
    occ = rng.random((nbrows, nbcols)) < fill
    occ[list(empty_rows)] = False
    cols, rowp = S.block_pattern(occ)
    vals = rng.standard_normal((cols.size, bs, bs)).astype(np.float32)
    dev = torch.device("cuda")
    return S.BSR(torch.as_tensor(vals, device=dev),
                 torch.as_tensor(cols, device=dev),
                 torch.as_tensor(rowp, device=dev),
                 (nbrows * bs, nbcols * bs), bs)


def spgemm_args(S, torch, a, b):
    """The numeric-phase kernel's arguments for ``a @ b`` (the plan on the
    card) and the plan."""
    plan = S.spgemm_symbolic(a, b)
    dev = a.device
    return ((a.values, a.cols, a.rowp, b.values, b.cols, b.rowp,
             torch.as_tensor(plan.c_cols, device=dev),
             torch.as_tensor(plan.c_rowp, device=dev)), plan)


def sparse_inputs():
    """The blocked-sparse path's operands on the card: the SpMM suite's
    four classes through sparse.matrix, the block-CG systems (auto format,
    then the last one pinned to BSR and to ELL) and the SpGEMM cases."""
    from repro_torch import sparse as S
    from repro_torch.numerics import sparse

    classes = spmm_classes(sparse, SPMM_N)
    cg_systems = []
    for cn, cbw, k in CG_BLOCK:
        a = sparse.banded_spd(cn, cbw, seed=cn + cbw).astype(np.float32)
        b = np.random.default_rng(cn).standard_normal((cn, k)).astype(
            np.float32)
        cg_systems.append((f"n{cn}bw{cbw}k{k}", a, b, "auto"))
    label, a, b, _ = cg_systems[-1]
    cg_systems += [(label, a, b, "bsr"), (label, a, b, "ell")]
    return {
        "classes": classes,
        "mats": {label: S.matrix(a) for label, a, _ in classes},
        "cg_systems": cg_systems,
        "cg_mats": {(label, fmt): S.matrix(a, format=fmt)
                    for label, a, _, fmt in cg_systems},
        "gemm_cases": [(case, A, B, S.bsr_from_dense(A, block=SPGEMM_BLOCK),
                        S.bsr_from_dense(B, block=SPGEMM_BLOCK))
                       for case, A, B in spgemm_cases(sparse, SPGEMM_N)],
    }


def hold_sparse_kernels(torch, inp, mod2as_ell, kernels) -> None:
    """Phase 1 for the blocked-sparse kernels.  f32 sums run in another
    order than in the plain versions (an FMA chain per output against
    einsum/bmm + index_add_).  max_abs_err is taken at the path's shapes;
    the ragged cases follow."""
    from repro_torch import sparse as S
    from repro_torch.kernels import spgemm as spgemm_k
    from repro_torch.kernels import spmm as spmm_k
    from repro_torch.numerics import sparse

    dev = torch.device("cuda")
    last = inp["cg_systems"][-1][0]
    ell_uni, ell_cg = inp["mats"]["uniform"], inp["cg_mats"][(last, "ell")]
    errs = []
    for what, m, k in (("uniform", ell_uni, 8), ("uniform", ell_uni, 64),
                       ("block-CG", ell_cg, 8), ("mod2as", mod2as_ell, 64)):
        x = torch.randn(m.shape[1], k, device=dev)
        errs.append(max_err(
            torch, spmm_k.spmm_ell(m.values, m.cols, x),
            spmm_k.spmm_ell_plain(m.values, m.cols, x), 1e-4, 1e-4,
            f"spmm_ell {what} k={k}"))
    kernels["spmm_ell"]["max_abs_err"] = max(errs)
    odd = sparse.ell_from_csr(sparse.csr_from_dense(
        sparse.random_sparse(37, 20.0, seed=37)))
    for m in (ell_uni, odd):
        for k in (1, 3, 65):
            x = torch.randn(m.shape[1], k, device=dev)
            max_err(torch, spmm_k.spmm_ell(m.values, m.cols, x),
                    spmm_k.spmm_ell_plain(m.values, m.cols, x), 1e-4, 1e-4,
                    f"spmm_ell n={m.shape[0]} k={k}")
    # the walk takes any column order: mod2as with each row's columns
    # shuffled (X swept in chunks) and the SpMM suite's ragged class (rows
    # of 2 % fill beside dense ones), at every k the path and tests use;
    # width 1
    rng = np.random.default_rng(17)
    perm = torch.as_tensor(np.argsort(rng.random(mod2as_ell.values.shape),
                                      axis=1), device=dev)
    shuffled = (mod2as_ell.values.gather(1, perm).contiguous(),
                mod2as_ell.cols.gather(1, perm).contiguous())
    ragged = sparse.ell_from_csr(sparse.csr_from_dense(
        inp["classes"][3][1], device=dev))
    one = (torch.randn(300, 1, device=dev),
           torch.randint(0, 500, (300, 1), dtype=torch.int32, device=dev))
    for what, (v, c), n in (("mod2as shuffled", shuffled, mod2as_ell.shape[1]),
                            ("ragged", (ragged.values, ragged.cols), SPMM_N),
                            ("width 1", one, 500)):
        for k in (1, 3, 8, 64, 65):
            x = torch.randn(n, k, device=dev)
            max_err(torch, spmm_k.spmm_ell(v, c, x),
                    spmm_k.spmm_ell_plain(v, c, x), 1e-4, 1e-4,
                    f"spmm_ell {what} k={k}")
    # padding adds 0 * X[0, :]: an inf there is NaN in every padded row;
    # and the same bits from two calls
    x = torch.randn(mod2as_ell.shape[1], 64, device=dev)
    x[0, 7] = float("inf")
    got = spmm_k.spmm_ell(mod2as_ell.values, mod2as_ell.cols, x)
    want = spmm_k.spmm_ell_plain(mod2as_ell.values, mod2as_ell.cols, x)
    padded = ((mod2as_ell.values == 0) & (mod2as_ell.cols == 0)).any(dim=1)
    torch.cuda.synchronize()
    if not (padded.any() and got[padded, 7].isnan().all()
            and torch.equal(got.isnan(), want.isnan())):
        raise AssertionError("spmm_ell: NaN from X[0, :] not as in the "
                             "plain version")
    x[0, 7] = 1.0
    first = spmm_k.spmm_ell(mod2as_ell.values, mod2as_ell.cols, x)
    if not torch.equal(spmm_k.spmm_ell(mod2as_ell.values, mod2as_ell.cols,
                                       x), first):
        raise AssertionError("spmm_ell: two calls on the same inputs differ")

    errs = []
    for what, m, k in (("blocked", inp["mats"]["blocked"], 8),
                       ("blocked", inp["mats"]["blocked"], 64),
                       ("clustered 0.2", inp["gemm_cases"][2][3], 64),
                       ("block-CG", inp["cg_mats"][(last, "bsr")], 8)):
        x = torch.randn(m.shape[1], k, device=dev)
        errs.append(max_err(
            torch, spmm_k.spmm_bsr(m.values, m.cols, m.rowp, x),
            spmm_k.spmm_bsr_plain(m.values, m.cols, m.rowp, x), 1e-4, 1e-4,
            f"spmm_bsr {what} bs={m.block} k={k}"))
    kernels["spmm_bsr"]["max_abs_err"] = max(errs)
    rng = np.random.default_rng(12)
    for bs in BSR_EDGES:
        m = random_bsr(S, torch, rng, 40, 30, bs, 0.2, empty_rows=(0, 17, 39))
        for k in (1, 3, 65):
            x = torch.randn(m.shape[1], k, device=dev)
            got = spmm_k.spmm_bsr(m.values, m.cols, m.rowp, x)
            max_err(torch, got,
                    spmm_k.spmm_bsr_plain(m.values, m.cols, m.rowp, x),
                    1e-4, 1e-4, f"spmm_bsr bs={bs} k={k}")
            if got[17 * bs:18 * bs].any():
                raise AssertionError(f"spmm_bsr bs={bs}: empty block-row "
                                     f"not zero")
            if not torch.equal(spmm_k.spmm_bsr(m.values, m.cols, m.rowp, x),
                               got):
                raise AssertionError(f"spmm_bsr bs={bs} k={k}: two calls "
                                     f"on the same inputs differ")
    empty = random_bsr(S, torch, rng, 4, 4, 8, 0.0)
    before = spmm_k.spmm_bsr.launches
    y = spmm_k.spmm_bsr(empty.values, empty.cols, empty.rowp,
                        torch.ones(32, 3, device=dev))
    if y.shape != (32, 3) or y.any() or spmm_k.spmm_bsr.launches != before:
        raise AssertionError("spmm_bsr with no blocks: not zeros, or it "
                             "launched")

    errs = []
    for case, _, _, a, b in inp["gemm_cases"]:
        args, _ = spgemm_args(S, torch, a, b)
        want = spgemm_k.spgemm_bsr_plain(*args, ncols=b.shape[1])
        # banded products reach O(1e4): the bar scales with the product
        scale = max(1.0, float(want.abs().max()))
        errs.append(max_err(
            torch, spgemm_k.spgemm_bsr(*args, ncols=b.shape[1]), want, 1e-5,
            1e-5 * scale, f"spgemm_bsr {case}"))
    kernels["spgemm_bsr"]["max_abs_err"] = max(errs)
    # the clustered 0.2 case again: the same bits from a second call
    args, _ = spgemm_args(S, torch, *inp["gemm_cases"][2][3:])
    first = spgemm_k.spgemm_bsr(*args, ncols=SPGEMM_N)
    if not torch.equal(spgemm_k.spgemm_bsr(*args, ncols=SPGEMM_N), first):
        raise AssertionError("spgemm_bsr: two calls on the same inputs "
                             "differ")
    for bs in BSR_EDGES:
        a = random_bsr(S, torch, rng, 24, 24, bs, 0.3, empty_rows=(3, 11))
        b = random_bsr(S, torch, rng, 24, 24, bs, 0.3, empty_rows=(5,))
        args, _ = spgemm_args(S, torch, a, b)
        max_err(torch, spgemm_k.spgemm_bsr(*args, ncols=b.shape[1]),
                spgemm_k.spgemm_bsr_plain(*args, ncols=b.shape[1]), 1e-5,
                1e-4, f"spgemm_bsr bs={bs}")
    # the suite's clustered 0.2 operands at bs 32 (a whole output row's
    # accumulator, 256 KB, is more than a CTA's shared memory): the warp
    # ranges
    A, B = (clustered(SPGEMM_N, 0.2, seed, block=32) for seed in (1, 2))
    args, _ = spgemm_args(S, torch, S.bsr_from_dense(A, block=32),
                          S.bsr_from_dense(B, block=32))
    want = spgemm_k.spgemm_bsr_plain(*args, ncols=SPGEMM_N)
    max_err(torch, spgemm_k.spgemm_bsr(*args, ncols=SPGEMM_N), want, 1e-5,
            1e-5 * max(1.0, float(want.abs().max())),
            "spgemm_bsr clustered 0.2 bs=32")
    # no pairs: A's only live block-column meets an empty block-row of B
    a = np.zeros((32, 32), np.float32)
    a[:8, :8] = 1.0
    b = np.zeros((32, 32), np.float32)
    b[8:16, :8] = 1.0
    args, plan = spgemm_args(S, torch, S.bsr_from_dense(a),
                             S.bsr_from_dense(b))
    before = spgemm_k.spgemm_bsr.launches
    c = spgemm_k.spgemm_bsr(*args, ncols=32)
    if plan.npairs or c.shape != (0, 8, 8) \
            or spgemm_k.spgemm_bsr.launches != before:
        raise AssertionError("spgemm_bsr with no pairs: wrong result")
    # a pattern that lacks a tile some product reaches: the kernel raises
    a = random_bsr(S, torch, rng, 6, 6, 8, 0.5)
    args, plan = spgemm_args(S, torch, a, a)
    row = int(np.flatnonzero(np.diff(plan.c_rowp))[0])  # first live row
    cut = int(plan.c_rowp[row + 1]) - 1                  # its last tile
    c_rowp = torch.as_tensor(plan.c_rowp, device=dev)
    c_rowp[row + 1:] -= 1
    args = args[:6] + (torch.cat((args[6][:cut], args[6][cut + 1:])), c_rowp)
    try:
        spgemm_k.spgemm_bsr(*args, ncols=48)
    except ValueError:
        pass
    else:
        raise AssertionError("spgemm_bsr took a pattern missing a tile")
    torch.cuda.synchronize()


def run_sparse_path(torch, inp, say=log) -> None:
    """Phase 2b: the blocked-sparse path through the entry points a user
    calls, validated as benchmarks/spmm.py and benchmarks/spgemm.py do;
    ``say`` takes its report lines."""
    import repro_torch.core as C
    from repro_torch import sparse as S
    from repro_torch.core import registry
    from repro_torch.numerics import solvers

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []
    for label, a, expect in inp["classes"]:
        m = inp["mats"][label]
        fmt = S.format_of(m)
        if fmt != expect:
            raise AssertionError(f"selector: {label} gave {fmt}, not "
                                 f"{expect}")
        for k in SPMM_RHS:
            x = rng.standard_normal((SPMM_N, k)).astype(np.float32)
            y = S.spmm(m, C.bind(x)).read()
            err = float(np.abs(y - a.astype(np.float64) @ x).max())
            if not err < 1e-3:
                raise AssertionError(f"spmm {label} k={k}: max error {err}")
        rows.append(f"{label}->{fmt}")
    say(f"spmm n={SPMM_N} k={SPMM_RHS}: {', '.join(rows)} ok")

    rows = []
    for label, a, b, fmt in inp["cg_systems"]:
        t = time.perf_counter()
        m = inp["cg_mats"][(label, fmt)]
        res = solvers.cg_block_solve(m, C.bind(b), stop=1e-12,
                                     max_iters=2 * a.shape[0])
        x = res.x.read()
        rel = float((np.linalg.norm(a.astype(np.float64) @ x - b, axis=0)
                     / np.linalg.norm(b, axis=0)).max())
        if not rel < 1e-5:
            raise AssertionError(f"block-CG {label} {fmt}: relative "
                                 f"residual {rel}")
        blk = f" bs={m.block}" if S.format_of(m) == "bsr" else ""
        rows.append(f"{label} {S.format_of(m)}{blk}: "
                    f"{int(res.iterations)} iters, rel {rel:.1e}, "
                    f"{time.perf_counter() - t:.2f} s")
    say("block-CG: " + "; ".join(rows))

    rows = []
    for case, A, B, a, b in inp["gemm_cases"]:
        name = registry.select("spgemm", a, b).name
        if name != "bsr":
            raise AssertionError(f"spgemm {case}: selected {name!r}")
        c = S.spgemm(a, b)
        ref = (torch.as_tensor(A, dtype=torch.float64, device=dev)
               @ torch.as_tensor(B, dtype=torch.float64, device=dev))
        got = torch.as_tensor(c.todense(), dtype=torch.float64, device=dev)
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max()) / scale
        if not err < 1e-3:
            raise AssertionError(f"spgemm {case}: relative error {err}")
        rows.append(f"{case}: {c.nblocks} blocks, rel err {err:.1e}")
    say(f"spgemm n={SPGEMM_N} block {SPGEMM_BLOCK}: " + "; ".join(rows))
    torch.cuda.synchronize()


#: The blocked-sparse path's kernels.
SPARSE_KERNELS = ("spmm_ell", "spmm_bsr", "spgemm_bsr")


def time_sparse_shapes(torch, scrub, inp) -> dict:
    """Device time per call (torch.profiler, cold L2) of spmm_ell at the
    blocked-sparse path's other ELL shapes (the SpMM suite's uniform class
    at k = 8 and 64, block-CG's ELL at k = 8), of spmm_bsr at the path's
    BSR shapes (the SpMM suite's blocked class at k = 8 and 64, block-CG's
    BSR at k = 8) and at the timed shape (the SpGEMM suite's clustered 0.2
    operand at k = 64; also through the wrapper with CUDA events, ``..
    wrapper_ms``), of spgemm_bsr at the SpGEMM suite's five cases, bs 8;
    spmm_bsr through the wrapper (CUDA events) on one matrix stored at
    edge 128 (re-cut on each call) and at edge 64, and through sparse.spmm
    (which keeps a matrix's re-cut); and each sparse kernel's device time
    and launches summed over one run of phase 2b's path (warm, as the path
    runs: ``path <kernel>`` keys).

    ``--sparse-shapes`` runs only this.  It is the A/B hook for redesigns
    of these kernels: copy this script into a checkout of an older commit
    and run it there and here in one call (old, new, new, old), so that
    both trees' kernels are timed at the same shapes on the same card."""
    from repro_torch import sparse as S
    from repro_torch.kernels import spgemm as spgemm_k
    from repro_torch.kernels import spmm as spmm_k
    from repro_torch.numerics import sparse

    dev = torch.device("cuda")
    out = {}
    uni = S.matrix(spmm_classes(sparse, SPMM_N)[2][1], format="ell")
    cn, cbw, ck = CG_BLOCK[-1]
    cg = S.matrix(sparse.banded_spd(cn, cbw, seed=cn + cbw).astype(
        np.float32), format="ell")
    for name, m, k in (("uniform_k8", uni, 8), ("uniform_k64", uni, 64),
                       ("block-CG_k8", cg, ck)):
        x = torch.randn(m.shape[1], k, device=dev)
        out[f"spmm_ell {name}"] = kernel_ms(
            torch, lambda: spmm_k.spmm_ell(m.values, m.cols, x), 50,
            "spmm_ell_kernel", scrub)
    blocked = S.matrix(spmm_classes(sparse, SPMM_N)[1][1], format="bsr")
    cg = S.matrix(sparse.banded_spd(cn, cbw, seed=cn + cbw).astype(
        np.float32), format="bsr")
    timed = S.bsr_from_dense(clustered(SPGEMM_N, 0.2, 1),
                             block=SPGEMM_BLOCK)
    for name, m, k in (("blocked_k8", blocked, 8),
                       ("blocked_k64", blocked, 64), ("block-CG_k8", cg, ck),
                       ("clustered0.2_k64", timed, 64)):
        x = torch.randn(m.shape[1], k, device=dev)
        out[f"spmm_bsr {name}"] = kernel_ms(
            torch, lambda: spmm_k.spmm_bsr(m.values, m.cols, m.rowp, x), 50,
            "spmm_bsr_kernel", scrub)
    x = torch.randn(timed.shape[1], 64, device=dev)
    out["spmm_bsr clustered0.2_k64 wrapper_ms"] = time_ms(
        torch, lambda: spmm_k.spmm_bsr(timed.values, timed.cols, timed.rowp,
                                       x), 50, scrub)
    # the clustered 0.2 pattern in 128-blocks (16 x 16 of them), stored at
    # edge 128 and at edge 64: the same matrix, so the difference is the
    # wrapper's re-cut
    wide = clustered(SPGEMM_N, 0.2, 1, block=128)
    x = torch.randn(SPGEMM_N, 64, device=dev)
    for edge in (128, 64):
        m = S.bsr_from_dense(wide, block=edge)
        try:
            out[f"spmm_bsr edge{edge}_k64 wrapper_ms"] = time_ms(
                torch, lambda: spmm_k.spmm_bsr(m.values, m.cols, m.rowp, x),
                50, scrub)
            out[f"spmm_bsr edge{edge}_k64 sparse.spmm_ms"] = time_ms(
                torch, lambda: S.spmm(m, x), 50, scrub)
        except ValueError as exc:  # a tree whose kernels refuse the edge
            log(f"spmm_bsr edge {edge}: {exc}")
    for case, A, B in spgemm_cases(sparse, SPGEMM_N):
        args, _ = spgemm_args(S, torch, S.bsr_from_dense(A, block=8),
                              S.bsr_from_dense(B, block=8))
        out[f"spgemm_bsr {case}"] = kernel_ms(
            torch, lambda: spgemm_k.spgemm_bsr(*args, ncols=SPGEMM_N), 20,
            "spgemm_bsr_kernel", scrub)
    path = path_kernel_device_ms(
        torch, lambda: run_sparse_path(torch, inp, say=lambda *_: None),
        SPARSE_KERNELS)
    for name, (ms, n) in path.items():
        out[f"path {name}"] = {"ms": ms, "launches": n}
    return out


def time_sparse_kernels(torch, inp, mod2as_csr, mod2as_ell, kernels, cold_ms,
                        csr_tensor) -> dict:
    """Phase 3 for the blocked-sparse kernels; returns the call that
    launches each kernel, for the profiler pass."""
    from repro_torch import sparse as S
    from repro_torch.kernels import spgemm as spgemm_k
    from repro_torch.kernels import spmm as spmm_k

    dev = torch.device("cuda")
    k = 64
    # spmm_ell: the mod2as Table-1 matrix times a k = 64 panel.  Bound: the
    # matrix's nonzeros (value + column; ELL's padding is storage, not work)
    # read once, X read once, Y written once, 2 flops per nonzero and column.
    vals, cols = mod2as_ell.values, mod2as_ell.cols
    n = mod2as_ell.shape[0]
    x_as = torch.randn(n, k, device=dev)
    lib_as = csr_tensor(mod2as_csr)
    nnz = mod2as_csr.nnz
    rec = kernels["spmm_ell"]
    rec["ms"] = cold_ms(lambda: spmm_k.spmm_ell(vals, cols, x_as), 50)
    rec["plain_ms"] = cold_ms(
        lambda: spmm_k.spmm_ell_plain(vals, cols, x_as), 5)
    rec["library_ms"] = cold_ms(lambda: lib_as @ x_as, 50)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        nnz * 8 + 2 * n * k * 4, 2.0 * nnz * k)
    before = spmm_k.spmm_ell.launches
    spmm_k.spmm_ell(vals, cols, x_as)
    rec["launches_per_call"] = spmm_k.spmm_ell.launches - before
    grids = launch_grids(torch, lambda: spmm_k.spmm_ell(vals, cols, x_as),
                         "spmm_ell_kernel")
    rec["ctas"] = sum(int(np.prod(g)) for g in grids) if grids else None
    part = spmm_k._ell_plan(n, vals.shape[1], n, k, vals.device)
    log(f"spmm_ell timed: n={n} width {vals.shape[1]} k={k}, traced grids "
        f"{grids}; the wrapper's plan (derived, not measured): "
        f"{part.rows} rows a CTA, X in {part.nchunks(n)} chunks of "
        f"{part.chunk} rows")

    # spmm_bsr: the SpGEMM suite's clustered 0.2 operand times k = 64.  Its
    # live blocks are dense (normal draws), so the stored entries are the
    # matrix's nonzeros.
    m = inp["gemm_cases"][2][3]
    bv, bc, br = m.values, m.cols, m.rowp
    x_bsr = torch.randn(m.shape[1], k, device=dev)
    rec = kernels["spmm_bsr"]
    rec["ms"] = cold_ms(lambda: spmm_k.spmm_bsr(bv, bc, br, x_bsr), 50)
    rec["plain_ms"] = cold_ms(
        lambda: spmm_k.spmm_bsr_plain(bv, bc, br, x_bsr), 20)
    lib_bsr = torch.sparse_bsr_tensor(br.long(), bc.long(), bv,
                                      size=m.shape, check_invariants=False)
    try:
        lib_bsr @ x_bsr
        torch.cuda.synchronize()
        note = "torch.sparse BSR @ dense"
    except (RuntimeError, NotImplementedError) as exc:
        lib_bsr = csr_tensor(S.csr_from_bsr(m))
        note = f"torch.sparse CSR @ dense (BSR @ dense refused: {exc})"
    rec["library_ms"] = cold_ms(lambda: lib_bsr @ x_bsr, 50)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        m.nnz * 4 + m.nblocks * 4 + br.numel() * 4 + 2 * m.shape[0] * k * 4,
        2.0 * m.nnz * k)
    grids = launch_grids(torch, lambda: spmm_k.spmm_bsr(bv, bc, br, x_bsr),
                         "spmm_bsr_kernel")
    rec["ctas"] = sum(int(np.prod(g)) for g in grids) if grids else None
    part = spmm_k.bsr_partition(br.numel() - 1, m.nblocks, m.block, k)
    log(f"spmm_bsr timed: n={m.shape[0]} bs={m.block} {m.nblocks} blocks "
        f"k={k}, traced grids {grids}; library call: {note}; the wrapper's "
        f"plan (derived, not measured): {part}")

    # spgemm_bsr: the clustered 0.2 A @ B, numeric phase only (the plan is
    # made once on the host).  The library call, torch.sparse CSR @ CSR,
    # also runs its own symbolic phase.
    _, _, _, a, b = inp["gemm_cases"][2]
    args, plan = spgemm_args(S, torch, a, b)
    ncols = b.shape[1]
    rec = kernels["spgemm_bsr"]
    rec["ms"] = cold_ms(lambda: spgemm_k.spgemm_bsr(*args, ncols=ncols), 20)
    rec["plain_ms"] = cold_ms(
        lambda: spgemm_k.spgemm_bsr_plain(*args, ncols=ncols), 5)
    lib_a = csr_tensor(S.csr_from_bsr(a))
    lib_b = csr_tensor(S.csr_from_bsr(b))
    rec["library_ms"] = cold_ms(lambda: lib_a @ lib_b, 10)
    bs = a.block
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (a.nblocks + b.nblocks + plan.nc) * bs * bs * 4,
        2.0 * plan.npairs * bs ** 3)
    grids = launch_grids(
        torch, lambda: spgemm_k.spgemm_bsr(*args, ncols=ncols),
        "spgemm_bsr_kernel")
    rec["ctas"] = sum(int(np.prod(g)) for g in grids) if grids else None
    log(f"spgemm_bsr timed: {plan.npairs} pairs, {plan.nc} output blocks, "
        f"{2.0 * plan.npairs * bs ** 3 / 1e6:.1f} MFLOP, traced grids "
        f"{grids} of {spgemm_k.SPGEMM_WARPS} warps (spgemm_span: "
        f"{spgemm_k.spgemm_span(bs)} block-columns a warp, derived)")
    return {"spmm_ell": lambda: spmm_k.spmm_ell(vals, cols, x_as),
            "spmm_bsr": lambda: spmm_k.spmm_bsr(bv, bc, br, x_bsr),
            "spgemm_bsr": lambda: spgemm_k.spgemm_bsr(*args, ncols=ncols)}


# -- the attention kernels and the serve path (qwen3-1.7b) --------------------

ARCH = "qwen3-1.7b"
#: Engine.generate: 4 prompts of 512 tokens, 32 new tokens, greedy.
FIXED_BATCH, FIXED_PROMPT, FIXED_NEW = 4, 512, 32
#: ContinuousEngine.serve: 8 requests (prompt tokens, new tokens), 4 slots,
#: chunks of 128, slot capacity 1152 = 9 x 128 tokens.
SERVE_REQS = ((64, 16), (1024, 64), (200, 32), (512, 48), (777, 16),
              (128, 64), (333, 24), (960, 40))
SERVE_SLOTS, SERVE_CHUNK, SERVE_MAX_LEN = 4, 128, 1152
#: The profiled windows: the Engine's prompts with 8 new tokens, and the
#: first 4 requests with 8 new tokens each through the ContinuousEngine.
PROFILE_NEW = 8
#: Timed shapes: the prefill attention (B, Hq, Hkv, L, d) and paged decode
#: (B slots, Lq = 1, capacity Lk).
ATTN_SHAPE = (4, 16, 8, 512, 128)
DECODE_B, DECODE_LK = 8, 2048
#: A prime length: every block leaves a short last tile.
PRIME_LEN = 1021
#: A chunk's prefix: one slot's 128 chunk rows against its gathered pages
#: (capacity SERVE_MAX_LEN), PREFIX_LEN of them live.
PREFIX_LEN = 1024
#: The head shapes of the repo's other configs, which need head_dim 96, 112
#: and 256: phi3-mini-3.8b (Hq/Hkv 32/32, d 96), zamba2-7b's shared block
#: (32/32, 112) and gemma-2b (8/1, 256).
HEAD_DIM_SHAPES = ((32, 32, 96), (32, 32, 112), (8, 1, 256))


def attn_inputs(torch, dtype, b, hq, hkv, lq, lk, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, device="cuda", generator=g).to(dtype)
                 for shape in ((b, hq, lq, d), (b, hkv, lk, d),
                               (b, hkv, lk, d)))


def attn_tol(torch, dtype) -> tuple[float, float]:
    """f32: the kernels sum q.k serially over d and the plain versions
    through a BLAS product, a few ulps apart.  bf16: both round P and o to
    bf16, and a last-bit difference in f32 flips a rounding: one bf16 ulp
    of the output (up to 2^-7 relative) plus 2e-3 for the P roundings."""
    if dtype == torch.float32:
        return 1e-5, 1e-5
    return 2.0 ** -7, 2e-3


def hold_attention_kernels(torch, heads) -> dict:
    """Phase 1 for the three attention kernels at the head shape ``heads``
    (Hq, Hkv, d), in f32 and bf16: the dense grid (causal and not, with and
    without state), the lens kernel (kv_len 0 to full; o, m and l compared
    on rows with a live key, m must be NEG_INF on the others), the tiles
    kernel over causal_layout, a window spec (the band path) and a
    global-token spec (the bias path), GQA groups 1 and Hq / Hkv; the serve
    path's own decode and chunk shapes and a prime length; then the bitwise
    equality of tiles and dense causal in f32 and in bf16, at the prefill
    shape and at the prime length.  Returns each kernel's largest error in
    bf16 at the widest GQA group (the dense grid non-causal, tiles over
    causal_layout, lens at the timed decode)."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import (MaskSpec, causal_layout,
                                                 compile_layout)

    b, L = ATTN_SHAPE[0], ATTN_SHAPE[3]
    hq, hkv, d = heads
    groups = sorted({1, hq // hkv})
    errs = {"flash_attention": [], "flash_attention_lens": [],
            "flash_attention_tiles": []}

    def close(got, want, dtype, what, rows=None):
        got, want = got.float(), want.float()
        if rows is not None:
            got, want = got[rows], want[rows]
        rtol, atol = attn_tol(torch, dtype)
        return max_err(torch, got, want, rtol, atol, what)

    for dtype in (torch.float32, torch.bfloat16):
        for group in groups:
            q, k, v = attn_inputs(torch, dtype, b, hq, hq // group, L, L, d,
                                  group)
            for causal in (False, True):
                got = fa_k.flash_attention(q, k, v, causal=causal,
                                           row_extents=False,
                                           return_state=True)
                want = fa_k.flash_attention_plain(q, k, v, causal=causal,
                                                  return_state=True)
                e = close(got[0], want[0], dtype,
                          f"flash_attention {dtype} d={d} g{group} "
                          f"causal={causal}")
                torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                                           atol=1e-5)
                torch.testing.assert_close(got[2], want[2], rtol=1e-5,
                                           atol=1e-5 * L)
                o = fa_k.flash_attention(q, k, v, causal=causal,
                                         row_extents=False)
                if not torch.equal(o, got[0]):
                    raise AssertionError("flash_attention: o differs with "
                                         "and without state")
                if dtype == torch.bfloat16 and group == groups[-1] and \
                        not causal:
                    errs["flash_attention"].append(e)
            for name, spec in (("causal", MaskSpec(causal=True)),
                               ("window", MaskSpec(causal=True,
                                                   window=L // 4)),
                               ("globals", MaskSpec(causal=True,
                                                    window=L // 4,
                                                    global_tokens=(0, 1,
                                                                   L // 2)))):
                lay = compile_layout(spec, L, L, 128, 128)
                got = fa_k.flash_attention_tiles(q, k, v, lay,
                                                 return_state=True)
                want = fa_k.flash_attention_tiles_plain(q, k, v, lay,
                                                        return_state=True)
                e = close(got[0], want[0], dtype,
                          f"flash_attention_tiles {name} {dtype} d={d} "
                          f"g{group}")
                torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                                           atol=1e-5)
                torch.testing.assert_close(got[2], want[2], rtol=1e-5,
                                           atol=1e-5 * L)
                if dtype == torch.bfloat16 and group == groups[-1] and \
                        name == "causal":
                    errs["flash_attention_tiles"].append(e)
        # lens: the timed decode (8 slots, Lq = 1, capacity 2048), the serve
        # path's decode (4 slots, its gathered capacity 1152), a chunk's
        # prefix (B = 1, Lq = 128 against 1152) and a prime capacity
        for bsz, lq, lk in ((DECODE_B, 1, DECODE_LK),
                            (SERVE_SLOTS, 1, SERVE_MAX_LEN),
                            (1, SERVE_CHUNK, SERVE_MAX_LEN),
                            (DECODE_B, 1, PRIME_LEN)):
            q, k, v = attn_inputs(torch, dtype, bsz, hq, hkv, lq, lk, d,
                                  lq + bsz)
            kv_len = torch.tensor([0, lk, 1, 7, lk // 2, lk - 1, 129,
                                   1000][:bsz] if bsz > 1 else [lk // 2 + 1],
                                  dtype=torch.int32, device="cuda")
            got = fa_k.flash_attention_lens(q, k, v, kv_len,
                                            return_state=True)
            want = fa_k.flash_attention_plain(q, k, v, causal=False,
                                              kv_len=kv_len,
                                              return_state=True)
            live = kv_len > 0
            if not torch.all(got[1][~live] == fa_k.NEG_INF):
                raise AssertionError("flash_attention_lens: a row with no "
                                     "live key has m != NEG_INF")
            e = close(got[0], want[0], dtype,
                      f"flash_attention_lens {dtype} d={d} B={bsz} Lq={lq} "
                      f"Lk={lk}", live)
            torch.testing.assert_close(got[1][live], want[1][live],
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got[2][live], want[2][live],
                                       rtol=1e-5, atol=1e-5 * lk)
            if dtype == torch.bfloat16 and (bsz, lk) == (DECODE_B,
                                                         DECODE_LK):
                errs["flash_attention_lens"].append(e)
        # the ContinuousEngine's chunk against itself (B = 1, 128 x 128,
        # causal, with state: the tiles walk), and the fixed Engine's
        # prefill at a prime length (short last Q and K tiles), through the
        # wrapper's routing at the full width
        for n in (SERVE_CHUNK, PRIME_LEN):
            q, k, v = attn_inputs(torch, dtype, 1, hq, hkv, n, n, d, n)
            for causal in (False, True) if n == PRIME_LEN else (True,):
                before = fa_k.flash_attention_tiles.launches
                got = fa_k.flash_attention(q, k, v, causal=causal,
                                           return_state=True)
                if causal != (fa_k.flash_attention_tiles.launches
                              == before + 1):
                    raise AssertionError("flash_attention: causal calls "
                                         "must route to the tiles walk")
                want = (fa_k.flash_attention_tiles_plain(
                    q, k, v, causal_layout(n, n, 128, 128),
                    return_state=True) if causal else
                    fa_k.flash_attention_plain(q, k, v, causal=False,
                                               return_state=True))
                close(got[0], want[0], dtype,
                      f"flash_attention L={n} causal={causal} {dtype} "
                      f"d={d}")
                torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                                           atol=1e-5)
    # the f32 bitwise property (the JAX package's
    # test_causal_row_extents_bitwise_parity), and its bf16 counterpart:
    # both bf16 kernels fold through tc::fold_rows
    for dtype in (torch.float32, torch.bfloat16):
        for bsz, n in ((b, L), (1, PRIME_LEN)):
            q, k, v = attn_inputs(torch, dtype, bsz, hq, hkv, n, n, d, 7)
            tiles = fa_k.flash_attention_tiles(
                q, k, v, causal_layout(n, n, 128, 128), return_state=True)
            dense = fa_k.flash_attention(q, k, v, causal=True,
                                         row_extents=False,
                                         return_state=True)
            if not all(torch.equal(t, g) for t, g in zip(tiles, dense)):
                raise AssertionError(f"tiles over causal_layout are not "
                                     f"bitwise equal to the dense causal "
                                     f"grid in {dtype} at L={n}, d={d}")
    torch.cuda.synchronize()
    return {name: max(e) for name, e in errs.items()}


#: The MoE configs' heads at d 128: qwen3-moe-30b-a3b's 32/4 (GQA group 8)
#: and arctic-480b's 56/8 (group 7, which the lens row blocks of 4, 16, 64
#: and 128 rows do not divide).
MOE_HEADS = ((32, 4, 128), (56, 8, 128))


def hold_moe_heads(torch, heads) -> None:
    """Phase 1 for rows 9 and 10 at an MoE config's heads (Hq, Hkv, d), in
    f32 and bf16: lens at the ContinuousEngine's decode (4 slots, capacity
    SERVE_MAX_LEN, kv_len 0 to full) and at a chunk's prefix (128 rows
    against SERVE_MAX_LEN, 1000 live), o, m and l on rows with a live key;
    tiles over causal_layout with state at the Engine's prefill (4 x 512)
    and at a chunk's own keys (1 x 128)."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import causal_layout

    hq, hkv, d = heads
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = attn_tol(torch, dtype)
        for bsz, lq in ((SERVE_SLOTS, 1), (1, SERVE_CHUNK)):
            lk = SERVE_MAX_LEN
            q, k, v = attn_inputs(torch, dtype, bsz, hq, hkv, lq, lk, d,
                                  hq + lq)
            kv_len = torch.tensor([0, lk, 517, 1][:bsz] if bsz > 1
                                  else [1000], dtype=torch.int32,
                                  device="cuda")
            got = fa_k.flash_attention_lens(q, k, v, kv_len,
                                            return_state=True)
            want = fa_k.flash_attention_plain(q, k, v, causal=False,
                                              kv_len=kv_len,
                                              return_state=True)
            live = kv_len > 0
            if not torch.all(got[1][~live] == fa_k.NEG_INF):
                raise AssertionError("flash_attention_lens: a row with no "
                                     "live key has m != NEG_INF")
            what = f"flash_attention_lens {dtype} {hq}/{hkv} B={bsz} Lq={lq}"
            max_err(torch, got[0][live].float(), want[0][live].float(), rtol,
                    atol, what)
            torch.testing.assert_close(got[1][live], want[1][live],
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got[2][live], want[2][live],
                                       rtol=1e-5, atol=1e-5 * lk)
        for bsz, n in ((FIXED_BATCH, FIXED_PROMPT), (1, SERVE_CHUNK)):
            q, k, v = attn_inputs(torch, dtype, bsz, hq, hkv, n, n, d, hq + n)
            lay = causal_layout(n, n, 128, 128)
            got = fa_k.flash_attention_tiles(q, k, v, lay, return_state=True)
            want = fa_k.flash_attention_tiles_plain(q, k, v, lay,
                                                    return_state=True)
            max_err(torch, got[0].float(), want[0].float(), rtol, atol,
                    f"flash_attention_tiles {dtype} {hq}/{hkv} B={bsz} L={n}")
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got[2], want[2], rtol=1e-5,
                                       atol=1e-5 * n)
    torch.cuda.synchronize()


#: The frontend configs' attention (B, Hq, Hkv, L, d): musicgen-medium's
#: training shape (24/24, GQA group 1, 256 frame + 512 text positions, d 64)
#: and qwen2-vl-72b's prefill heads (64/8 over 1024 patch + 512 text
#: positions, d 128; B 1 keeps the f32 plain backward small).
FRONTEND_ATTN = ((4, 24, 24, 768, 64), (1, 64, 8, 1536, 128))


def hold_frontend_heads(torch) -> None:
    """Phase 1 for the tiles forward at the frontend configs' attention
    (FRONTEND_ATTN), in f32 and bf16: over causal_layout with state, one
    launch a call, o, m and l against the plain version (their backward is
    among hold_backward_kernels' cases)."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import causal_layout

    for b, hq, hkv, n, d in FRONTEND_ATTN:
        lay = causal_layout(n, n, 128, 128)
        for dtype in (torch.float32, torch.bfloat16):
            rtol, atol = attn_tol(torch, dtype)
            q, k, v = attn_inputs(torch, dtype, b, hq, hkv, n, n, d, hq + d)
            before = fa_k.flash_attention_tiles.launches
            got = fa_k.flash_attention_tiles(q, k, v, lay, return_state=True)
            if fa_k.flash_attention_tiles.launches != before + 1:
                raise AssertionError("flash_attention_tiles: not one launch")
            want = fa_k.flash_attention_tiles_plain(q, k, v, lay,
                                                    return_state=True)
            e = max_err(torch, got[0].float(), want[0].float(), rtol, atol,
                        f"flash_attention_tiles {dtype} {hq}/{hkv} B={b} "
                        f"L={n} d={d}")
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got[2], want[2], rtol=1e-5,
                                       atol=1e-5 * n)
            log(f"tiles forward {str(dtype)[6:]} {hq}/{hkv} B={b} L={n} "
                f"d={d}: max |err| o {e:.3g} (bar rtol {rtol:.3g}, atol "
                f"{atol:g})")
    torch.cuda.synchronize()


def serve_requests(vocab: int):
    rng = np.random.default_rng(13)
    return [(rng.integers(0, vocab, size=n).astype(np.int32), m)
            for n, m in SERVE_REQS]


def bind_package_helpers() -> None:
    """Bind the package's trace helpers (``repro_torch.utils.profile``:
    device time by kernel group; ``utils.roofline.analyze``) as this
    script's globals, once ``src`` is on the path."""
    global analyze, device_breakdown, fmt_breakdown
    from repro_torch.utils.profile import device_breakdown, fmt_breakdown
    from repro_torch.utils.roofline import analyze


#: Where phase 2c's traced run saves its Chrome trace (gitignored).
TRACE_PATH = ROOT / "chiprun_out" / "phase2c_serve_trace.json"


def trace_serve(torch, lm, params, reqs, untraced, untraced_s, wrappers,
                reset, read) -> dict:
    """Phase 2c's second ContinuousEngine run: the same requests under
    ``TRACER.tracing()``, the serve and dispatch metrics reset, a heartbeat
    store.  Checks the span names, the serve counters against the requests,
    the heartbeat step against the loop's iterations, the dispatch counters
    against the kernel launch counts, and the tokens bitwise against the
    untraced run; then serves once more untraced and traced, for tok/s in
    turns.  Returns the runs' numbers."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.runtime.fault_tolerance import HeartbeatStore
    from repro_torch.serve import ContinuousEngine, SamplingParams

    tracer, m = obs_trace.TRACER, obs_metrics.METRICS

    def serve_once(traced: bool, beats=None):
        ce = ContinuousEngine(lm, params, num_slots=SERVE_SLOTS,
                              max_len=SERVE_MAX_LEN, chunk_size=SERVE_CHUNK,
                              sampling=SamplingParams(greedy=True),
                              heartbeats=beats)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with tracer.tracing() if traced else contextlib.nullcontext():
            got, stats = ce.serve(reqs, collect_stats=True)
            torch.cuda.synchronize()
        return got, stats, time.perf_counter() - t

    beats = HeartbeatStore()
    tracer.clear()
    m.reset("serve.")
    m.reset("dispatch.")
    lens_kernels = wrappers["flash_attention_lens"].kernels
    reset()
    got, stats, traced_s = serve_once(True, beats)
    out = {"s": traced_s, "launches": read(),
           "lens_kernels": dict(lens_kernels), "events": len(tracer),
           "dropped": tracer.dropped}
    ntok = sum(len(x) for x in got)
    out["iters"] = len(stats.iter_times)
    TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
    tracer.save(str(TRACE_PATH))
    names = {e["name"] for e in tracer.events()}
    snap = m.snapshot()
    tracer.clear()
    # tok/s in turns: the measured untraced run, the checked traced one,
    # then one more of each (fresh engines; the host's clock moves between
    # runs more than the tracer costs)
    again = [serve_once(False), serve_once(True)]
    tracer.clear()
    out["untraced_tok_s"] = [ntok / untraced_s, ntok / again[0][2]]
    out["tok_s"] = [ntok / traced_s, ntok / again[1][2]]
    count = {k: int(v["value"]) for k, v in snap.items()
             if k.startswith("dispatch.") and v["type"] == "counter"}
    out["dispatch"] = count
    bad = []
    spans = ("serve.admit", "serve.prefill_chunk", "serve.decode",
             "serve.demux")
    bad += [f"span {n} missing" for n in spans if n not in names]
    if out["dropped"]:
        bad.append(f"{out['dropped']} trace events dropped")
    if int(snap["serve.tokens"]["value"]) != ntok:
        bad.append(f"serve.tokens {snap['serve.tokens']['value']} != {ntok}")
    for name in ("serve.submitted", "serve.admitted", "serve.recycled"):
        if int(snap[name]["value"]) != len(reqs):
            bad.append(f"{name} {snap[name]['value']} != {len(reqs)}")
    if snap["serve.ttft_s"]["count"] != len(reqs):
        bad.append(f"serve.ttft_s count {snap['serve.ttft_s']['count']}")
    beat = beats.all()[0]
    if beat.step != out["iters"] or beat.occupancy is None:
        bad.append(f"heartbeat step {beat.step} != {out['iters']} "
                   f"iterations")
    # models/attention.py: the ContinuousEngine's decode dispatches
    # paged_attention once a layer (gather: flash_attention_state pinned
    # to cuda with kv_len, the lens decode kernel); its prefill chunks
    # dispatch chunk_attention once a layer (merge: two pinned
    # flash_attention_state calls, the lens prefix kernel for the prefix
    # and the tiles state kernel for the chunk); it never dispatches the
    # full-sequence flash_attention.
    lens = out["lens_kernels"]
    tiles = out["launches"]["flash_attention_tiles"]
    relation = {
        "dispatch.paged_attention.gather == lens decode":
            (count.get("dispatch.paged_attention.gather", 0),
             lens["decode"]),
        "dispatch.chunk_attention.merge == lens prefix":
            (count.get("dispatch.chunk_attention.merge", 0), lens["prefix"]),
        "dispatch.chunk_attention.merge == tiles":
            (count.get("dispatch.chunk_attention.merge", 0), tiles),
        "dispatch.flash_attention_state.cuda == lens + tiles":
            (count.get("dispatch.flash_attention_state.cuda", 0),
             out["launches"]["flash_attention_lens"] + tiles),
        "dispatch.flash_attention.* == dense grid launches":
            (sum(v for k, v in count.items()
                 if k.startswith("dispatch.flash_attention.")),
             out["launches"]["flash_attention"]),
    }
    out["relation"] = relation
    bad += [f"{k}: {a} != {b}" for k, (a, b) in relation.items() if a != b]
    if any(v == 0 for v, _ in list(relation.values())[:3]):
        bad.append("a serve attention op was never dispatched")
    out["bitwise"] = min(sum(np.array_equal(a, b) for a, b in
                             zip(run, untraced))
                         for run in (got, again[0][0], again[1][0]))
    if out["bitwise"] != len(reqs):
        bad.append(f"traced tokens equal the untraced run on "
                   f"{out['bitwise']}/{len(reqs)} requests")
    if bad:
        raise AssertionError("phase 2c traced run: " + "; ".join(bad))
    return out



def run_serve_path(torch, wrappers) -> dict:
    """Phase 2c: qwen3-1.7b at full width in bf16 through both engines
    (launch counts reset just before each engine's measured run and read
    just after it), a profile of each engine's run, then checks (a) and
    (b).  Returns the path's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core import registry
    from repro_torch.models.lm import LM
    from repro_torch.serve import ContinuousEngine, Engine, SamplingParams

    cfg = get_config(ARCH)
    lm = LM(cfg)

    lens_kernels = wrappers["flash_attention_lens"].kernels

    def reset():
        for w in wrappers.values():
            w.launches = 0
        for kind in lens_kernels:
            lens_kernels[kind] = 0

    def read():
        return {k: w.launches for k, w in wrappers.items()}

    t = time.perf_counter()
    params = lm.init(0, device="cuda")
    torch.cuda.synchronize()

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(x) for x in tree.values())
        if isinstance(tree, list):
            return sum(count(x) for x in tree)
        return tree.numel()

    out = {"init_s": time.perf_counter() - t, "params": count(params)}
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (FIXED_BATCH, FIXED_PROMPT),
                            generator=g, device="cuda")
    greedy = SamplingParams(greedy=True)
    eng = Engine(lm, params, max_len=FIXED_PROMPT + FIXED_NEW,
                 sampling=greedy)
    eng.generate(prompts[:, :64], max_new_tokens=2)        # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = eng.generate(prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    out["fixed_ttft_s"] = time.perf_counter() - t
    reset()
    t = time.perf_counter()
    toks = eng.generate(prompts, max_new_tokens=FIXED_NEW)
    torch.cuda.synchronize()
    out["fixed_s"] = time.perf_counter() - t
    out["fixed_launches"] = read()
    out["fixed_step_s"] = (out["fixed_s"] - out["fixed_ttft_s"]) / (
        FIXED_NEW - 1)
    out["fixed_tok_s"] = FIXED_BATCH * FIXED_NEW / out["fixed_s"]
    if toks.shape != (FIXED_BATCH, FIXED_NEW) or not torch.equal(
            toks[:, :1], first) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"Engine.generate: bad tokens {toks.shape}")

    reqs = serve_requests(cfg.vocab_size)
    ce = ContinuousEngine(lm, params, num_slots=SERVE_SLOTS,
                          max_len=SERVE_MAX_LEN, chunk_size=SERVE_CHUNK,
                          sampling=greedy)
    torch.cuda.synchronize()
    reset()
    t = time.perf_counter()
    got, stats = ce.serve(reqs, collect_stats=True)
    torch.cuda.synchronize()
    out["cont_s"] = time.perf_counter() - t
    out["cont_launches"] = read()
    out["cont_lens_kernels"] = dict(lens_kernels)
    ntok = sum(len(x) for x in got)
    if [len(x) for x in got] != [m for _, m in reqs] or len(
            ce.decode_inputs) != 1:
        raise AssertionError(f"ContinuousEngine.serve: lengths "
                             f"{[len(x) for x in got]}, decode input "
                             f"signatures {len(ce.decode_inputs)}")
    out["cont_tok_s"] = ntok / out["cont_s"]
    out["cont_ttft_s"] = float(np.mean(stats.first_token_times))
    out["cont_iter_s"] = out["cont_s"] / len(stats.iter_times)
    out["cont_iters"] = len(stats.iter_times)
    out["launches"] = {k: out["fixed_launches"][k] + out["cont_launches"][k]
                       for k in wrappers}
    out["traced"] = trace_serve(torch, lm, params, reqs, got, out["cont_s"],
                                wrappers, reset, read)
    out["launches"] = {k: out["launches"][k]
                       + out["traced"]["launches"][k] for k in wrappers}

    # where the device time goes, on a shorter window of each engine's
    # work (a trace of the whole serve holds ~10^5 kernels and takes
    # minutes); the caller runs it after the kernel timings, whose
    # profiler traces lose events after a large trace
    sub = [(p, PROFILE_NEW) for p, _ in reqs[:SERVE_SLOTS]]
    out["profile"] = lambda: (
        device_breakdown(lambda: eng.generate(
            prompts, max_new_tokens=PROFILE_NEW)),
        device_breakdown(lambda: ContinuousEngine(
            lm, params, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
            chunk_size=SERVE_CHUNK, sampling=greedy).serve(sub)))

    # (a) prefill logits, cuda plane against the torch plane
    logits, _ = lm.prefill(params, prompts)
    with registry.use_backend("torch"):
        plain, _ = lm.prefill(params, prompts)
    diff = (logits.float() - plain.float()).abs()
    scale = float(plain.float().abs().max())
    out["a_max_abs"], out["a_scale"] = float(diff.max()), scale
    out["a_argmax_agree"] = float(
        (logits.argmax(-1) == plain.argmax(-1)).float().mean())
    # bf16 keeps 8 bits: over 28 layers the two planes round P and o at
    # different places, so the logits drift apart by a few bf16 ulps of
    # their scale (2^-8 relative each); 8 ulps bounds it.
    if not out["a_max_abs"] <= 8 * 2.0 ** -8 * scale:
        raise AssertionError(f"(a) prefill logits: max |cuda - torch| "
                             f"{out['a_max_abs']} above 8 bf16 ulps of "
                             f"{scale}")

    # (b) f32 at full width, 2 layers: continuous == fixed, per request
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                param_dtype="float32")
    lm32 = LM(cfg32)
    p32 = lm32.init(0, device="cuda")
    fixed = Engine(lm32, p32, max_len=SERVE_MAX_LEN, sampling=greedy)
    want = [fixed.generate(torch.as_tensor(p[None], device="cuda"),
                           max_new_tokens=m)[0].tolist() for p, m in reqs]
    cont = ContinuousEngine(lm32, p32, num_slots=SERVE_SLOTS,
                            max_len=SERVE_MAX_LEN, chunk_size=SERVE_CHUNK,
                            sampling=greedy).serve(reqs)
    out["b_equal"], out["b_margins"] = 0, []
    for (p, m), w, c in zip(reqs, want, cont):
        c = c.tolist()
        if c == w:
            out["b_equal"] += 1
            continue
        i = next(j for j in range(m) if c[j] != w[j])
        seq = torch.as_tensor(np.concatenate([p, np.asarray(w[:i],
                                                             np.int32)]),
                              device="cuda")
        lg, _ = lm32.prefill(p32, seq[None])
        top = torch.topk(lg[0].float(), 2).values
        margin = float(top[0] - top[1])
        out["b_margins"].append(margin)
        log(f"(b) request of {len(p)} tokens: first divergence at token {i} "
            f"({c[i]} vs {w[i]}), top-2 logit margin {margin:.3e}")
        if margin > 1e-3:
            raise AssertionError("(b) continuous and fixed engines differ "
                                 "at a margin above 1e-3")
    del p32
    torch.cuda.empty_cache()
    return out


def time_attention_kernels(torch, kernels, cold_ms):
    """Phase 3 for the attention kernels, bf16: row 8 at the prefill shape
    non-causal, row 10 at the same shape causal (the prefill), row 9 at
    paged decode (8 slots, Lq = 1, capacity 2048, kv_len spread over
    1..2048; the decode kernel) and at a chunk's prefix (B 1, Lq 128
    against capacity 1152, PREFIX_LEN live keys; the prefix kernel, its
    numbers under ``prefix_*``).  Bound: the larger of q, k, v, o (and m,
    l) bytes at HBM rate and 4 * B * Hq * (live query-key pairs) * d flops
    at the bf16 tensor-core rate.  Library: scaled_dot_product_attention on
    the same inputs (timed only).  Returns the call that launches each
    kernel, the lens prefix call and the lens decode call at d 112, for
    the profiler pass."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import causal_layout

    b, hq, hkv, L, d = ATTN_SHAPE

    def calls_at(hd):
        """Each kernel's call, plain version, library call, bytes and flops
        at the timed shapes with head_dim hd."""
        q, k, v = attn_inputs(torch, torch.bfloat16, b, hq, hkv, L, L, hd,
                              21)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        lay = causal_layout(L, L, 128, 128)
        qd, kd, vd = attn_inputs(torch, torch.bfloat16, DECODE_B, hq, hkv, 1,
                                 DECODE_LK, hd, 22)
        return {
            "flash_attention": (
                lambda: fa_k.flash_attention(q, k, v, causal=False),
                lambda: fa_k.flash_attention_plain(q, k, v, causal=False),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       enable_gqa=True),
                nbytes, 4.0 * b * hq * L * L * hd),
            "flash_attention_tiles": (
                lambda: fa_k.flash_attention_tiles(q, k, v, lay),
                lambda: fa_k.flash_attention_tiles_plain(q, k, v, lay),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                nbytes, 4.0 * b * hq * (L * (L + 1) // 2) * hd),
            "flash_attention_lens": (
                lambda: fa_k.flash_attention_lens(qd, kd, vd, kv_len,
                                                  return_state=True),
                lambda: fa_k.flash_attention_plain(
                    qd, kd, vd, causal=False, kv_len=kv_len,
                    return_state=True),
                lambda: F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=mask, enable_gqa=True),
                # q, o; the live keys and values; m, l
                2 * 2 * qd.numel() + 2 * 2 * live * hkv * hd
                + 8 * DECODE_B * hq,
                4.0 * hq * live * hd),
        }

    kv_len = torch.linspace(1, DECODE_LK, DECODE_B, device="cuda").round().to(
        torch.int32)
    live = int(kv_len.sum())
    mask = (torch.arange(DECODE_LK, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    timed = {}
    for name, (kern, plain, lib, nb, flops) in calls_at(d).items():
        rec = kernels[name]
        rec["ms"] = cold_ms(kern, 50)
        rec["plain_ms"] = cold_ms(plain, 5)
        rec["library_ms"] = cold_ms(lib, 50)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nb, flops,
                                                    PEAK_BF16_FLOP_PER_S)
        timed[name] = kern
    # the same shapes at the other configs' head sizes (kernel and library
    # call; their bound), under d96_*, d112_* and d256_*
    for hd in (96, 112, 256):
        for name, (kern, _, lib, nb, flops) in calls_at(hd).items():
            rec = kernels[name]
            if (hd, name) == (112, "flash_attention_lens"):
                lens112 = kern
            rec[f"d{hd}_ms"] = cold_ms(kern, 50)
            rec[f"d{hd}_library_ms"] = cold_ms(lib, 50)
            rec[f"d{hd}_bound_ms"], _ = bound_ms(nb, flops,
                                                 PEAK_BF16_FLOP_PER_S)
    qp, kp, vp = attn_inputs(torch, torch.bfloat16, 1, hq, hkv, SERVE_CHUNK,
                             SERVE_MAX_LEN, d, 23)
    plen = torch.tensor([PREFIX_LEN], dtype=torch.int32, device="cuda")
    pmask = (torch.arange(SERVE_MAX_LEN, device="cuda")
             < PREFIX_LEN)[None, None, None, :]

    def prefix():
        return fa_k.flash_attention_lens(qp, kp, vp, plen, return_state=True)

    rec = kernels["flash_attention_lens"]
    rec["prefix_ms"] = cold_ms(prefix, 50)
    rec["prefix_plain_ms"] = cold_ms(lambda: fa_k.flash_attention_plain(
        qp, kp, vp, causal=False, kv_len=plen, return_state=True), 5)
    rec["prefix_library_ms"] = cold_ms(
        lambda: F.scaled_dot_product_attention(qp, kp, vp, attn_mask=pmask,
                                               enable_gqa=True), 50)
    rec["prefix_bound_ms"], rec["prefix_bound_by"] = bound_ms(
        2 * 2 * qp.numel() + 2 * 2 * PREFIX_LEN * hkv * d
        + 8 * hq * SERVE_CHUNK, 4.0 * hq * SERVE_CHUNK * PREFIX_LEN * d,
        PEAK_BF16_FLOP_PER_S)
    log(f"attention timed: bf16, prefill B={b} Hq/Hkv={hq}/{hkv} L={L} d={d};"
        f" decode B={DECODE_B} Lk={DECODE_LK} kv_len {kv_len.tolist()}; "
        f"prefix Lq={SERVE_CHUNK} Lk={SERVE_MAX_LEN} kv_len {PREFIX_LEN}")
    return timed, prefix, lens112


def time_tiles_d64(torch, kernels, cold_ms):
    """Phase 3 for the tiles forward at musicgen-medium's training
    attention (D64_SHAPE: B 4, 24/24, L 768, d 64), bf16, causal, under
    ``d64_*`` on its record: the wrapper, the plain version, SDPA causal
    (timed only) and the bound (q, k, v, o once at the HBM rate against 4
    flops a live pair and d at the bf16 tensor-core rate).  Returns the
    wrapper's call."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import causal_layout

    b, hq, hkv, L, d = D64_SHAPE
    q, k, v = attn_inputs(torch, torch.bfloat16, b, hq, hkv, L, L, d, 24)
    lay = causal_layout(L, L, 128, 128)
    rec = kernels["flash_attention_tiles"]

    def kern():
        return fa_k.flash_attention_tiles(q, k, v, lay)

    rec["d64_ms"] = cold_ms(kern, 50)
    rec["d64_plain_ms"] = cold_ms(
        lambda: fa_k.flash_attention_tiles_plain(q, k, v, lay), 5)
    rec["d64_library_ms"] = cold_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50)
    rec["d64_bound_ms"], rec["d64_bound_by"] = bound_ms(
        2 * (2 * q.numel() + k.numel() + v.numel()),
        4.0 * b * hq * (L * (L + 1) // 2) * d, PEAK_BF16_FLOP_PER_S)
    return kern


# -- the attention backward (fa_bwd_delta, fa_bwd_dkdv, fa_bwd_dq) ----------

BWD_KERNELS = ("fa_bwd_delta", "fa_bwd_dkdv", "fa_bwd_dq")
#: The backend SDPA's backward is pinned to where it is timed as the
#: backward kernels' library call, so that the column means one thing from
#: run to run (tests/test_torch_kernels.py pins the same one).
SDPA_BACKEND = "FLASH_ATTENTION"
#: What the backward kernels' symbols hold (both dtypes' kernels).
BWD_SYMBOLS = {"fa_bwd_delta": "fa_bwd_delta_kernel",
               "fa_bwd_dkdv": "fa_bwd_dkdv_", "fa_bwd_dq": "fa_bwd_dq_"}


def bwd_tol(torch, dtype) -> tuple[float, float]:
    """Gradient bars, relative and (times the plain gradient's largest
    entry, at least 1) absolute.  f32: the kernels and the plain backward
    sum in other orders, a few ulps apart.  bf16: both round f32 sums to
    bf16 and a last-bit difference flips a rounding: two bf16 ulps
    relative (2^-7), and 2e-3 absolute, as attn_tol for outputs of size
    1."""
    if dtype == torch.float32:
        return 1e-5, 1e-5
    return 2.0 ** -7, 2e-3


def bwd_layout(kind: str, L: int):
    """The layout a phase-1 backward case walks, and its forward call:
    "grid" the dense grid; causal tiles; a causal window; "bias" global
    tokens (their PARTIAL tiles carry bias tiles); "deadrow" a causal
    pattern of 64-row blocks with block rows 2-4 dead (a dead Q tile at L
    >= 384, and dead rows inside a live one's bias tiles)."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import (MaskSpec, causal_layout,
                                                 compile_layout, grid_layout)

    if kind == "grid":
        lay = grid_layout(L, L, 128, 128, False)
        return lay, lambda q, k, v, **kw: fa_k.flash_attention(
            q, k, v, causal=False, row_extents=False, **kw)
    if kind == "causal":
        lay = causal_layout(L, L, 128, 128)
    elif kind == "window":
        lay = compile_layout(MaskSpec(causal=True, window=L // 4), L, L, 128,
                             128)
    elif kind == "bias":
        lay = compile_layout(MaskSpec(causal=True, window=L // 4,
                                      global_tokens=(0, 1, L // 2)), L, L,
                             128, 128)
    else:   # "deadrow"
        blocks = np.tril(np.ones((L // 64, L // 64), bool))
        blocks[2:5] = False
        lay = compile_layout(MaskSpec.from_block_mask(blocks, 64), L, L, 128,
                             128)
    return lay, lambda q, k, v, **kw: fa_k.flash_attention_tiles(
        q, k, v, lay, **kw)


def hold_backward_kernels(torch) -> dict:
    """Phase 1 for the three backward kernels, through the autograd
    wrapper, against flash_attention_tiles_bwd_plain on the same o, lse and
    dO: causal tiles at the training shape (B 4, Hq/Hkv 16/8, L 512, d 128)
    in bf16 and f32, d 96 and 112 (32/32) and d 256 (8/1), the frontend
    configs' attention (FRONTEND_ATTN: 24/24 at d 64 over 768 positions,
    64/8 at d 128 over 1536), a ragged L of 777, a windowed band, a bias
    layout and the dense grid (f32 also at d 112); in bf16 (the wgmma
    kernels) every layout kind at every head_dim (B 1, Hq 8, L 384, GQA
    groups 1, 2 and 8 in turn); at d 112 a dO that
    is zero but in columns 96-111 (a lane's fourth column: a delta loop or
    an accumulator that stops at 3 x 32 columns fails there, in both
    dtypes); then the same bits from two backward passes at the training
    shape in both dtypes.  Each check prints its largest error beside its
    bar.  Returns each kernel's largest error in bf16 at the training
    shape (D against its plain sum, dK and dV for dkdv, dQ for dq)."""
    from repro_torch.kernels import flash_attention as fa_k

    b, hq, hkv, L, d = ATTN_SHAPE
    cases = [("causal", torch.bfloat16, b, hq, hkv, L, d),
             ("causal", torch.float32, b, hq, hkv, L, d),
             ("causal", torch.bfloat16, 1, 32, 32, L, 96),
             ("causal", torch.float32, 1, 32, 32, L, 96),
             ("causal", torch.bfloat16, 1, 32, 32, L, 112),
             ("causal", torch.float32, 1, 32, 32, L, 112),
             ("grid", torch.float32, 1, 32, 32, 300, 112),
             ("causal", torch.bfloat16, 1, 8, 1, L, 256),
             ("causal", torch.float32, 1, 8, 1, L, 256),
             ("causal", torch.bfloat16, 2, hq, hkv, 777, d),
             ("window", torch.bfloat16, 2, hq, hkv, L, d),
             ("bias", torch.bfloat16, 2, hq, hkv, L, d),
             ("bias", torch.float32, 1, hq, hkv, L, d),
             ("grid", torch.bfloat16, 2, hq, hkv, L, d),
             ("grid", torch.float32, 1, hq, hkv, 300, d)]
    # the frontend configs' attention: musicgen's training, qwen2-vl's
    # heads over its 1536 positions
    cases += [("causal", dt, *shape) for shape in FRONTEND_ATTN
              for dt in (torch.bfloat16, torch.float32)]
    kinds = ("causal", "window", "bias", "grid", "deadrow")
    cases += [(kind, torch.bfloat16, 1, 8, (8, 4, 1)[n % 3], 384, hd)
              for n, (kind, hd) in enumerate(
                  (kind, hd) for kind in kinds for hd in fa_k.HEAD_DIMS)]
    # dO zero but in columns 96-111 at d 112
    cases += [("causal", dt, 1, 8, 4, 256, 112, slice(96, 112))
              for dt in (torch.bfloat16, torch.float32)]
    errs = {}
    wrappers = [getattr(fa_k, n) for n in BWD_KERNELS]
    for kind, dtype, bsz, h, hk, n, hd, *cols in cases:
        q, k, v = attn_inputs(torch, dtype, bsz, h, hk, n, n, hd, n + hd)
        g = torch.Generator(device="cuda").manual_seed(hd)
        do = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
        if cols:
            do[..., :cols[0].start] = 0
        lay, call = bwd_layout(kind, n)
        with torch.no_grad():
            o, m, l = call(q, k, v, return_state=True)
        lse = fa_k.softmax_lse(m, l)
        want = fa_k.flash_attention_tiles_bwd_plain(q, k, v, o, lse, do, lay)
        delta_want = (do.float() * o.float()).sum(-1)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = [w.launches for w in wrappers]
        out = call(*leaves)
        out.backward(do)
        torch.cuda.synchronize()
        if [w.launches - x for w, x in zip(wrappers, before)] != [1, 1, 1]:
            raise AssertionError(f"backward {kind}: the three kernels did "
                                 f"not launch once each")
        if not torch.equal(out.detach(), o):
            raise AssertionError(f"backward {kind}: the autograd forward's "
                                 f"o differs from the forward's")
        rtol, atol = bwd_tol(torch, dtype)
        what = f"{kind} {str(dtype)[6:]} B={bsz} Hq/Hkv={h}/{hk} L={n} d={hd}"
        if cols:
            what += f" dO in columns {cols[0].start}-{cols[0].stop - 1} only"
            if not all(float(w.float().abs().max()) > 0 for w in want):
                raise AssertionError(f"backward {what}: a plain gradient "
                                     f"is zero")
        found = {}
        for grad, ref, name in zip((t.grad for t in leaves), want,
                                   ("dq", "dk", "dv")):
            scale = max(1.0, float(ref.float().abs().max()))
            found[name] = max_err(torch, grad.float(), ref.float(), rtol,
                                  atol * scale, f"backward {what} {name}")
        found["delta"] = max_err(torch, fa_k.fa_bwd_delta(o, do), delta_want,
                                 1e-5, 1e-5, f"backward {what} D")
        log(f"backward {what}: max |err| dq {found['dq']:.3g} dk "
            f"{found['dk']:.3g} dv {found['dv']:.3g} D {found['delta']:.3g} "
            f"(bar rtol {rtol:.3g}, atol {atol:g} x max |grad|; D 1e-5)")
        if (kind, dtype, hd, n) == ("causal", torch.bfloat16, d, L) \
                and not cols:
            errs = {"fa_bwd_delta": found["delta"],
                    "fa_bwd_dkdv": max(found["dk"], found["dv"]),
                    "fa_bwd_dq": found["dq"]}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attn_inputs(torch, dtype, b, hq, hkv, L, L, d, 5)
        do = torch.randn(q.shape, device="cuda").to(dtype)
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fa_k.flash_attention(*leaves, causal=True).backward(do)
            runs.append([t.grad for t in leaves])
        if not all(torch.equal(x, y) for x, y in zip(*runs)):
            raise AssertionError(f"backward: two passes differ in {dtype}")
    log("backward: dQ, dK, dV bitwise equal over two passes in bf16 and f32")
    hold_training_bitwise(torch)
    return errs


#: The training families' backward checked bitwise from run to run in
#: phase 1: moe_apply at qwen3-moe-30b-a3b's width on MOE_BITWISE_TOKENS
#: tokens, ssd_chunked at zamba2-7b's on SSD_BITWISE_SHAPE (B, L).
MOE_BITWISE_TOKENS = (4, 512)
SSD_BITWISE_SHAPE = (4, 512)


def grads_twice(torch, fn, inputs) -> list:
    """The gradients of every input of ``fn(*inputs)`` (a tuple of
    outputs, each given a seeded random output gradient) from two
    backward passes on the same inputs."""
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        outs = [o for o in fn(*leaves) if o.requires_grad]
        g = torch.Generator(device="cuda").manual_seed(1)
        gys = [torch.randn(o.shape, device="cuda", generator=g).to(o.dtype)
               for o in outs]
        runs.append(torch.autograd.grad(outs, leaves, gys))
    torch.cuda.synchronize()
    return runs


def hold_training_bitwise(torch) -> None:
    """The two backward passes of phase 2g's families that are not kernels
    of the port but must sum in a fixed order for check (e): moe_apply at
    qwen3-moe-30b-a3b's width in bf16 (d 2048, 128 experts, top-8, the
    router f32; its token gather and combine gather have accumulating
    index_put_ backwards) and ssd_chunked at zamba2-7b's (112 heads of 64
    sharing one SSM group, state 64; the head repeat's backward sums over
    112), each twice on the same inputs: every gradient the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod

    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe_mod.moe_init(gen, cfg)
    x = torch.randn(*MOE_BITWISE_TOKENS, cfg.d_model, device="cuda",
                    generator=gen).to(cfg.pdtype)
    names = sorted(p)

    def moe(x, *w):
        y, aux = moe_mod.moe_apply(x, dict(zip(names, w)), cfg)
        return y, aux["aux_lb"], aux["aux_z"]

    a, b = grads_twice(torch, moe, (x, *(p[n] for n in names)))
    for ga, gb, what in zip(a, b, ("x", *names)):
        if not (torch.equal(ga, gb) and float(ga.abs().max()) > 0):
            raise AssertionError(f"moe_apply backward: d{what} differs "
                                 f"between two passes, or is zero")
    moe_what = (f"d {cfg.d_model}, {cfg.num_experts} experts, top-"
                f"{cfg.experts_per_token}")
    del p, x, a, b
    cfg = get_config("zamba2-7b")
    B, L = SSD_BITWISE_SHAPE
    H, P, G, N = (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups,
                  cfg.ssm_state)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    inputs = (randn(B, L, H, P).bfloat16(),
              torch.nn.functional.softplus(randn(B, L, H) - 2.0),
              torch.log(torch.rand(H, device="cuda", generator=gen) * 15 + 1),
              randn(B, L, G, N).bfloat16(), randn(B, L, G, N).bfloat16())
    a, b = grads_twice(torch, lambda *t: ssm_mod.ssd_chunked(*t, cfg),
                       inputs)
    for ga, gb, what in zip(a, b, ("x", "dt", "a_log", "bmat", "cmat")):
        if not (torch.equal(ga, gb) and bool(torch.isfinite(ga).all())):
            raise AssertionError(f"ssd_chunked backward: d{what} differs "
                                 f"between two passes, or is not finite")
    log(f"training backward bitwise over two passes: moe_apply ({MOE_ARCH}"
        f", bf16, {moe_what}, {MOE_BITWISE_TOKENS[0]} x "
        f"{MOE_BITWISE_TOKENS[1]} tokens) and ssd_chunked (zamba2-7b, {H} "
        f"heads of {P}, {G} SSM group, state {N}, B={B} L={L})")



#: zamba2-7b's training attention (phase 2g's shared block): B 4, Hq/Hkv
#: 32/32, L 512, d 112; the backward kernels are timed there too, under
#: ``d112_*``.
BWD_D112_SHAPE = (4, 32, 32, 512, 112)
#: musicgen-medium's training attention (phase 2h): B 4, 24/24, 256 frame +
#: 512 text positions, d 64; the tiles forward and the backward kernels are
#: timed there, under ``d64_*``.
D64_SHAPE = FRONTEND_ATTN[0]


def time_backward_kernels(torch, kernels, cold_ms, shape=ATTN_SHAPE,
                          key: str = "") -> dict:
    """Phase 3 for the backward kernels at ``shape`` (the training shape by
    default), bf16, causal tiles, each number under ``key`` + its name:
    each wrapper's time (cold L2); the plain version (the whole plain
    backward for dkdv and dq, the plain sum for delta); the library call,
    SDPA's backward (causal, GQA expanded, pinned to SDPA_BACKEND, whose
    name goes beside it, and cuDNN's under ``library_cudnn_ms``; timed
    only, on dkdv and dq's records) and, for delta, torch.linalg.vecdot(dO,
    o) (the same rowsum in one call; timed only); each kernel's bound (its
    own bytes once at the HBM rate, its products at the bf16 tensor-core
    rate) and the bound of the whole backward (q, k, v, o, dO, dQ, dK, dV,
    lse and D once, against 10 * B * Hq * live pairs * d flops).  Returns
    the call of each."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import causal_layout

    b, hq, hkv, L, d = shape
    q, k, v = attn_inputs(torch, torch.bfloat16, b, hq, hkv, L, L, d, 31)
    do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    lay = causal_layout(L, L, 128, 128)
    scale = d ** -0.5
    with torch.no_grad():
        o, m, l = fa_k.flash_attention_tiles(q, k, v, lay, return_state=True)
    lse = fa_k.softmax_lse(m, l)
    delta = fa_k.fa_bwd_delta(o, do)
    pairs = L * (L + 1) // 2
    big, small = 2 * q.numel(), 2 * k.numel()      # bf16 bytes
    rows = 4 * b * hq * L                          # one f32 per row
    calls = {
        "fa_bwd_delta": (lambda: fa_k.fa_bwd_delta(o, do),
                         lambda: (do.float() * o.float()).sum(-1),
                         2 * big + rows, 2.0 * b * hq * L * d),
        "fa_bwd_dkdv": (lambda: fa_k.fa_bwd_dkdv(q, k, v, do, lse, delta,
                                                 lay, scale),
                        lambda: fa_k.flash_attention_tiles_bwd_plain(
                            q, k, v, o, lse, do, lay),
                        2 * big + 4 * small + 2 * rows,
                        8.0 * b * hq * pairs * d),
        "fa_bwd_dq": (lambda: fa_k.fa_bwd_dq(q, k, v, do, lse, delta, lay,
                                             scale),
                      lambda: fa_k.flash_attention_tiles_bwd_plain(
                          q, k, v, o, lse, do, lay),
                      3 * big + 2 * small + 2 * rows,
                      6.0 * b * hq * pairs * d)}
    qe, ke, ve = (t.detach().clone().requires_grad_() for t in
                  (q, k.repeat_interleave(hq // hkv, 1),
                   v.repeat_interleave(hq // hkv, 1)))
    sdpa_bwd = {}
    for backend in (SDPA_BACKEND, "CUDNN_ATTENTION"):
        with sdpa_kernel(getattr(SDPBackend, backend)):
            oe = F.scaled_dot_product_attention(qe, ke, ve, is_causal=True)
            sdpa_bwd[backend] = cold_ms(lambda: torch.autograd.grad(
                oe, (qe, ke, ve), do, retain_graph=True), 50)
    whole, _ = bound_ms(4 * big + 4 * small + 2 * rows,
                        10.0 * b * hq * pairs * d, PEAK_BF16_FLOP_PER_S)
    for name, (kern, plain, nbytes, flops) in calls.items():
        rec = kernels[name]
        rec[key + "ms"] = cold_ms(kern, 50)
        rec[key + "plain_ms"] = cold_ms(plain, 3)
        if name == "fa_bwd_delta":
            rec[key + "library_ms"] = cold_ms(
                lambda: torch.linalg.vecdot(do, o, dim=-1), 50)
            rec[key + "library_call"] = "torch.linalg.vecdot(dO, o, dim=-1)"
        else:
            rec[key + "library_ms"] = sdpa_bwd[SDPA_BACKEND]
            rec[key + "library_backend"] = SDPA_BACKEND
            rec[key + "library_cudnn_ms"] = sdpa_bwd["CUDNN_ATTENTION"]
        rec[key + "bound_ms"], rec[key + "bound_by"] = bound_ms(
            nbytes, flops, PEAK_BF16_FLOP_PER_S)
        rec[key + "backward_bound_ms"] = whole
    rec = kernels["fa_bwd_dq"]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa_k.flash_attention_tiles(*leaves, lay)
    rec[key + "backward_ms"] = cold_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 50)
    log(f"attention backward timed: bf16, causal tiles, B={b} Hq/Hkv="
        f"{hq}/{hkv} L={L} d={d}: the three kernels through autograd "
        f"{rec[key + 'backward_ms']:.4f} ms, SDPA backward "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in sdpa_bwd.items())
        + f", the whole backward's bound {whole:.4f} ms")
    return {name: c[0] for name, c in calls.items()}


def time_backward_only(torch) -> int:
    """``--backward-shapes``: build, print the card, ptxas's report of the
    backward kernels, and their times at the training shape, at zamba2's
    (BWD_D112_SHAPE, under ``d112_*``) and at musicgen's (D64_SHAPE, under
    ``d64_*``) as phase 3 takes them
    (``kernel_ms`` too), as one JSON line.  A copy of this
    script in a checkout of an older commit runs it to time that tree's
    kernels."""
    from repro_torch.kernels import _lib

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    _lib.lib()
    for name, r in _lib.ptxas_report(PTXAS_NAMES).items():
        if name.startswith("fa_bwd_"):
            log(f"ptxas {name}: {r['instantiations']} instantiations, at "
                f"most {r['registers']} registers, {r['spill_stores']} / "
                f"{r['spill_loads']} bytes of spill stores / loads")
    scrub = scrub_buffer(torch)
    kernels = {k: {"name": k} for k in BWD_KERNELS}
    for shape, key in ((ATTN_SHAPE, ""), (BWD_D112_SHAPE, "d112_"),
                       (D64_SHAPE, "d64_")):
        timed = time_backward_kernels(
            torch, kernels, lambda fn, iters: time_ms(torch, fn, iters,
                                                      scrub), shape, key)
        for name, fn in timed.items():
            kernels[name][key + "kernel_ms"] = kernel_ms(
                torch, fn, 20, BWD_SYMBOLS[name], scrub)
    print(json.dumps(kernels))
    return 0


# -- phase 2d: training qwen3-1.7b -------------------------------------------

#: Trainer.fit: 8 steps of 4 x 512 tokens of the learnable next-token
#: pattern (tests/test_train_integration.py::_learnable_data) at lr 3e-4.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 512, 3e-4


def learnable_data(B: int, S: int, n_batches: int = 64):
    """tests/test_train_integration.py's next-token pattern: token i+1 =
    (token i + 1) % 64."""
    class DS:
        def batch(self, i):
            rng = np.random.default_rng(i % n_batches)
            start = rng.integers(0, 64, (B, 1), dtype=np.int32)
            seq = (start + np.arange(S + 1, dtype=np.int32)[None, :]) % 64
            return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    return DS()


def run_train_path(torch, wrappers) -> dict:
    """Phase 2d: qwen3-1.7b at full width (28 layers, bf16 parameters, f32
    AdamW moments, remat) through Trainer.fit, with the launch counts reset
    just before the measured steps and read just after (per step: the tiles
    forward 28 x 2 with remat, each backward kernel 28 times); then checks
    (c) losses finite and falling, (d) at 2 layers in
    f32 every parameter's gradient on the cuda plane against the torch
    plane, (e) at 2 layers a crash and resume through TrainingSupervisor
    bitwise equal to an uninterrupted run.  Returns the path's numbers,
    with a profile of one more step under ``profile`` (a closure, which
    keeps the trained state until it is dropped)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer

    cfg = get_config(ARCH)
    data = learnable_data(TRAIN_BATCH, TRAIN_SEQ)
    t = time.perf_counter()
    trainer = Trainer(cfg, lr=TRAIN_LR, total_steps=TRAIN_STEPS, seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    hist = trainer.fit(data, TRAIN_STEPS, log_every=1)["history"]
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["history"] = hist
    times = [h["time_s"] for h in hist]
    out["step_s"] = [b - a for a, b in zip([0.0] + times, times)]
    steady = out["step_s"][1:]
    out["tok_s"] = TRAIN_BATCH * TRAIN_SEQ * len(steady) / sum(steady)
    layers = cfg.num_layers
    want = {"flash_attention_tiles": 2 * layers * TRAIN_STEPS,
            **{k: layers * TRAIN_STEPS for k in BWD_KERNELS},
            "flash_attention": 0, "flash_attention_lens": 0}
    if out["launches"] != want:
        raise AssertionError(f"training launches {out['launches']}, "
                             f"expected {want}")

    def one_step():
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch(TRAIN_STEPS).items()}
        trainer.step_fn(trainer.state, batch)

    # where the device time of one step goes; the caller runs it after the
    # kernel timings, whose profiler traces lose events after a large trace
    out["profile"] = lambda: device_breakdown(one_step)
    out["roofline"] = lambda: analyze(
        one_step, arch=ARCH, shape=f"{TRAIN_BATCH}x{TRAIN_SEQ}", cfg=cfg,
        n_tokens=TRAIN_BATCH * TRAIN_SEQ, dtype="bfloat16")

    # (c) every loss finite, the last below the first
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"(c) losses {losses}")

    # (d) f32 at full width, 2 layers: cuda plane against the torch plane
    batch = data.batch(0)
    out["d_rel"], _ = check_gradient_planes(
        torch, dataclasses.replace(cfg, num_layers=2), batch, wrappers)

    # the embedding's backward, twice on the same inputs: the same bits
    emb = torch.randn(cfg.padded_vocab, cfg.d_model, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    tok = torch.as_tensor(batch["tokens"], device="cuda").long()
    gy = torch.randn(*tok.shape, cfg.d_model, device="cuda",
                     dtype=torch.bfloat16)
    ge = [torch.autograd.grad(torch.nn.functional.embedding(tok, emb), emb,
                              gy)[0] for _ in range(2)]
    if not torch.equal(*ge):
        raise AssertionError("the embedding's backward differs run to run")
    del emb, ge

    # (e) 2 layers: save at 3, crash at 5, resume in a fresh state, finish
    out.update(check_resume(torch, dataclasses.replace(cfg, num_layers=2),
                            data))
    return out


def attention_sites(lm) -> int:
    """The attention blocks one forward of ``lm`` runs: one a layer (dense
    and MoE), one a shared-block site (hybrid), none (SSM)."""
    if lm.cfg.family == "hybrid":
        return lm._hybrid_split()[0]
    return lm.cfg.num_layers if lm.cfg.has_attention else 0


def check_gradient_planes(torch, cfg, batch, wrappers) -> tuple[dict, tuple]:
    """Check (d): ``cfg`` in f32 (full width, cut in depth), every
    parameter's gradient of LM.loss on ``batch`` on the cuda plane against
    the torch plane, max |diff| / max |grad| each within D_REL_TOL; the
    cuda plane's backward launches each backward kernel once per attention
    site (none for the SSM family); for the MoE family every top-k set of
    every moe_apply call (the forward's and remat's recompute's) agrees
    between the planes first.  Returns (the ratio by parameter path, the
    MoE's (agreeing, all) top-k sets)."""
    from repro_torch.core import registry
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import LM
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils.tree import tree_paths

    lm32 = LM(dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32"))
    p32 = lm32.init(0, device="cuda")
    sites = attention_sites(lm32)
    before = {k: wrappers[k].launches for k in BWD_KERNELS}
    with moe_mod.record_routing() as rc:
        (_, _), g_cuda = value_and_grad(lm32.loss, p32, batch)
    moved = {k: wrappers[k].launches - before[k] for k in BWD_KERNELS}
    if moved != dict.fromkeys(BWD_KERNELS, sites):
        raise AssertionError(f"(d) {cfg.name}: the cuda plane's backward "
                             f"launched {moved}, want {sites} each")
    with registry.use_backend("torch"), moe_mod.record_routing() as rt:
        (_, _), g_torch = value_and_grad(lm32.loss, p32, batch)
    sets = (sum(int((torch.sort(a, -1).values == torch.sort(b, -1).values)
                    .all(-1).sum()) for a, b in zip(rc, rt)),
            sum(a.shape[0] * a.shape[1] for a in rc))
    if cfg.family == "moe" and (not rc or len(rc) != len(rt)
                                or sets[0] != sets[1]):
        raise AssertionError(f"(d) {cfg.name}: top-k sets agree on "
                             f"{sets[0]}/{sets[1]} tokens of {len(rc)} / "
                             f"{len(rt)} calls")
    rel = {path: float((gc - gt).abs().max()
                       / gt.abs().max().clamp_min(1e-30))
           for (path, gc), (_, gt) in zip(tree_paths(g_cuda),
                                          tree_paths(g_torch))}
    if not max(rel.values()) <= D_REL_TOL:
        raise AssertionError(f"(d) {cfg.name}: gradients cuda vs torch "
                             f"plane: {rel}")
    del p32, g_cuda, g_torch, rc, rt
    free_card(torch)
    return rel, sets


def check_resume(torch, cfg, data) -> dict:
    """Check (e): ``cfg`` (its own dtypes) through TrainingSupervisor,
    saving every 3 steps with a crash injected at step 5, then resumed in a
    fresh state from another seed and run to step 6: every parameter
    bitwise equal to an uninterrupted 6-step run."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.train import Trainer
    from repro_torch.runtime import TrainingSupervisor
    from repro_torch.train import create
    from repro_torch.utils.tree import tree_leaves

    trainer = Trainer(cfg, lr=TRAIN_LR, total_steps=6, seed=0,
                      device="cuda")
    lm, step_fn, opt = trainer.lm, trainer.step_fn, trainer.opt
    ref = trainer.state
    del trainer
    for i in range(6):
        ref, _ = step_fn(ref, data.batch(i))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        sup = TrainingSupervisor(Checkpointer(d),
                                 create(lm, opt, 0, device="cuda"),
                                 save_every=3)
        try:
            sup.run(step_fn, data, 6, fail_at=5)
            raise AssertionError("(e) the injected failure did not fire")
        except RuntimeError as exc:
            if "injected failure" not in str(exc):
                raise
        del sup
        sup2 = TrainingSupervisor(Checkpointer(d),
                                  create(lm, opt, 1, device="cuda"),
                                  save_every=3)
        out["e_resumed_at"] = int(sup2.state.step)
        final, _ = sup2.run(step_fn, data, 6)
        del sup2
    pairs = list(zip(tree_leaves(final.params), tree_leaves(ref.params)))
    out["e_equal"] = sum(torch.equal(a, b) for a, b in pairs)
    out["e_leaves"] = len(pairs)
    if out["e_resumed_at"] != 3 or out["e_equal"] != len(pairs):
        raise AssertionError(f"(e) {cfg.name}: resumed at "
                             f"{out['e_resumed_at']}, {out['e_equal']}/"
                             f"{len(pairs)} parameters bitwise equal to the "
                             f"uninterrupted run")
    del ref, final, pairs
    free_card(torch)
    return out


#: (d)'s bar: the largest |cuda - torch| of a parameter's gradient over
#: that gradient's largest entry.  Both planes run f32 (TF32 off); only
#: attention differs (serial FMA sums against BLAS), a few ulps an entry.
D_REL_TOL = 1e-3


# -- phase 2e: serving the MoE family ----------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
#: qwen3-moe-30b-a3b at full width, cut to 12 of its 48 layers (8.1 B
#: parameters): the phase's time, to make room for phase 2l in the run's
#: limit (PR 21's whole-model numbers are in PERF.md).
MOE_SERVE_LAYERS = 12
#: arctic-480b at full width, cut to 2 of its 35 layers (476.8 B parameters
#: do not fit one card; 2 layers are 27.7 B, 55.4 GB in bf16):
#: Engine.generate on 2 prompts of 256 tokens, 8 new, and the
#: ContinuousEngine on the same 2 requests (2 slots, chunks of 128).
ARCTIC_ARCH, ARCTIC_LAYERS = "arctic-480b", 2
ARCTIC_BATCH, ARCTIC_PROMPT, ARCTIC_NEW = 2, 256, 8
#: (a-moe)'s bar: the largest |cuda - torch| of the f32 prefill logits over
#: their largest entry (both planes f32, TF32 off; only attention differs).
A_MOE_REL_TOL = 1e-3


def free_card(torch) -> tuple[float, float]:
    """Collect garbage and empty the caching allocator; (free, allocated)
    GB on the card after it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (torch.cuda.mem_get_info()[0] / 1e9,
            torch.cuda.memory_allocated() / 1e9)


def reset_attention_counts(wrappers) -> None:
    """Set the attention wrappers' launch counts, and the tiles and lens
    counts by kernel, to 0."""
    for w in wrappers.values():
        w.launches = 0
    for name in ("flash_attention_tiles", "flash_attention_lens"):
        counts = wrappers[name].kernels
        for kind in counts:
            counts[kind] = 0


def read_attention_counts(wrappers) -> dict:
    """The attention launches since :func:`reset_attention_counts`, by
    kernel."""
    tiles = wrappers["flash_attention_tiles"].kernels
    lens = wrappers["flash_attention_lens"].kernels
    return {"tiles": tiles["o"], "tiles_state": tiles["state"],
            "lens_decode": lens["decode"], "lens_prefix": lens["prefix"],
            "flash_attention": wrappers["flash_attention"].launches}


def run_moe_path(torch, wrappers) -> dict:
    """Phase 2e: the MoE family.  (a-moe) qwen3-moe-30b-a3b at full width
    in f32 with 2 layers: the prefill logits and every token's top-k expert
    sets in every layer, cuda plane against the torch plane.  Then
    qwen3-moe-30b-a3b at full width cut to MOE_SERVE_LAYERS of its 48
    layers (128 experts, top-8; bf16, router f32, seeded random weights)
    through the
    Engine (4 x 512 prompt tokens, 32 new) and the ContinuousEngine (phase
    2c's 8 requests, 4 slots, chunks of 128, capacity 1152, pages of 64),
    the launch counts reset just before each engine's measured run and
    read just after; (f) a second ContinuousEngine run gives the same
    tokens bitwise; the share of (token, layer) top-k sets that agree
    between the planes in bf16 at that depth (printed, not held); a
    profile of each engine with the MoE ops in a group of their own.
    Then arctic-480b at full width with 2 layers through both engines (56/8
    heads).  Returns the phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core import registry
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import LM
    from repro_torch.serve import ContinuousEngine, Engine, SamplingParams
    from repro_torch.utils.tree import tree_leaves

    def reset():
        reset_attention_counts(wrappers)

    def read():
        return read_attention_counts(wrappers)

    def need(what, counts, kinds):
        missing = [k for k in kinds if counts[k] == 0]
        if missing:
            raise AssertionError(f"{what}: kernels not launched: {missing} "
                                 f"({counts})")

    out = {}
    out["free_gb"], out["allocated_gb"] = free_card(torch)
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=MOE_SERVE_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (FIXED_BATCH, FIXED_PROMPT),
                            generator=g, device="cuda")
    greedy = SamplingParams(greedy=True)

    def prefill_routes(lm, params, plane):
        """Prefill logits and each layer's sorted top-k sets (t, k)."""
        ctx = registry.use_backend(plane) if plane else \
            contextlib.nullcontext()
        with ctx, moe_mod.record_routing() as routes:
            logits, _ = lm.prefill(params, prompts)
        return logits, [torch.sort(r.reshape(-1, r.shape[-1]), -1).values
                        for r in routes]

    def agreeing(ra, rb):
        return sum(int((a == b).all(-1).sum()) for a, b in zip(ra, rb)), \
            sum(a.shape[0] for a in ra)

    clock = {"start": time.perf_counter()}

    def lap(name):
        clock[name] = time.perf_counter() - clock.pop("start")
        clock["start"] = time.perf_counter()

    # (a-moe) f32 at full width, 2 layers
    lm32 = LM(dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                  param_dtype="float32"))
    p32 = lm32.init(0, device="cuda")
    lc, rc = prefill_routes(lm32, p32, None)
    lt, rt = prefill_routes(lm32, p32, "torch")
    out["a_rel"] = float((lc - lt).abs().max() / lt.abs().max())
    out["a_sets"] = agreeing(rc, rt)
    if not out["a_rel"] <= A_MOE_REL_TOL or \
            out["a_sets"][0] != out["a_sets"][1] or len(rc) != 2:
        raise AssertionError(f"(a-moe) f32 prefill: logits rel diff "
                             f"{out['a_rel']}, top-k sets agree "
                             f"{out['a_sets']}")
    del lm32, p32, lc, lt, rc, rt
    free_card(torch)
    lap("a-moe")

    # qwen3-moe-30b-a3b, full width and depth, bf16
    lm = LM(cfg)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = lm.init(0, device="cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    leaves = tree_leaves(params)
    out["params"] = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    out["param_gb"] = nbytes / 1e9
    # a decode step reads every weight once but the embedding's rows
    emb = params["embed"]
    out["step_bound_ms"] = (nbytes - emb.numel() * emb.element_size()) \
        / PEAK_BYTES_PER_S * 1e3
    router = params["layers"][0]["moe"]["router"]
    if router.dtype != torch.float32 or \
            params["layers"][0]["moe"]["wo"].dtype != torch.bfloat16:
        raise AssertionError("qwen3-moe: router must be f32, experts bf16")

    eng = Engine(lm, params, max_len=FIXED_PROMPT + FIXED_NEW,
                 sampling=greedy)
    eng.generate(prompts[:, :64], max_new_tokens=2)        # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = eng.generate(prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    out["fixed_ttft_s"] = time.perf_counter() - t
    reset()
    t = time.perf_counter()
    toks = eng.generate(prompts, max_new_tokens=FIXED_NEW)
    torch.cuda.synchronize()
    out["fixed_s"] = time.perf_counter() - t
    out["fixed_launches"] = read()
    need("qwen3-moe Engine", out["fixed_launches"], ("tiles",))
    out["fixed_step_s"] = (out["fixed_s"] - out["fixed_ttft_s"]) / (
        FIXED_NEW - 1)
    out["fixed_tok_s"] = FIXED_BATCH * FIXED_NEW / out["fixed_s"]
    if toks.shape != (FIXED_BATCH, FIXED_NEW) or not torch.equal(
            toks[:, :1], first) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"qwen3-moe Engine.generate: bad tokens "
                             f"{toks.shape}")
    lap("init and Engine")

    reqs = serve_requests(cfg.vocab_size)

    def continuous():
        return ContinuousEngine(lm, params, num_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN,
                                chunk_size=SERVE_CHUNK, sampling=greedy)

    ce = continuous()
    torch.cuda.synchronize()
    reset()
    t = time.perf_counter()
    got, stats = ce.serve(reqs, collect_stats=True)
    torch.cuda.synchronize()
    out["cont_s"] = time.perf_counter() - t
    out["cont_launches"] = read()
    need("qwen3-moe ContinuousEngine", out["cont_launches"],
         ("tiles_state", "lens_decode", "lens_prefix"))
    if [len(x) for x in got] != [m for _, m in reqs]:
        raise AssertionError(f"qwen3-moe ContinuousEngine.serve: lengths "
                             f"{[len(x) for x in got]}")
    out["cont_tok_s"] = sum(len(x) for x in got) / out["cont_s"]
    out["cont_ttft_s"] = float(np.mean(stats.first_token_times))
    out["cont_iters"] = len(stats.iter_times)
    out["cont_iter_s"] = out["cont_s"] / out["cont_iters"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    lap("ContinuousEngine")

    # (f) a second run of the same requests: the same tokens, bitwise
    again = continuous().serve(reqs)
    out["f_equal"] = sum(a.tolist() == b.tolist() for a, b in zip(got,
                                                                   again))
    if out["f_equal"] != len(reqs):
        raise AssertionError(f"(f) two ContinuousEngine runs: "
                             f"{out['f_equal']}/{len(reqs)} requests equal")
    lap("(f)")

    # bf16 at MOE_SERVE_LAYERS: how often the planes route a token alike
    _, rc = prefill_routes(lm, params, None)
    _, rt = prefill_routes(lm, params, "torch")
    out["route_share"] = agreeing(rc, rt)
    out["route_share_by_layer"] = [agreeing([a], [b])[0] / a.shape[0]
                                   for a, b in zip(rc, rt)]
    del rc, rt
    lap("routing share")

    # the MoE group needs CPU activity in the trace, whose processing is
    # slow: the Engine's short window only
    sub = [(p, PROFILE_NEW) for p, _ in reqs[:SERVE_SLOTS]]
    out["profile_fixed"] = device_breakdown(lambda: eng.generate(
        prompts, max_new_tokens=PROFILE_NEW), group="moe")
    out["profile_cont"] = device_breakdown(
        lambda: continuous().serve(sub))
    del lm, params, leaves, router, emb, eng, ce, got, again, first, toks
    out["free_gb_after"], _ = free_card(torch)
    lap("profiles")

    # arctic-480b, full width, 2 layers, both engines
    acfg = dataclasses.replace(get_config(ARCTIC_ARCH),
                               num_layers=ARCTIC_LAYERS)
    alm = LM(acfg)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ap = alm.init(0, device="cuda")
    torch.cuda.synchronize()
    out["arctic_init_s"] = time.perf_counter() - t
    out["arctic_params"] = sum(x.numel() for x in tree_leaves(ap))
    aprompts = torch.randint(0, acfg.vocab_size,
                             (ARCTIC_BATCH, ARCTIC_PROMPT), generator=g,
                             device="cuda")
    reset()
    t = time.perf_counter()
    atoks = Engine(alm, ap, max_len=ARCTIC_PROMPT + ARCTIC_NEW,
                   sampling=greedy).generate(aprompts,
                                             max_new_tokens=ARCTIC_NEW)
    areqs = [(aprompts[i].cpu().numpy().astype(np.int32), ARCTIC_NEW)
             for i in range(ARCTIC_BATCH)]
    agot = ContinuousEngine(alm, ap, num_slots=ARCTIC_BATCH,
                            max_len=ARCTIC_PROMPT + SERVE_CHUNK,
                            chunk_size=SERVE_CHUNK,
                            sampling=greedy).serve(areqs)
    torch.cuda.synchronize()
    out["arctic_s"] = time.perf_counter() - t
    out["arctic_launches"] = read()
    need("arctic-480b", out["arctic_launches"],
         ("tiles", "tiles_state", "lens_decode", "lens_prefix"))
    alog, _ = alm.prefill(ap, aprompts)
    if atoks.shape != (ARCTIC_BATCH, ARCTIC_NEW) or \
            [len(x) for x in agot] != [ARCTIC_NEW] * ARCTIC_BATCH or \
            not bool(torch.isfinite(alog).all()):
        raise AssertionError(f"arctic-480b: tokens {tuple(atoks.shape)}, "
                             f"{[len(x) for x in agot]}, finite logits "
                             f"{bool(torch.isfinite(alog).all())}")
    out["arctic_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del alm, ap, alog, atoks, agot
    free_card(torch)
    lap("arctic-480b")
    clock.pop("start")
    out["seconds"] = clock
    return out


# -- phase 2f: serving the SSM and hybrid families ---------------------------

#: The SSM config (48 layers, f32 parameters, bf16 activations) and the
#: hybrid one (81 layers: 13 groups of 6 mamba layers with the shared
#: attention block after each, and a tail of 3; bf16), both whole; served
#: through the Engine on 4 prompts of SSM_PROMPT tokens (a multiple of the
#: SSD chunk, 256), SSM_NEW new, greedy.
SSM_ARCHS = ("mamba2-370m", "zamba2-7b")
SSM_PROMPT, SSM_NEW = 512, 32
#: (a-ssm) and (g)'s depths in f32 at full width: mamba2 at 2 layers,
#: zamba2 at 7 (one group of 6 and a tail of 1).
SSM_CHECK_LAYERS = {"mamba2-370m": 2, "zamba2-7b": 7}
#: (a-ssm) and (g)'s bar: the largest |difference| of the logits over their
#: largest entry (f32, TF32 off).
SSM_REL_TOL = 1e-3


def run_ssm_path(torch, wrappers) -> dict:
    """Phase 2f: the SSM and hybrid families.  For each of SSM_ARCHS: (a-ssm)
    at full width in f32 and SSM_CHECK_LAYERS depth, the prefill logits of
    the cuda plane against the torch plane; (g) at the same depth, the
    recurrence against the chunked form: prefill SSM_PROMPT / 2 tokens,
    decode the next SSM_PROMPT / 2 one at a time (teacher-forced), and
    hold the last logits against a SSM_PROMPT-token prefill's.  Then the
    config whole (bf16 activations, seeded random weights) through the
    Engine (FIXED_BATCH x SSM_PROMPT prompt tokens, SSM_NEW new), the
    launch counts reset just before the measured run and read just after
    (zamba2: the tiles kernel once per shared-block site, 13, at d 112;
    mamba2: no attention kernel), peak memory and a profile with the
    mamba2 work under an ``ssm`` group.  Returns the phase's numbers by
    config."""
    from repro_torch.configs import get_config
    from repro_torch.core import registry
    from repro_torch.models.lm import LM
    from repro_torch.serve import Engine, SamplingParams
    from repro_torch.utils.tree import tree_leaves

    greedy = SamplingParams(greedy=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {"free_gb": free_card(torch)[0]}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        rec: dict = {}
        clock = time.perf_counter()
        prompts = torch.randint(0, cfg.vocab_size,
                                (FIXED_BATCH, SSM_PROMPT), generator=g,
                                device="cuda")

        # (a-ssm) and (g): f32 at full width, cut in depth
        lm32 = LM(dataclasses.replace(cfg,
                                      num_layers=SSM_CHECK_LAYERS[arch],
                                      dtype="float32",
                                      param_dtype="float32"))
        p32 = lm32.init(0, device="cuda")
        lc, _ = lm32.prefill(p32, prompts)
        with registry.use_backend("torch"):
            lt, _ = lm32.prefill(p32, prompts)
        rec["a_rel"] = float((lc - lt).abs().max() / lt.abs().max())
        half = SSM_PROMPT // 2
        _, cache = lm32.prefill(p32, prompts[:, :half], max_len=SSM_PROMPT)
        for i in range(half, SSM_PROMPT):
            lg, cache = lm32.decode_step(p32, cache, prompts[:, i:i + 1])
        rec["g_rel"] = float((lg - lc).abs().max() / lc.abs().max())
        if not (rec["a_rel"] <= SSM_REL_TOL and rec["g_rel"] <= SSM_REL_TOL
                and bool(torch.isfinite(lc).all())):
            raise AssertionError(f"{arch}: (a-ssm) {rec['a_rel']}, (g) "
                                 f"{rec['g_rel']} (bar {SSM_REL_TOL})")
        del lm32, p32, lc, lt, lg, cache
        free_card(torch)
        rec["checks_s"] = time.perf_counter() - clock

        # the config whole, bf16 activations, through the Engine
        lm = LM(cfg)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = lm.init(0, device="cuda")
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t
        leaves = tree_leaves(params)
        rec["params"] = sum(x.numel() for x in leaves)
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        rec["param_gb"] = nbytes / 1e9
        # a decode step reads every weight once, the embedding only where
        # it is tied (the unembedding; a lookup reads 4 of its rows)
        emb = params["embed"]
        untied = 0 if cfg.tie_embeddings else emb.numel() * emb.element_size()
        rec["step_bound_ms"] = (nbytes - untied) / PEAK_BYTES_PER_S * 1e3
        layer0 = (params["groups"][0][0] if "groups" in params
                  else params["layers"][0])["mamba"]
        if any(layer0[n].dtype != torch.float32
               for n in ("A_log", "D", "dt_bias")) or \
                layer0["in_proj"].dtype != cfg.pdtype:
            raise AssertionError(f"{arch}: A_log, D, dt_bias must be f32, "
                                 f"in_proj {cfg.pdtype}")
        eng = Engine(lm, params, max_len=SSM_PROMPT + SSM_NEW,
                     sampling=greedy)
        eng.generate(prompts[:, :64], max_new_tokens=2)    # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        first = eng.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        rec["ttft_s"] = time.perf_counter() - t
        reset_attention_counts(wrappers)
        t = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=SSM_NEW)
        torch.cuda.synchronize()
        rec["s"] = time.perf_counter() - t
        rec["launches"] = read_attention_counts(wrappers)
        rec["step_s"] = (rec["s"] - rec["ttft_s"]) / (SSM_NEW - 1)
        rec["tok_s"] = FIXED_BATCH * SSM_NEW / rec["s"]
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if toks.shape != (FIXED_BATCH, SSM_NEW) or not torch.equal(
                toks[:, :1], first) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{arch} Engine.generate: bad tokens "
                                 f"{tuple(toks.shape)}")
        sites = attention_sites(lm)
        want = {"tiles": sites, "tiles_state": 0, "lens_decode": 0,
                "lens_prefix": 0, "flash_attention": 0}
        if rec["launches"] != want:
            raise AssertionError(f"{arch} Engine: launches "
                                 f"{rec['launches']}, want {want} (one "
                                 f"tiles launch per shared-block site of "
                                 f"the one prefill)")
        rec["profile"] = device_breakdown(lambda: eng.generate(
            prompts, max_new_tokens=PROFILE_NEW), group="ssm")
        del lm, params, leaves, layer0, emb, eng, first, toks
        free_card(torch)
        rec["s_all"] = time.perf_counter() - clock
        out[arch] = rec
    return out


# -- phase 2g: training the MoE, SSM and hybrid families ---------------------

#: Each config at full width through Trainer.fit (TRAIN_STEPS steps of
#: TRAIN_BATCH x TRAIN_SEQ tokens of the learnable pattern at TRAIN_LR; the
#: config's dtypes, bf16 activations; f32 AdamW moments; remat), cut in
#: depth to what one card holds at the update's peak
#: (launch.train.update_peak_bytes): qwen3-moe-30b-a3b to 3 of its 48
#: layers (2.49 B parameters; all 30.5 B need 427 GB), mamba2-370m whole
#: (None), zamba2-7b to 21 of its 81 (3 groups of 6 mamba layers with the
#: shared block after each, and a tail of 3; 2.07 B parameters; all 6.75 B
#: need 94.5 GB).
FAMILY_TRAIN = {"qwen3-moe-30b-a3b": 3, "mamba2-370m": None,
                "zamba2-7b": 21}
#: (d) (f32) and (e)'s depths: 2 layers; zamba2 7, a group of 6 and a tail
#: of 1, so that one shared-block site runs the attention backward at d 112.
FAMILY_CHECK_LAYERS = {"qwen3-moe-30b-a3b": 2, "mamba2-370m": 2,
                       "zamba2-7b": 7}


def train_config(torch, base, layers, check_layers, data, wrappers,
                 phase: str) -> dict:
    """``base`` at full width, cut to ``layers`` (None: whole), through
    Trainer.fit (TRAIN_STEPS steps of ``data`` at TRAIN_LR), with the
    launch counts reset just before the measured steps and read just
    after, held to the count reckoned from the code and printed before the
    run (with remat, per attention site and step: the tiles forward
    twice, each backward kernel once); the step times, text tokens/s and
    positions/s (the frontend's counted), peak memory, and one more step
    profiled; then (c) losses finite and falling, (d) at ``check_layers``
    in f32 the gradients cuda vs torch plane (check_gradient_planes), (e)
    at the same depth in the config's dtypes a crash and resume bitwise
    (check_resume).  Returns the config's numbers."""
    from repro_torch.launch.train import Trainer
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(base, num_layers=layers or base.num_layers)
    rec: dict = {"layers": cfg.num_layers}
    clock = {"start": time.perf_counter()}

    def lap(name):
        clock[name] = time.perf_counter() - clock.pop("start")
        clock["start"] = time.perf_counter()

    trainer = Trainer(cfg, lr=TRAIN_LR, total_steps=TRAIN_STEPS, seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    rec["params"] = sum(x.numel() for x in
                        tree_leaves(trainer.state.params))
    sites = attention_sites(trainer.lm)
    want = {"flash_attention_tiles": 2 * sites * TRAIN_STEPS,
            **{k: sites * TRAIN_STEPS for k in BWD_KERNELS},
            "flash_attention": 0, "flash_attention_lens": 0}
    log(f"phase {phase}: {cfg.name} at {cfg.num_layers} of "
        f"{base.num_layers} layers ({rec['params']} parameters, {sites} "
        f"attention sites): launches reckoned over {TRAIN_STEPS} steps "
        f"{want}")
    lap("init")
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.fit(data, TRAIN_STEPS, log_every=1)["history"]
    torch.cuda.synchronize()
    rec["launches"] = {k: w.launches for k, w in wrappers.items()}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["history"] = hist
    times = [h["time_s"] for h in hist]
    rec["step_s"] = [b - a for a, b in zip([0.0] + times, times)]
    steady = sum(rec["step_s"][1:]) / (len(hist) - 1)
    front = cfg.frontend_len if cfg.frontend is not None else 0
    rec["tok_s"] = TRAIN_BATCH * TRAIN_SEQ / steady
    rec["pos_s"] = TRAIN_BATCH * (front + TRAIN_SEQ) / steady
    if rec["launches"] != want:
        raise AssertionError(f"{cfg.name} training launches "
                             f"{rec['launches']}, reckoned {want}")
    # (c) every loss finite, the last below the first
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"(c) {cfg.name} losses {losses}")
    lap("fit")

    def one_step():
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch(TRAIN_STEPS).items()}
        trainer.step_fn(trainer.state, batch)

    rec["profile"] = device_breakdown(one_step)
    del trainer
    free_card(torch)
    lap("profile")

    check = dataclasses.replace(base, num_layers=check_layers)
    rec["d_rel"], rec["d_sets"] = check_gradient_planes(
        torch, check, data.batch(0), wrappers)
    lap("(d)")
    rec.update(check_resume(torch, check, data))
    lap("(e)")
    clock.pop("start")
    rec["seconds"] = clock
    return rec


def run_train_families(torch, wrappers) -> dict:
    """Phase 2g: each config of FAMILY_TRAIN through :func:`train_config`
    on the learnable pattern, (d) and (e) at FAMILY_CHECK_LAYERS.  Returns
    the phase's numbers by config."""
    from repro_torch.configs import get_config

    data = learnable_data(TRAIN_BATCH, TRAIN_SEQ)
    out = {"free_gb": free_card(torch)[0]}
    for arch, layers in FAMILY_TRAIN.items():
        out[arch] = train_config(torch, get_config(arch), layers,
                                 FAMILY_CHECK_LAYERS[arch], data, wrappers,
                                 "2g")
    return out


# -- phase 2h: the VLM and audio families ------------------------------------

VLM_ARCH, AUDIO_ARCH = "qwen2-vl-72b", "musicgen-medium"
#: The Engine runs phase 2c's FIXED_BATCH x FIXED_PROMPT tokens, FIXED_NEW
#: new, behind the config's frontend (qwen2-vl 1024 patch embeddings,
#: musicgen 256 frame embeddings; seeded standard normals, as SyntheticLM
#: draws them); musicgen trains on TRAIN_BATCH x (256 + TRAIN_SEQ).
#: (a-f32), (g-frontend) and (d)'s depth in f32 at full width.
FRONT_CHECK_LAYERS = 2
#: (a-f32) and (g-frontend)'s bar: the largest |difference| of the logits
#: over their largest entry (f32, TF32 off).
FRONT_REL_TOL = 1e-3
#: qwen2-vl's (d) batch: 2 x (1024 + 512) positions (f32 parameters and two
#: planes' gradients of 2 layers, 17 GB each, stay far from the card's
#: size).
VLM_GRAD_BATCH = 2
#: What the allocator and the residual stream take beside the largest
#: transient of check (a) (vlm_serve_layers): at 3 GB, 38 layers of
#: qwen2-vl-72b left check (a)'s peak 2.3 GB below the free memory on an
#: H100 80GB HBM3; 5 GB keeps it about 5 GB below.
SERVE_SLACK_BYTES = 5e9


def vlm_serve_layers(cfg, free_bytes: float) -> tuple[int, dict]:
    """The depth at which qwen2-vl-72b serves at full width on the card:
    what ``free_bytes`` holds beside the embedding and unembedding (bf16)
    and the largest transient of the serve phase, check (a)'s torch-plane
    prefill attention (scores, their masked copy and P, f32, B x Hq x L x
    L each) or an MLP's (gate, up, their f32 copies, the product: 14 bytes
    an element of B x L x d_ff), with SERVE_SLACK_BYTES on top; each layer
    costs its bf16 weights and two K/V caches of F + FIXED_PROMPT +
    FIXED_NEW positions (check (a) holds one while the other is made).
    Returns (layers, the terms in bytes)."""
    B, L = FIXED_BATCH, cfg.frontend_len + FIXED_PROMPT
    bf16 = 2
    fixed = dataclasses.replace(cfg, num_layers=0).param_count() * bf16
    layer = dataclasses.replace(cfg, num_layers=1).param_count() * bf16 \
        - fixed
    kv = 2 * 2 * B * cfg.num_kv_heads * (L + FIXED_NEW) * cfg.head_dim * bf16
    attn = 3 * 4 * B * cfg.num_heads * L * L
    mlp = 14 * B * L * cfg.d_ff
    transient = max(attn, mlp) + SERVE_SLACK_BYTES
    layers = int((free_bytes - fixed - transient) // (layer + kv))
    return min(cfg.num_layers, layers), {
        "free": free_bytes, "embeddings": fixed, "transient": transient,
        "layer": layer, "kv_per_layer": kv}


def frontend_data(B: int, S: int, F: int, d_model: int, n_batches: int = 64):
    """learnable_data's next-token pattern on S text tokens behind F seeded
    standard-normal frontend embeddings (B, F, d_model), as SyntheticLM
    draws them."""
    text = learnable_data(B, S, n_batches)

    class DS:
        def batch(self, i):
            out = text.batch(i)
            rng = np.random.default_rng(10_000 + i % n_batches)
            out["frontend_embeds"] = rng.standard_normal(
                (B, F, d_model)).astype(np.float32)
            return out
    return DS()


def hold_frontend_planes(torch, cfg, prompts, fe) -> dict:
    """(a-f32) and (g-frontend) for ``cfg`` at full width in f32 with
    FRONT_CHECK_LAYERS layers: the prefill logits of the cuda plane against
    the torch plane; and a prefill of the frontend + FIXED_PROMPT / 2
    tokens, then FIXED_PROMPT / 2 teacher-forced decode steps (M-RoPE's
    decode offset: cache slot F + i is text position i + F // grid_hw),
    against the whole prompt's prefill, last logits.  Each within
    FRONT_REL_TOL of the largest logit."""
    from repro_torch.core import registry
    from repro_torch.models.lm import LM

    lm32 = LM(dataclasses.replace(cfg, num_layers=FRONT_CHECK_LAYERS,
                                  dtype="float32", param_dtype="float32"))
    p32 = lm32.init(0, device="cuda")
    lc, _ = lm32.prefill(p32, prompts, fe)
    with registry.use_backend("torch"):
        lt, _ = lm32.prefill(p32, prompts, fe)
    rec = {"a32_rel": float((lc - lt).abs().max() / lt.abs().max())}
    half = FIXED_PROMPT // 2
    F = cfg.frontend_len
    _, cache = lm32.prefill(p32, prompts[:, :half], fe,
                            max_len=F + FIXED_PROMPT)
    for i in range(half, FIXED_PROMPT):
        lg, cache = lm32.decode_step(p32, cache, prompts[:, i:i + 1])
    rec["g_rel"] = float((lg - lc).abs().max() / lc.abs().max())
    if not (rec["a32_rel"] <= FRONT_REL_TOL and rec["g_rel"] <= FRONT_REL_TOL
            and bool(torch.isfinite(lc).all())
            and cache["cur_len"] == F + FIXED_PROMPT):
        raise AssertionError(f"{cfg.name}: (a-f32) {rec['a32_rel']}, "
                             f"(g-frontend) {rec['g_rel']} (bar "
                             f"{FRONT_REL_TOL})")
    del lm32, p32, lc, lt, lg, cache
    free_card(torch)
    return rec


def serve_frontend(torch, cfg, prompts, fe, wrappers) -> dict:
    """``cfg`` (bf16, seeded random weights) through the Engine on
    ``prompts`` behind ``fe``, FIXED_NEW new tokens, max_len exactly F +
    FIXED_PROMPT + FIXED_NEW: time to first token, the measured run with
    the launch counts reset just before it and read just after (the tiles
    kernel once a layer, for the one prefill; the decode steps are the
    plain einsum), the decode step beside its weight-read bound, peak
    memory, a profile of a PROFILE_NEW-token run, then (a) the prefill
    logits of the cuda plane against the torch plane within 8 bf16 ulps of
    their scale."""
    from repro_torch.core import registry
    from repro_torch.models.lm import LM
    from repro_torch.serve import Engine, SamplingParams
    from repro_torch.utils.tree import tree_leaves

    lm = LM(cfg)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = lm.init(0, device="cuda")
    torch.cuda.synchronize()
    rec: dict = {"layers": cfg.num_layers,
                 "init_s": time.perf_counter() - t}
    leaves = tree_leaves(params)
    rec["params"] = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    rec["param_gb"] = nbytes / 1e9
    # a decode step reads every weight once but the (untied) embedding's
    emb = params["embed"]
    rec["step_bound_ms"] = (nbytes - emb.numel() * emb.element_size()) \
        / PEAK_BYTES_PER_S * 1e3
    del leaves, emb
    F = cfg.frontend_len
    eng = Engine(lm, params, max_len=F + FIXED_PROMPT + FIXED_NEW,
                 sampling=SamplingParams(greedy=True))
    eng.generate(prompts[:, :64], max_new_tokens=2, frontend_embeds=fe)
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = eng.generate(prompts, max_new_tokens=1, frontend_embeds=fe)
    torch.cuda.synchronize()
    rec["ttft_s"] = time.perf_counter() - t
    reset_attention_counts(wrappers)
    t = time.perf_counter()
    toks = eng.generate(prompts, max_new_tokens=FIXED_NEW,
                        frontend_embeds=fe)
    torch.cuda.synchronize()
    rec["s"] = time.perf_counter() - t
    rec["launches"] = read_attention_counts(wrappers)
    rec["step_s"] = (rec["s"] - rec["ttft_s"]) / (FIXED_NEW - 1)
    rec["tok_s"] = FIXED_BATCH * FIXED_NEW / rec["s"]
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if toks.shape != (FIXED_BATCH, FIXED_NEW) or not torch.equal(
            toks[:, :1], first) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name} Engine.generate: bad tokens "
                             f"{tuple(toks.shape)}")
    want = {"tiles": cfg.num_layers, "tiles_state": 0, "lens_decode": 0,
            "lens_prefix": 0, "flash_attention": 0}
    if rec["launches"] != want:
        raise AssertionError(f"{cfg.name} Engine: launches "
                             f"{rec['launches']}, reckoned {want} (the tiles "
                             f"kernel once a layer, in the one prefill)")
    rec["profile"] = device_breakdown(lambda: eng.generate(
        prompts, max_new_tokens=PROFILE_NEW, frontend_embeds=fe))
    logits, _ = lm.prefill(params, prompts, fe)
    with registry.use_backend("torch"):
        plain, _ = lm.prefill(params, prompts, fe)
    rec["a_max_abs"] = float((logits.float() - plain.float()).abs().max())
    rec["a_scale"] = float(plain.float().abs().max())
    rec["a_argmax_agree"] = float(
        (logits.argmax(-1) == plain.argmax(-1)).float().mean())
    if not rec["a_max_abs"] <= 8 * 2.0 ** -8 * rec["a_scale"]:
        raise AssertionError(f"{cfg.name} (a) prefill logits: max |cuda - "
                             f"torch| {rec['a_max_abs']} above 8 bf16 ulps "
                             f"of {rec['a_scale']}")
    rec["peak_gb_all"] = torch.cuda.max_memory_allocated() / 1e9
    del lm, params, eng, first, toks, logits, plain
    free_card(torch)
    return rec


def run_frontend_path(torch, wrappers, train_wrappers) -> dict:
    """Phase 2h: the VLM and audio families.  For qwen2-vl-72b and
    musicgen-medium: (a-f32) and (g-frontend) at full width in f32
    (hold_frontend_planes), then the config through the Engine
    (serve_frontend): qwen2-vl at full width cut to the depth the card's
    free memory holds (vlm_serve_layers), musicgen whole.  Then musicgen
    trains whole (train_config, as phase 2g trains, on the learnable
    pattern behind frame embeddings), and qwen2-vl's training path is held by
    (d) alone, in f32 at FRONT_CHECK_LAYERS layers on VLM_GRAD_BATCH x
    (1024 + 512) positions: M-RoPE through the tiles backward at 64/8, d
    128 (its parameters, gradients and moments fit one card at no depth: a
    layer is 3.37 B parameters with the embeddings, 26 bytes each at the
    update's peak).  Returns the phase's numbers by config."""
    from repro_torch.configs import get_config

    g = torch.Generator(device="cuda").manual_seed(4)
    out = {"free_gb": free_card(torch)[0]}
    for arch in (VLM_ARCH, AUDIO_ARCH):
        base = get_config(arch)
        clock = time.perf_counter()
        prompts = torch.randint(0, base.vocab_size,
                                (FIXED_BATCH, FIXED_PROMPT), generator=g,
                                device="cuda")
        fe = torch.randn((FIXED_BATCH, base.frontend_len, base.d_model),
                         generator=g, device="cuda")
        rec = hold_frontend_planes(torch, base, prompts, fe)
        rec["checks_s"] = time.perf_counter() - clock
        rec["frontend_len"] = base.frontend_len
        cfg = base
        if arch == VLM_ARCH:
            layers, terms = vlm_serve_layers(base, free_card(torch)[0] * 1e9)
            rec["depth_terms"] = terms
            log(f"phase 2h: {arch} serves at {layers} of {base.num_layers} "
                f"layers: {terms['free'] / 1e9:.2f} GB free, less "
                f"{terms['embeddings'] / 1e9:.2f} GB of embeddings and "
                f"{terms['transient'] / 1e9:.2f} GB for the largest "
                f"transient and slack, over {terms['layer'] / 1e9:.3f} GB a "
                f"layer and {terms['kv_per_layer'] / 1e9:.3f} GB of K/V")
            cfg = dataclasses.replace(base, num_layers=layers)
        rec.update(serve_frontend(torch, cfg, prompts, fe, wrappers))
        rec["s_all"] = time.perf_counter() - clock
        out[arch] = rec
        del prompts, fe
    t = time.perf_counter()
    audio = get_config(AUDIO_ARCH)
    out["train"] = train_config(
        torch, audio, None, FRONT_CHECK_LAYERS,
        frontend_data(TRAIN_BATCH, TRAIN_SEQ, audio.frontend_len,
                      audio.d_model), train_wrappers, "2h")
    out["train"]["s_all"] = time.perf_counter() - t
    t = time.perf_counter()
    vlm = dataclasses.replace(get_config(VLM_ARCH),
                              num_layers=FRONT_CHECK_LAYERS)
    batch = frontend_data(VLM_GRAD_BATCH, TRAIN_SEQ, vlm.frontend_len,
                          vlm.d_model).batch(0)
    rel, _ = check_gradient_planes(torch, vlm, batch, train_wrappers)
    out["vlm_d"] = {"d_rel": rel, "s": time.perf_counter() - t}
    return out


# -- phase 2j: mesh scope ----------------------------------------------------

#: Ranks of the mesh phases' one world (2j, 2k and 2l,
#: :func:`run_mesh_world`), all on the one card: gloo, every collective
#: staged through host memory (NCCL refuses two ranks on one card,
#: "Duplicate GPU detected").  Its times are not scaling numbers.
MESH_RANKS = 4
#: Seconds phase 2j may take on a rank, spawn and set-up included.
MESH_TIMEOUT_S = 300
#: The JAX suites' tolerances (tests/test_distributed_numerics.py,
#: test_sparse.py, test_spgemm.py): (rtol, atol) per path.
MESH_TOL = {"matmul": (1e-4, 1e-4), "spmv": (1e-4, 1e-4),
            "fft": (1e-3, 1e-2), "cg": (1e-5, 1e-5), "spmm": (1e-4, 1e-4),
            "spgemm": (1e-5, 1e-5)}


def mesh_inputs(csr, z_np, a_np, b_np, spd_np, bcg_np) -> dict:
    """Phase 2a's inputs as numpy, for phase 2j's ranks (the mod2as CSR
    as its three arrays, so no rank redraws 6 M nonzeros)."""
    return {"a": a_np, "b": b_np, "z": z_np, "spd": spd_np, "bcg": bcg_np,
            "csr": (csr.matvals.cpu().numpy(), csr.indx.cpu().numpy(),
                    csr.rowp.cpu().numpy(), csr.shape)}


def mesh_rank(rank: int, world: int, device: str, inp: dict) -> dict:
    """One rank of phase 2j: three meshes over the world in turn, O3
    (data 4, model 1), (data 2, model 2) and O4 (pod 2, data 2, model 1),
    and on them the paths at phase 2a/2b's sizes through the entry points
    (``ops.matmul``, ``ops.fft``, ``solver_spmv``, ``cg_solve``,
    ``sparse.spmm``, ``sparse.spgemm``).  Each path: the variant the
    registry selected; the gathered result against the O2 result on this
    rank, at :data:`MESH_TOL`; ``matmul`` launched once a mesh product; the
    profiled collective bytes of ``mesh_psum`` against its plan's
    schedule.  Returns the rows, the transports, the launches and a
    digest of every gathered result (the ranks must agree bit for bit)."""
    import hashlib

    import torch

    t_start = time.perf_counter()
    on_card = device == "cuda"          # (a rehearsal on the host runs the
    #                                     plain versions: no kernel launches)
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed.tensor  # noqa: F401  (timed with the imports)

    import repro_torch.core as C
    import repro_torch.sparse as S
    from repro_torch.core import ExecLevel, registry, use_level
    from repro_torch.distributed.collectives import reduce_plan
    from repro_torch.distributed.sharding import gather
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.numerics import solvers, sparse
    from repro_torch.numerics.sparse import CSR
    from repro_torch.utils.profile import collective_bytes

    def sync():
        if on_card:
            torch.cuda.synchronize()

    meshes = {"O3": (ExecLevel.O3, make_mesh(data=world, device_type=device)),
              "2d": (ExecLevel.O3, make_mesh(data=2, model=world // 2,
                                             device_type=device)),
              "O4": (ExecLevel.O4, make_mesh(data=world // 2, pod=2,
                                             device_type=device))}
    out = {"transports": {k: reduce_plan(m).transports()
                          for k, (_, m) in meshes.items()},
           "rows": [], "digests": {}, "setup_s": time.perf_counter() - t_start}

    def bind(x):
        return C.bind(x, device=device).data

    def run(key, label, op, call, want, tol, select_args):
        """``call()`` under mesh ``key``: the selected variant, the gathered
        result against ``want``, the wall time."""
        level, mesh = meshes[key]
        with use_level(level, mesh):
            name = registry.select(op, *select_args).name
            before = mm_k.matmul.launches
            sync()
            t = time.perf_counter()
            got = call()
            sync()
            ms = (time.perf_counter() - t) * 1e3
            launches = mm_k.matmul.launches - before
        got = gather(C.unwrap(got))
        rtol, atol = MESH_TOL[tol]
        torch.testing.assert_close(got, want.to(got.dtype), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{label}: {m}")
        err = float((got - want.to(got.dtype)).abs().max())
        out["rows"].append((key, label, name, err, ms, launches))
        out["digests"][f"{key} {label}"] = hashlib.sha1(
            got.cpu().numpy().tobytes()).hexdigest()
        return name, got, launches

    # mod2am n 1024: mesh_psum (O3, O4), mesh_psum_2d (2d), one product a
    # rank each, bitwise equal on a second call
    a, b = bind(inp["a"]), bind(inp["b"])
    want = ops.matmul(a, b)
    mm_k.matmul.launches = 0
    for key, variant in (("O3", "mesh_psum"), ("2d", "mesh_psum_2d"),
                         ("O4", "mesh_psum")):
        name, got, n = run(key, "mod2am", "matmul", lambda: ops.matmul(a, b),
                           want, "matmul", (a, b))
        if name != variant or n != int(on_card):
            raise AssertionError(f"mod2am on {key}: {name} with {n} matmul "
                                 f"launches, expected {variant} with 1")
        with use_level(*meshes[key]):
            again = gather(ops.matmul(a, b))
        if not torch.equal(again, got):
            raise AssertionError(f"mod2am on {key}: two calls differ")
    # the collective bytes of mesh_psum against its plan's schedule: a
    # reduce-scatter of the whole M x N f32 partial over data, then the
    # pod's all-reduce of the scattered part
    from torch.profiler import ProfilerActivity, profile
    for key in ("O3", "O4"):
        level, mesh = meshes[key]
        plan = reduce_plan(mesh)
        size, want_bytes = a.shape[0] * b.shape[1] * 4, {}
        for coll, axis in plan.schedule("reduce_scatter"):
            kind = coll.replace("_", "-")
            want_bytes[kind] = want_bytes.get(kind, 0) + size
            if coll == "reduce_scatter":
                size //= plan.topo.size(axis)
        with use_level(level, mesh), profile(
                activities=[ProfilerActivity.CPU], record_shapes=True) as p:
            ops.matmul(a, b)
            sync()
        got_bytes = {k: v for k, v in collective_bytes(p).items()
                     if k != "total"}
        if got_bytes != want_bytes:
            raise AssertionError(f"mesh_psum on {key}: collective bytes "
                                 f"{got_bytes}, the plan {want_bytes}")
        out[f"collective_bytes_{key}"] = got_bytes
    # one launch a rank for each mesh product: on O3 and O4 the checked
    # call, its bitwise repeat and the profiled call, on 2d the first two
    out["launches"] = mm_k.matmul.launches
    if out["launches"] != 8 * on_card:
        raise AssertionError(f"mod2am: {out['launches']} matmul launches on "
                             f"rank {rank}, reckoned 8")

    # mod2as n 10240 at 5.72 %: mesh_csr, mesh_ell (O3)
    vals, indx, rowp, shape = inp["csr"]
    csr = CSR(matvals=bind(vals), indx=bind(indx), rowp=bind(rowp),
              shape=tuple(shape))
    ell = sparse.ell_from_csr(csr)
    xs = bind(np.random.default_rng(shape[0]).standard_normal(shape[0])
              .astype(np.float32))
    for m, variant in ((csr, "mesh_csr"), (ell, "mesh_ell")):
        want = C.unwrap(registry.dispatch("solver_spmv", m, C.wrap(xs)))
        name, _, _ = run("O3", f"mod2as {variant}", "solver_spmv",
                         lambda: registry.dispatch("solver_spmv", m,
                                                   C.wrap(xs)),
                         want, "spmv", (m, C.wrap(xs)))
        if name != variant:
            raise AssertionError(f"mod2as: {name}, expected {variant}")

    # mod2f 2^20: mesh_transpose (O3 D = 4, O4 D = 2)
    z = bind(inp["z"])
    want = ops.fft(z)
    for key in ("O3", "O4"):
        name, _, _ = run(key, "mod2f", "fft", lambda: ops.fft(z), want,
                         "fft", (z,))
        if name != "mesh_transpose":
            raise AssertionError(f"mod2f on {key}: {name}")

    # CG conf 18 through cg_mesh: mesh_dia (O3, O4), mesh_csr (O3)
    spd, bcg = inp["spd"], C.bind(inp["bcg"], device=device)
    dia = sparse.dia_from_dense(spd, device=device)
    cg_csr = sparse.csr_from_dense(spd, device=device)
    chips = {}
    for key, m, variant in (("O3", dia, "mesh_dia"), ("O3", cg_csr,
                                                      "mesh_csr"),
                            ("O4", dia, "mesh_dia")):
        if variant not in chips:
            chips[variant] = solvers.cg_solve(m, bcg, stop=1e-10,
                                              max_iters=2 * len(spd))
        chip = chips[variant]
        res = {}

        def solve():
            res["r"] = solvers.cg_solve(m, bcg, stop=1e-10,
                                        max_iters=2 * len(spd))
            return res["r"].x
        name, _, _ = run(key, f"cg conf 18 {variant}", "solver_spmv", solve,
                         chip.x.data, "cg", (m, bcg))
        k, k0 = int(res["r"].iterations), int(chip.iterations)
        if name != variant or abs(k - k0) > (0 if key == "O3" else 1):
            raise AssertionError(f"cg {variant} on {key}: {name}, {k} "
                                 f"iterations against {k0}")

    # SpMM n 1024, k 8 and 64: mesh_spmm on the DIA, ELL and CSR classes
    for label, dense, fmt in spmm_classes(sparse, SPMM_N):
        if fmt == "bsr":
            continue                    # BSR stays a chip formulation
        m = S.matrix(dense, format=fmt, device=device)
        for k in SPMM_RHS:
            x = bind(np.random.default_rng(k).standard_normal((SPMM_N, k))
                     .astype(np.float32))
            want = C.unwrap(S.spmm(m, x))
            name, _, _ = run("O3", f"spmm {label} k{k}", "spmm",
                             lambda: S.spmm(m, x), want, "spmm",
                             (m, C.wrap(x)))
            if name != "mesh_spmm":
                raise AssertionError(f"spmm {label}: {name}")

    # SpGEMM n 2048, bs 8 (the timed clustered case): mesh_spgemm, C
    # block-row-sharded (O3 4 x 1, 2d 2 x 2 Cannon, O4 4 x 1)
    ga = S.bsr_from_dense(clustered(SPGEMM_N, 0.2, 1), block=SPGEMM_BLOCK,
                          device=device)
    gb = S.bsr_from_dense(clustered(SPGEMM_N, 0.2, 2), block=SPGEMM_BLOCK,
                          device=device)
    want = torch.as_tensor(S.spgemm(ga, gb).todense(), device=device)
    for key in ("O3", "2d", "O4"):
        prod = {}

        def product():
            prod["c"] = S.spgemm(ga, gb)
            return torch.as_tensor(prod["c"].todense(), device=device)
        name, _, _ = run(key, "spgemm", "spgemm", product, want, "spgemm",
                         (ga, gb))
        c = prod["c"]
        sh = c.out_sharding
        if name != "mesh_spgemm" or sh is None or \
                tuple(c.values.placements) != sh.placements:
            raise AssertionError(f"spgemm on {key}: {name}, out_sharding "
                                 f"{sh}")
        out.setdefault("spgemm_sharding", {})[key] = str(sh)
    return out


def mesh_path_results(torch, ranks: list, inp: dict,
                      device: str = "cuda") -> dict:
    """Phase 2j's results: :func:`mesh_rank` 's on every rank of the world,
    held against each other (every gathered result the same bits on every
    rank), then, in this process, which has no process group,
    ``use_level(O3)`` on the one-process mesh: every selection degrades to
    chip and gives the O2 bits."""
    t = time.perf_counter()
    out = {"rank0": ranks[0], "launches": sum(r["launches"] for r in ranks)}
    for r, res in enumerate(ranks[1:], 1):
        if res["digests"] != ranks[0]["digests"]:
            bad = [k for k in res["digests"]
                   if res["digests"][k] != ranks[0]["digests"].get(k)]
            raise AssertionError(f"phase 2j: rank {r} gathered other bits "
                                 f"than rank 0 for {bad}")
    out["setup_s"] = max(r["setup_s"] for r in ranks)
    out["slowest_ms"] = {f"{key} {label}": max(
        row[4] for res in ranks for row in res["rows"]
        if row[:2] == (key, label)) for key, label, *_ in ranks[0]["rows"]}

    import repro_torch.core as C
    from repro_torch.core import ExecLevel, registry, use_level
    from repro_torch.kernels import ops
    from repro_torch.numerics import solvers, sparse

    a, b = (C.bind(inp[k], device=device).data for k in ("a", "b"))
    z = C.bind(inp["z"], device=device).data
    dia = sparse.dia_from_dense(inp["spd"], device=device)
    bcg = C.bind(inp["bcg"], device=device)

    def paths():
        return (ops.matmul(a, b), ops.fft(z),
                solvers.cg_solve(dia, bcg, stop=1e-10, max_iters=2048).x.data)
    chip = paths()
    with use_level(ExecLevel.O3) as ctx:
        scopes = [registry.select("matmul", a, b).scope,
                  registry.select("fft", z).scope,
                  registry.select("solver_spmv", dia, bcg).scope]
        same = [torch.equal(g, w) for g, w in zip(paths(), chip)]
    if scopes != ["chip"] * 3 or not all(same) or ctx.mesh.shape != (1, 1):
        raise AssertionError(f"phase 2j, no process group: scopes {scopes}, "
                             f"bitwise equal {same}, mesh {ctx.mesh}")
    out["one_process"] = ctx.mesh.shape
    out["s"] = time.perf_counter() - t
    return out


def report_mesh_path(mesh: dict) -> None:
    """Log phase 2j's rows and checks (:func:`run_mesh_path`)."""
    r0 = mesh["rank0"]
    for key, tr in r0["transports"].items():
        log(f"  transports on {key}: " + ", ".join(
            f"{c} {t}" for c, t in tr.items())
            + " (NCCL not used: it refuses two ranks on one card)")
    for key, label, name, err, ms, launches in r0["rows"]:
        slowest = mesh["slowest_ms"][f"{key} {label}"]
        log(f"  {key} {label}: {name}, max |mesh - O2| {err:.3g}, "
            f"{ms:.2f} ms on rank 0 ({slowest:.2f} ms the slowest rank)"
            + (f", matmul launches {launches}" if launches else ""))
    for key in ("O3", "O4"):
        log(f"  mesh_psum on {key}: collective bytes a rank "
            f"{r0[f'collective_bytes_{key}']}, as the plan's schedule")
    log(f"  spgemm out_sharding: {r0['spgemm_sharding']}; a rank's set-up "
        f"(imports, the card, three meshes and their groups) at most "
        f"{mesh['setup_s']:.2f} s")
    log(f"  every gathered result the same bits on all {MESH_RANKS} ranks; "
        f"no process group: use_level(O3) on the {mesh['one_process']} mesh "
        f"gives chip variants and the O2 bits")


# -- phase 2k: serving at mesh scope ------------------------------------------

#: Phase 2k runs in phase 2j's world (:func:`run_mesh_world`), on its
#: MESH_RANKS ranks.
#: Seconds phase 2k may take on a rank.
RING_TIMEOUT_S = 600
#: (k2): the Engine at O3 on one prompt of RING_PROMPT tokens (a multiple
#: of 2 x MESH_RANKS: the zig-zag layout's half-blocks), RING_NEW new.
RING_PROMPT, RING_NEW = 8192, 32
#: (k1) the JAX suite's tolerances (tests/test_ring_attention.py:154,
#: :192): (rtol, atol) of ring against chip attention; bf16 inputs with
#: v scaled by 0.1, as there.
RING_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (0.0, 1e-3)}
#: (k1) the sequence layouts: (name, causal, order).
RING_LAYOUTS = (("zigzag", True, "zigzag"), ("contiguous", True,
                                              "contiguous"),
                ("full", False, "contiguous"))


def ring_shard_calls(length: int, ring: int) -> tuple:
    """(lq, lk, causal) of every per-shard state call a zig-zag causal
    ring of ``ring`` ranks makes over ``length`` tokens
    (``distributed/attention.py`` ``_ring_run``): hop 0's causal
    half-blocks (the tiles walk) and its full q_hi x k_lo, then the full
    hops h <= r (the whole q panel x k_lo) and h > r (q_hi x the whole
    visiting panel), on the dense grid."""
    n = length // ring
    h = n // 2
    return ((h, h, True), (h, h, False), (n, h, False), (h, n, False))


def hold_ring_shard_kernels(torch, device: str, cfg, ring: int) -> list:
    """Phase 2k's kernels against their plain versions at the shapes its
    main path gives them per shard, in the path's dtype: the state kernels
    at (k2)'s shapes (:func:`ring_shard_calls` of RING_PROMPT tokens), and
    the lens kernel's state variant over every shard's view of (k3)'s
    striped pool (``kvcache.shard_view`` of phase 2c's first SERVE_SLOTS
    requests at their full length, some shards with no live key).  Each
    goes through the state op's dispatch with the plane pinned, as the
    ring's calls do; o is held at :func:`attn_tol`, m and l at phase 1's
    tolerances.  Returns (what, max |o - plain|) rows."""
    from repro_torch.core import registry
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.serve import Request, Scheduler, make_spec
    from repro_torch.serve.kvcache import shard_view
    from repro_torch.sparse.maskcompiler import causal_layout

    dtype = cfg.act_dtype
    plane = "cuda" if device == "cuda" else "torch"
    rtol, atol = attn_tol(torch, dtype)
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(29)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=device).to(dtype)

    rows = []

    def hold(what, got, want, lk, live):
        if device == "cuda":
            torch.cuda.synchronize()
        if not torch.all(got[1][~live] == fa_k.NEG_INF):
            raise AssertionError(f"{what}: a row with no live key has "
                                 f"m != NEG_INF")
        for i, (rt, at) in enumerate(((rtol, atol), (1e-5, 1e-5),
                                      (1e-5, 1e-5 * lk))):
            torch.testing.assert_close(
                got[i][live].float(), want[i][live].float(), rtol=rt,
                atol=at, msg=lambda m: f"{what}: {'oml'[i]}: {m}")
        rows.append((what, float((got[0][live].float()
                                  - want[0][live].float()).abs().max())))

    for lq, lk, causal in ring_shard_calls(RING_PROMPT, ring):
        q, k, v = randn(1, hq, lq, d), randn(1, hk, lk, d), randn(1, hk, lk,
                                                                  d)
        got = registry.dispatch("flash_attention_state", q, k, v,
                                causal=causal, variant=plane)
        want = (fa_k.flash_attention_tiles_plain(
            q, k, v, causal_layout(lq, lk, 128, 128), return_state=True)
            if causal else fa_k.flash_attention_plain(
                q, k, v, causal=False, return_state=True))
        hold(f"(k2) shard {'tiles' if causal else 'dense'} state "
             f"{lq}x{lk}", got, want, lk, torch.ones((1,), dtype=torch.bool,
                                                     device=device))
    spec = make_spec(cfg, num_slots=SERVE_SLOTS, max_tokens=SERVE_MAX_LEN,
                     ring=ring)
    sched = Scheduler(spec, queue_depth=SERVE_SLOTS)
    totals = [p + m for p, m in SERVE_REQS[:SERVE_SLOTS]]
    for rid, tot in enumerate(totals):
        sched.submit(Request(rid=rid, prompt=np.zeros(tot, np.int32),
                             max_new=0))
        sched.admit_next()
    sched.lens[:] = totals
    table = torch.as_tensor(sched.table, device=device)
    lens = torch.as_tensor(sched.lens, device=device)
    q1 = randn(SERVE_SLOTS, hq, 1, d)
    pool = (spec.pages_per_shard, hk, spec.page_size, d)
    for r in range(ring):
        kg, vg, llen = shard_view(randn(*pool), randn(*pool), table, lens, r,
                                  ring)
        got = registry.dispatch("flash_attention_state", q1, kg, vg,
                                causal=False, kv_len=llen, variant=plane)
        want = fa_k.flash_attention_plain(q1, kg, vg, causal=False,
                                          kv_len=llen, return_state=True)
        hold(f"(k3) shard {r} lens state 1x{kg.shape[2]} kv_len "
             f"{llen.tolist()}", got, want, kg.shape[2], llen > 0)
    return rows


def ring_serve_rank(rank: int, world: int, device: str) -> dict:
    """One rank of phase 2k.  (k1) ``ring_attention`` on O3 (data 4), O4
    (pod 2, data 2) and (data 2, model 2) against the chip
    ``flash_attention`` on this rank, and ``paged_ring_attention`` at O4
    against the ``gather`` variant; (k2) qwen3-1.7b whole through the
    Engine at O3 on one RING_PROMPT-token prompt, against the O2 Engine;
    (k3) phase 2c's requests through the ContinuousEngine at O3 against
    the O2 one, in f32 at 2 layers and in bf16 whole.  Returns the rows,
    the launches and a digest of every result (the ranks must agree bit
    for bit)."""
    import hashlib

    import torch

    t_start = time.perf_counter()
    on_card = device == "cuda"          # (a rehearsal on the host runs the
    #                                     plain versions: no kernel launches)
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed.tensor  # noqa: F401  (timed with the imports)

    from repro_torch.configs import get_config
    from repro_torch.core import ExecLevel, registry, use_level
    from repro_torch.distributed.attention import ring_attention
    from repro_torch.distributed.collectives import ring_plan
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.serve import (ContinuousEngine, Engine, Request,
                                   SamplingParams, Scheduler, make_spec)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    wrappers = {"flash_attention": fa_k.flash_attention,
                "flash_attention_lens": fa_k.flash_attention_lens,
                "flash_attention_tiles": fa_k.flash_attention_tiles}
    meshes = {"O3": (ExecLevel.O3, make_mesh(data=world, device_type=device)),
              "O4": (ExecLevel.O4, make_mesh(data=world // 2, pod=2,
                                             device_type=device)),
              "2d": (ExecLevel.O3, make_mesh(data=2, model=world // 2,
                                             device_type=device))}
    out = {"rows": [], "digests": {}, "seconds": {},
           "setup_s": time.perf_counter() - t_start}

    def digest(key, t):
        out["digests"][key] = hashlib.sha1(
            t.detach().float().cpu().numpy().tobytes()).hexdigest()

    # -- (k1) the ops --------------------------------------------------------
    t = time.perf_counter()
    B, hq, hk, L, d = ATTN_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        rng = np.random.default_rng(27)
        vscale = 0.1 if dtype == torch.bfloat16 else 1.0
        q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32) * sc, device=device).to(dtype)
            for shape, sc in (((B, hq, L, d), 1.0), ((B, hk, L, d), 1.0),
                              ((B, hk, L, d), vscale)))
        rtol, atol = RING_TOL[dname]
        for layout, causal, order in RING_LAYOUTS:
            chip = ops.flash_attention(q, k, v, causal=causal)
            for key, (level, mesh) in meshes.items():
                W = ring_plan(mesh).size
                with use_level(level, mesh):
                    name = registry.select("flash_attention", q, k, v,
                                           causal=causal).name
                    reset_attention_counts(wrappers)
                    sync()
                    t0 = time.perf_counter()
                    got = ring_attention(q, k, v, causal=causal, order=order)
                    sync()
                    ms = (time.perf_counter() - t0) * 1e3
                    n = read_attention_counts(wrappers)
                what = f"(k1) ring {layout} {dname} on {key}"
                if name != "ring":
                    raise AssertionError(f"{what}: selected {name}")
                torch.testing.assert_close(got, chip, rtol=rtol, atol=atol,
                                           msg=lambda m: f"{what}: {m}")
                err = float((got.float() - chip.float()).abs().max())
                # zig-zag: 2 causal half-blocks on the tiles walk and W full
                # calls on the dense grid; full: W dense calls
                want = {"zigzag": (2, W), "full": (0, W)}.get(layout)
                got_n = (n["tiles_state"], n["flash_attention"])
                if on_card and want is not None and got_n != want:
                    raise AssertionError(f"{what}: (tiles, dense) state "
                                         f"launches {got_n}, reckoned {want}")
                out["rows"].append(("k1", f"{layout} {dname} {key}", name,
                                    err, ms, got_n))
                digest(f"k1 {layout} {dname} {key}", got)

    # paged decode at phase 2c's shape: 4 slots of capacity SERVE_MAX_LEN,
    # pages of 64; the pool striped over the O4 ring
    cfg = get_config(ARCH)
    level, mesh = meshes["O4"]
    W = ring_plan(mesh).size
    spec = make_spec(cfg, num_slots=SERVE_SLOTS, max_tokens=SERVE_MAX_LEN,
                     ring=W)
    sched = Scheduler(spec, queue_depth=SERVE_SLOTS)
    totals = [p + m for p, m in SERVE_REQS[:SERVE_SLOTS]]
    for rid, tot in enumerate(totals):
        sched.submit(Request(rid=rid, prompt=np.zeros(tot, np.int32),
                             max_new=0))
        sched.admit_next()
    sched.lens[:] = totals
    rng = np.random.default_rng(28)
    pool_shape = (spec.num_pages, cfg.num_kv_heads, spec.page_size,
                  cfg.head_dim)
    table = torch.as_tensor(sched.table, device=device)
    lens = torch.as_tensor(sched.lens, device=device)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q1, kp, vp = (torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=device).to(dtype)
            for shape in ((SERVE_SLOTS, cfg.num_heads, 1, cfg.head_dim),
                          pool_shape, pool_shape))
        chip = ops.paged_attention(q1, kp, vp, table, lens, variant="gather")
        with use_level(level, mesh):
            lo, hi = spec.shard_range(ring_plan(mesh).ring_index())
            mine = (kp[lo:hi], vp[lo:hi])
            name = registry.select("paged_attention", q1, *mine, table,
                                   lens).name
            sync()
            t0 = time.perf_counter()
            got = ops.paged_attention(q1, *mine, table, lens)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        what = f"(k1) paged ring {dname} on O4"
        rtol, atol = attn_tol(torch, dtype)
        if name != "ring":
            raise AssertionError(f"{what}: selected {name}")
        torch.testing.assert_close(got, chip, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what}: {m}")
        out["rows"].append(("k1", f"paged {dname} O4", name, float(
            (got.float() - chip.float()).abs().max()), ms, None))
        digest(f"k1 paged {dname}", got)
    del q, k, v, q1, kp, vp, chip, got
    # the kernels at the per-shard shapes of (k2) and (k3), on the O3 ring
    out["holds"] = hold_ring_shard_kernels(torch, device, cfg, ring_plan(
        meshes["O3"][1]).size)
    out["seconds"]["k1"] = time.perf_counter() - t

    # -- (k2) the Engine at O3, qwen3-1.7b whole ------------------------------
    t = time.perf_counter()
    lm = LM(cfg)
    params = lm.init(0, device=device)
    greedy = SamplingParams(greedy=True)
    g = torch.Generator(device=device).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, RING_PROMPT), generator=g,
                           device=device)
    level, mesh = meshes["O3"]
    o2 = Engine(lm, params, max_len=RING_PROMPT + RING_NEW, sampling=greedy)
    with use_level(level, mesh):
        o3 = Engine(lm, params, max_len=RING_PROMPT + RING_NEW,
                    sampling=greedy)
        out["k2_prefill_variant"] = registry.select(
            "flash_attention", *(torch.empty(
                (1, h, RING_PROMPT, cfg.head_dim), dtype=cfg.act_dtype,
                device=device) for h in (cfg.num_heads, cfg.num_kv_heads,
                                         cfg.num_kv_heads)),
            causal=True, mask=cfg.attn_mask_spec()).name
    if out["k2_prefill_variant"] != "ring":
        raise AssertionError(f"(k2) prefill selected "
                             f"{out['k2_prefill_variant']}")
    for eng in (o2, o3):                                    # warm-up
        eng.generate(prompt[:, :256], max_new_tokens=2)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res = {}
    for key, eng in (("o2", o2), ("o3", o3)):
        sync()
        t0 = time.perf_counter()
        eng.generate(prompt, max_new_tokens=1)
        sync()
        res[f"{key}_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        reset_attention_counts(wrappers)
        t0 = time.perf_counter()
        toks = eng.generate(prompt, max_new_tokens=RING_NEW)
        sync()
        res[f"{key}_s"] = time.perf_counter() - t0
        res[f"{key}_launches"] = read_attention_counts(wrappers)
        res[f"{key}_tokens"] = toks[0].tolist()
        res[f"{key}_decode_tok_s"] = (RING_NEW - 1) / (
            res[f"{key}_s"] - res[f"{key}_prefill_ms"] / 1e3)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card \
        else 0.0
    # one prefill's per-rank launches, reckoned from the code: a layer's
    # zig-zag ring makes 2 causal half-block calls (tiles state) and W full
    # calls (dense grid state); the fixed-cache decode launches none
    W = ring_plan(mesh).size
    want = {"tiles": 0, "tiles_state": cfg.num_layers * 2,
            "lens_decode": 0, "lens_prefix": 0,
            "flash_attention": cfg.num_layers * W}
    if on_card and res["o3_launches"] != want:
        raise AssertionError(f"(k2) one O3 generate launched "
                             f"{res['o3_launches']}, reckoned {want}")
    # the last position's logits under each engine's level
    logits2, _ = lm.prefill(params, prompt)
    with use_level(o3.active_level.level, o3.active_level.mesh):
        logits3, _ = lm.prefill(params, prompt)
    scale = float(logits2.float().abs().max())
    res["logit_max_abs"] = float((logits3.float() - logits2.float()).abs()
                                 .max())
    res["logit_scale"] = scale
    if not res["logit_max_abs"] <= 8 * 2.0 ** -8 * scale:
        raise AssertionError(f"(k2) O3 prefill logits: max |O3 - O2| "
                             f"{res['logit_max_abs']} above 8 bf16 ulps of "
                             f"{scale}")
    res["tokens_equal"] = sum(a == b for a, b in zip(res["o3_tokens"],
                                                     res["o2_tokens"]))
    digest("k2 logits", logits3)
    out["digests"]["k2 tokens"] = str(res["o3_tokens"])
    out["k2"] = res
    del o2, o3, logits2, logits3
    out["seconds"]["k2"] = time.perf_counter() - t

    # -- (k3) the ContinuousEngine at O3 --------------------------------------
    t = time.perf_counter()
    reqs = serve_requests(cfg.vocab_size)

    def engines(model, p):
        kw = dict(num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                  chunk_size=SERVE_CHUNK, sampling=greedy)
        e2 = ContinuousEngine(model, p, **kw)
        with use_level(level, mesh):
            e3 = ContinuousEngine(model, p, **kw)
        return e2, e3

    # f32 at full width, 2 layers: the tokens equal O2's
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                param_dtype="float32")
    lm32 = LM(cfg32)
    p32 = lm32.init(0, device=device)
    e2, e3 = engines(lm32, p32)
    t0 = time.perf_counter()
    want32 = [x.tolist() for x in e2.serve(reqs)]
    t1 = time.perf_counter()
    got32 = [x.tolist() for x in e3.serve(reqs)]
    f32_s = (t1 - t0, time.perf_counter() - t1)
    bad = [i for i, (a, b) in enumerate(zip(got32, want32)) if a != b]
    if bad:
        raise AssertionError(f"(k3) f32, 2 layers: requests {bad} differ "
                             f"between the O3 and O2 ContinuousEngines")
    out["digests"]["k3 f32 tokens"] = str(got32)
    del e2, e3, p32, lm32

    # bf16 whole: tokens, the first decode step's logits, launches, pools
    e2, e3 = engines(lm, params)
    first = {}

    class Recording:
        """The engine's LM, keeping its first decode step's logits."""

        def __init__(self, key):
            self.key = key

        def __getattr__(self, name):
            return getattr(lm, name)

        def decode_step_paged(self, p, state, tokens, active):
            logits, state = lm.decode_step_paged(p, state, tokens, active)
            if self.key not in first:
                first[self.key] = logits[active > 0].float().clone()
            return logits, state

    k3 = {"f32_s": f32_s}
    for key, eng in (("o2", e2), ("o3", e3)):
        eng.lm = Recording(key)
        reset_attention_counts(wrappers)
        sync()
        t0 = time.perf_counter()
        got = eng.serve(reqs)
        sync()
        k3[f"{key}_s"] = time.perf_counter() - t0
        k3[f"{key}_launches"] = read_attention_counts(wrappers)
        k3[f"{key}_tokens"] = [x.tolist() for x in got]
        k3[f"{key}_tok_s"] = sum(len(x) for x in got) / k3[f"{key}_s"]
        k3[f"{key}_pool_bytes"] = 2 * eng.state["kpages"].nbytes
        k3[f"{key}_pages"] = eng.spec.num_pages
    if [len(x) for x in k3["o3_tokens"]] != [m for _, m in reqs] \
            or len(e3.decode_inputs) != 1:
        raise AssertionError(f"(k3) O3 serve: lengths "
                             f"{[len(x) for x in k3['o3_tokens']]}, decode "
                             f"input signatures {len(e3.decode_inputs)}")
    k3["equal"] = [i for i, (a, b) in enumerate(zip(k3["o3_tokens"],
                                                    k3["o2_tokens"]))
                   if a == b]
    scale = float(first["o2"].abs().max())
    k3["first_step_max_abs"] = float((first["o3"] - first["o2"]).abs().max())
    k3["first_step_scale"] = scale
    if not k3["first_step_max_abs"] <= 8 * 2.0 ** -8 * scale:
        raise AssertionError(f"(k3) first decode step: max |O3 - O2| "
                             f"{k3['first_step_max_abs']} above 8 bf16 ulps "
                             f"of {scale}")
    if on_card and k3["o3_launches"] != k3["o2_launches"]:
        raise AssertionError(f"(k3) launches at O3 {k3['o3_launches']}, at "
                             f"O2 {k3['o2_launches']}")
    # the pool: O2's pages over W, up to make_spec's ring rounding
    per_page = k3["o2_pool_bytes"] // k3["o2_pages"]
    if k3["o3_pool_bytes"] != per_page * k3["o3_pages"] // W:
        raise AssertionError(f"(k3) pool bytes a rank {k3['o3_pool_bytes']},"
                             f" O2's {k3['o2_pool_bytes']} over {W} pages "
                             f"{k3['o3_pages']} / {k3['o2_pages']}")
    out["digests"]["k3 bf16 tokens"] = str(k3["o3_tokens"])
    out["k3"] = k3
    out["seconds"]["k3"] = time.perf_counter() - t
    return out


def ring_path_results(ranks: list) -> dict:
    """Phase 2k's results: :func:`ring_serve_rank` 's on every rank of the
    world; every rank's results the same bits."""
    out = {"rank0": ranks[0]}
    for r, res in enumerate(ranks[1:], 1):
        if res["digests"] != ranks[0]["digests"]:
            bad = [k for k in res["digests"]
                   if res["digests"][k] != ranks[0]["digests"].get(k)]
            raise AssertionError(f"phase 2k: rank {r} has other bits than "
                                 f"rank 0 for {bad}")
    # the main path's launches over the ranks: (k2)'s O3 generate and
    # (k3)'s bf16 O3 serve
    out["launches"] = {
        "flash_attention": sum(r["k2"]["o3_launches"]["flash_attention"]
                               + r["k3"]["o3_launches"]["flash_attention"]
                               for r in ranks),
        "flash_attention_tiles": sum(
            r[k]["o3_launches"][n] for r in ranks for k in ("k2", "k3")
            for n in ("tiles", "tiles_state")),
        "flash_attention_lens": sum(
            r[k]["o3_launches"][n] for r in ranks for k in ("k2", "k3")
            for n in ("lens_decode", "lens_prefix"))}
    out["setup_s"] = max(r["setup_s"] for r in ranks)
    out["seconds"] = {k: max(r["seconds"][k] for r in ranks)
                      for k in ranks[0]["seconds"]}
    return out


def report_ring_path(ring: dict, card: str) -> None:
    """Log phase 2k's rows and checks (:func:`run_ring_path`)."""
    r0 = ring["rank0"]
    for _, label, name, err, ms, n in r0["rows"]:
        log(f"  (k1) {label}: {name}, max |ring - chip| {err:.3g}, "
            f"{ms:.2f} ms on rank 0"
            + (f", (tiles, dense) state launches {n}" if n else ""))
    for what, err in r0["holds"]:
        log(f"  {what}: max |o - plain| {err:.3g}")
    k2, k3 = r0["k2"], r0["k3"]
    log(f"  (k2) {ARCH} whole, bf16, Engine at O3 on {card}: one prompt of "
        f"{RING_PROMPT} tokens, {RING_NEW} new: prefill "
        f"{k2['o3_prefill_ms']:.1f} ms a rank (O2 on the same rank "
        f"{k2['o2_prefill_ms']:.1f} ms), decode {k2['o3_decode_tok_s']:.1f} "
        f"tok/s (O2 {k2['o2_decode_tok_s']:.1f}), peak memory "
        f"{k2['peak_gb']:.2f} GB a rank; launches of one O3 generate a rank "
        f"{k2['o3_launches']}; last-position logits max |O3 - O2| "
        f"{k2['logit_max_abs']:.4g} (scale {k2['logit_scale']:.4g}, bar 8 "
        f"bf16 ulps); {k2['tokens_equal']}/{RING_NEW} tokens equal O2's")
    log(f"  (k3) ContinuousEngine at O3, {len(SERVE_REQS)} requests: f32 at "
        f"2 layers token-equal to O2 on every request (O2 "
        f"{k3['f32_s'][0]:.1f} s, O3 {k3['f32_s'][1]:.1f} s); bf16 whole "
        f"(O2 {k3['o2_s']:.1f} s, O3 {k3['o3_s']:.1f} s): requests "
        f"{k3['equal']} of {len(SERVE_REQS)} token-equal, first "
        f"decode step's logits max |O3 - O2| {k3['first_step_max_abs']:.4g} "
        f"(scale {k3['first_step_scale']:.4g}); {k3['o3_tok_s']:.1f} tok/s "
        f"(O2 on the same rank {k3['o2_tok_s']:.1f}); launches a rank "
        f"{k3['o3_launches']} (O2's the same); pool "
        f"{k3['o3_pool_bytes'] / 1e6:.1f} MB a rank ({k3['o3_pages']} pages "
        f"over {MESH_RANKS}) against O2's {k3['o2_pool_bytes'] / 1e6:.1f} "
        f"MB ({k3['o2_pages']} pages)")
    log(f"  every result the same bits on all {MESH_RANKS} ranks; seconds "
        f"by step (slowest rank) " + ", ".join(
            f"{k} {v:.1f}" for k, v in ring["seconds"].items())
        + f"; a rank's set-up {ring['setup_s']:.2f} s")


# -- phase 2l: training at mesh scope ------------------------------------------

#: (l2): qwen3-1.7b at full width through Trainer(mesh=make_mesh(data=4))
#: at O3, MESH_TRAIN_STEPS AdamW steps of MESH_TRAIN_BATCH x MESH_TRAIN_SEQ
#: tokens of the learnable pattern (the zig-zag ring: 8 half-blocks of
#: 256), at the depth the mesh-aware count fits, capped at
#: MESH_TRAIN_MAX_LAYERS for the phase's time.
MESH_TRAIN_STEPS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 4, 2048
MESH_TRAIN_MAX_LAYERS = 4
#: (l2)'s bf16 bar: each mesh loss within this of the O2 Trainer's.
MESH_BF16_LOSS_TOL = 2e-2
#: (l2)'s f32 checks and (l3): 2 layers, 4 x MESH_CHECK_SEQ tokens; the
#: losses within MESH_F32_LOSS_RTOL relative of O2's, the gradients within
#: MESH_GRAD_REL_TOL of each leaf's largest entry.
MESH_CHECK_LAYERS, MESH_CHECK_SEQ = 2, 1024
MESH_F32_LOSS_RTOL, MESH_GRAD_REL_TOL = 1e-5, 1e-4
#: (l2)'s f32 losses and (l3): MESH_CHECK_STEPS steps; (l3) saves at step
#: MESH_SAVE_AT, the data source fails at MESH_CRASH_AT (the next step's
#: batch), the run resumes to MESH_CHECK_STEPS; the elastic shrink's
#: losses within MESH_ELASTIC_TOL of the uninterrupted run's.
MESH_CHECK_STEPS = 3
MESH_SAVE_AT, MESH_CRASH_AT, MESH_ELASTIC_TOL = 2, 2, 1e-5
#: (l4): elements each rank exchanges through compressed_psum.
COMPRESS_N = 1 << 20


def collective_tally(tracer) -> dict:
    """One traced step's low-level collectives, from their
    ``collective:<kind>`` spans (repro_torch.distributed.collectives):
    operand ``bytes`` and host ``seconds`` by kind, and ``stage_s``, the
    seconds of gloo-host's staging copies inside them (each copy waits for
    the kernels queued before it)."""
    if tracer.dropped:
        raise AssertionError(f"(l2) the tracer dropped {tracer.dropped} "
                             f"events")
    out = {"bytes": {}, "seconds": {}, "stage_s": 0.0}
    for ev in tracer.events():
        if ev["ph"] != "X" or not ev["name"].startswith("collective:"):
            continue
        kind, sec = ev["name"].split(":", 1)[1], ev["dur"] / 1e6
        if kind == "stage":
            out["stage_s"] += sec
            continue
        out["bytes"][kind] = out["bytes"].get(kind, 0) + ev["args"]["bytes"]
        out["seconds"][kind] = out["seconds"].get(kind, 0.0) + sec
    return out


def ring_bwd_tol(torch, dtype, pieces: int) -> tuple[float, float]:
    """(l1)'s bars for ring gradients against the chip backward: f32,
    :func:`bwd_tol`; bf16, two ulps relative and, absolute (times the chip
    gradient's largest entry, at least 1), half an ulp (2^-8 relative) for
    each of the ``pieces`` bf16 partial gradients the ring adds up (each
    kernel call rounds its piece's f32 sums to bf16 once, where the chip's
    one call rounds the whole sum once)."""
    if dtype == torch.float32:
        return bwd_tol(torch, dtype)
    return 2.0 ** -7, pieces * 2.0 ** -8


def ring_bwd_launches(W: int, zigzag: bool) -> dict:
    """One ring call's launches a rank, forward and backward, reckoned from
    ``distributed/attention.py``'s pieces: zig-zag, 2 causal half-block
    pieces (tiles state) and W full ones (dense state), so W + 2 of each
    gradient kernel; full, W of each; one delta kernel either way."""
    pieces = W + 2 if zigzag else W
    return {"tiles_state": 2 if zigzag else 0, "flash_attention": W,
            "fa_bwd_delta": 1, "fa_bwd_dkdv": pieces, "fa_bwd_dq": pieces}


def hold_ring_backward_kernels(torch, device: str, cfg, ring: int, *,
                               seq: int = MESH_TRAIN_SEQ,
                               batch: int = MESH_TRAIN_BATCH) -> list:
    """Phase 2l's backward kernels against flash_attention_tiles_bwd_plain
    at the shapes (l2)'s ring gives them per shard (:func:`ring_shard_calls`
    of ``seq`` tokens, all ``batch`` rows: each rank's sequence shard of
    the whole batch; phase 2m passes its own, and ``cfg`` at its local
    heads), in bf16, on the layout each piece walks (a
    causal half-block pair over ``causal_layout``, a full one over the
    all-live grid), from the plain forward's o and lse.  Held at
    :func:`bwd_tol`; returns (what, max |grad - plain| over the plain's
    largest) rows.  On host tensors (a rehearsal) there is no kernel to
    hold."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import causal_layout, grid_layout

    if device != "cuda":
        return []
    dtype = torch.bfloat16
    rtol, atol = bwd_tol(torch, dtype)
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(31)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=device).to(dtype)

    rows = []
    B = batch
    for lq, lk, causal in ring_shard_calls(seq, ring):
        q, k, v = randn(B, hq, lq, d), randn(B, hk, lk, d), randn(B, hk, lk,
                                                                  d)
        do = randn(B, hq, lq, d)
        layout = causal_layout(lq, lk, 128, 128) if causal \
            else grid_layout(lq, lk, 128, 128, False)
        o, m, l = fa_k.flash_attention_tiles_plain(q, k, v, layout,
                                                   return_state=True)
        lse = fa_k.softmax_lse(m, l)
        want = fa_k.flash_attention_tiles_bwd_plain(q, k, v, o, lse, do,
                                                    layout)
        delta = fa_k.fa_bwd_delta(o, do)
        dk, dv = fa_k.fa_bwd_dkdv(q, k, v, do, lse, delta, layout,
                                  d ** -0.5)
        dq = fa_k.fa_bwd_dq(q, k, v, do, lse, delta, layout, d ** -0.5)
        torch.cuda.synchronize()
        what = f"(l1) shard {'causal' if causal else 'full'} {lq}x{lk}" \
            f" {hq}/{hk} heads"
        torch.testing.assert_close(
            delta, (do.float() * o.float()).sum(-1), rtol=1e-5, atol=1e-5,
            msg=lambda msg: f"{what}: delta: {msg}")
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            scale = max(1.0, float(w.float().abs().max()))
            torch.testing.assert_close(
                g.float(), w.float(), rtol=rtol, atol=atol * scale,
                msg=lambda msg: f"{what}: {name}: {msg}")
            errs.append(float((g.float() - w.float()).abs().max())
                        / float(w.float().abs().max()))
        rows.append((what, max(errs)))
    return rows


def bits_digest(torch, tree) -> str:
    """A digest of every leaf's bits, computed on the leaves' device: the
    raw bits as int64, weighted by position, summed with wrapping (integer
    sums, so any order gives the same digest); ranks compare them."""
    from repro_torch.utils.tree import tree_leaves

    out = []
    for x in tree_leaves(tree):
        flat = x.detach().reshape(-1)
        bits = flat.view({2: torch.int16, 4: torch.int32}[
            flat.element_size()]).to(torch.int64)
        chunk, total = 1 << 24, 0
        for s in range(0, bits.numel(), chunk):
            part = bits[s:s + chunk]
            w = torch.arange(s, s + part.numel(), device=part.device) \
                % 65521 + 1
            total = total + int((part * w).sum())
        out.append(total)
    return str(out)


def mesh_train_layers(cfg, card_bytes: float) -> tuple[int, int]:
    """(l2)'s depth: (the most layers ``train_peak_bytes`` counts into the
    card at data width MESH_RANKS with MESH_RANKS ranks sharing it, each
    rank a row of MESH_TRAIN_SEQ positions and its own TRAIN_SLACK_BYTES;
    that, capped at MESH_TRAIN_MAX_LAYERS)."""
    from repro_torch.launch.train import TRAIN_SLACK_BYTES, train_peak_bytes

    tokens = MESH_TRAIN_BATCH // MESH_RANKS * MESH_TRAIN_SEQ
    room = card_bytes - MESH_RANKS * TRAIN_SLACK_BYTES
    fit = max((n for n in range(1, cfg.num_layers + 1) if train_peak_bytes(
        dataclasses.replace(cfg, num_layers=n), tokens,
        data_width=MESH_RANKS, ranks_per_card=MESH_RANKS) <= room),
        default=0)
    return fit, min(fit, MESH_TRAIN_MAX_LAYERS)


def mesh_train_rank(rank: int, world: int, device: str, tmp: str) -> dict:
    """One rank of phase 2l.  (l1) ring attention's backward on O3 (data 4)
    and O4 (pod 2, data 2), this rank's row of ATTN_SHAPE's batch (the
    mesh trainer's layout), zig-zag causal and contiguous full, in bf16 and
    f32, against the chip backward (``_Attention`` over the whole sequence)
    on the same rows, launches held to :func:`ring_bwd_launches`; the
    backward kernels held at (l2)'s per-shard shapes.  (l2) qwen3-1.7b at
    full width through ``Trainer(mesh=make_mesh(data=4))`` at O3, step by
    step (each step's parameter bits digested), with the launch counts and
    the collectives' bytes and host seconds read from their trace spans
    over the steps; on rank 0
    the O2 Trainer at the same depth on the same batches; in f32 at 2
    layers the gradients of the mesh loss summed over the ranks against
    O2's, and the losses of MESH_CHECK_STEPS steps.  (l3) in f32 at 2
    layers: a save at MESH_SAVE_AT, a crash at MESH_CRASH_AT and a resume
    on (data 4), its
    parameters' bits against the uninterrupted run's; on rank 0 the same
    checkpoint restored at O2 with ``replan(1, ...)``'s microbatches.  (l4)
    ``compressed_psum`` over ``pod`` at O4 against the exact sum.  Returns
    the rows, the launches and digests (the ranks must agree)."""
    import shutil

    import torch

    t_start = time.perf_counter()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        gc.collect()
        torch.cuda.empty_cache()
    import torch.distributed as dist
    import torch.distributed.tensor  # noqa: F401  (timed with the imports)

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import ExecLevel, use_level
    from repro_torch.distributed.attention import ring_attention
    from repro_torch.distributed.collectives import reduce_plan
    from repro_torch.distributed.sharding import sharded_rows
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.models.lm import LM
    from repro_torch.obs.trace import TRACER
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.runtime import replan
    from repro_torch.train.step import mesh_loss, shard_batch, value_and_grad
    from repro_torch.utils.tree import tree_leaves, tree_map

    def sync():
        if on_card:
            torch.cuda.synchronize()

    wrappers = {"flash_attention": fa_k.flash_attention,
                "flash_attention_lens": fa_k.flash_attention_lens,
                "flash_attention_tiles": fa_k.flash_attention_tiles}
    bwd = {k: getattr(fa_k, k) for k in BWD_KERNELS}

    def reset():
        reset_attention_counts(wrappers)
        for w in bwd.values():
            w.launches = 0

    def counts():
        n = read_attention_counts(wrappers)
        n.update({k: w.launches for k, w in bwd.items()})
        return n

    O3, O4 = ExecLevel.O3, ExecLevel.O4
    meshes = {"O3": (O3, make_mesh(data=world, device_type=device)),
              "O4": (O4, make_mesh(data=world // 2, pod=2,
                                   device_type=device))}
    out = {"rows": [], "digests": {}, "seconds": {},
           "setup_s": time.perf_counter() - t_start}

    # -- (l1) ring attention's backward ------------------------------------
    t = time.perf_counter()
    B, hq, hk, L, d = ATTN_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        rng = np.random.default_rng(33)
        q, k, v, do = (torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=device).to(dtype)
            for shape in ((B, hq, L, d), (B, hk, L, d), (B, hk, L, d),
                          (B, hq, L, d)))
        for layout, causal, order in (("zigzag", True, "zigzag"),
                                      ("full", False, "contiguous")):
            for key, (level, mesh) in meshes.items():
                plan = reduce_plan(mesh)
                want = ring_bwd_launches(plan.width, layout == "zigzag")
                rtol, atol = ring_bwd_tol(torch, dtype, want["fa_bwd_dq"])
                i, n = plan.shard_index(), B // plan.width
                mine = [x[i * n:(i + 1) * n] for x in (q, k, v, do)]
                leaves = [x.clone().requires_grad_(True) for x in mine[:3]]
                chip = torch.autograd.grad(ops.flash_attention(
                    *leaves, causal=causal), leaves, mine[3])
                reset()
                sync()
                t0 = time.perf_counter()
                with use_level(level, mesh), sharded_rows(plan):
                    got = torch.autograd.grad(ring_attention(
                        *leaves, causal=causal, order=order), leaves,
                        mine[3])
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                got_n = counts()
                what = f"(l1) ring backward {layout} {dname} on {key}"
                errs = []
                for name, g, w in zip(("dq", "dk", "dv"), got, chip):
                    scale = max(1.0, float(w.float().abs().max()))
                    torch.testing.assert_close(
                        g.float(), w.float(), rtol=rtol, atol=atol * scale,
                        msg=lambda m: f"{what}: {name}: {m}")
                    errs.append(float((g.float() - w.float()).abs().max()))
                have = {k_: got_n[k_] for k_ in want}
                if on_card and have != want:
                    raise AssertionError(f"{what}: launches {have}, "
                                         f"reckoned {want}")
                out["rows"].append(("l1", f"{layout} {dname} {key}",
                                    max(errs), ms, have))
    del q, k, v, do, leaves, chip, got
    cfg = get_config(ARCH)
    out["holds"] = hold_ring_backward_kernels(
        torch, device, cfg, reduce_plan(meshes["O3"][1]).width)
    out["seconds"]["l1"] = time.perf_counter() - t

    # -- (l2) qwen3-1.7b at full width, Trainer(mesh=...) at O3 ---------------
    t = time.perf_counter()
    level, mesh = meshes["O3"]
    plan = reduce_plan(mesh)
    card = torch.cuda.get_device_properties(0).total_memory if on_card \
        else 80e9
    fit, layers = mesh_train_layers(cfg, card)
    cfgn = dataclasses.replace(cfg, num_layers=layers)
    data = learnable_data(MESH_TRAIN_BATCH, MESH_TRAIN_SEQ)
    res = {"fit_layers": fit, "layers": layers}
    # each step traced: the collectives' spans give their bytes and host
    # seconds (collective_tally)
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with use_level(level, mesh):
            trainer = Trainer(cfgn, mesh=mesh, lr=TRAIN_LR,
                              total_steps=MESH_TRAIN_STEPS, device=device)
            res["moment_bytes"] = sum(
                x.numel() * x.element_size() for x in tree_leaves(
                    (trainer.state.opt_state.mu, trainer.state.opt_state.nu)))
            res["param_count"] = sum(x.numel() for x in
                                     tree_leaves(trainer.state.params))
            losses, steps_s, digests, tallies = [], [], [], []
            reset()
            for i in range(MESH_TRAIN_STEPS):
                sync()
                TRACER.clear()
                TRACER.enable()
                t0 = time.perf_counter()
                h = trainer.fit(data, i + 1, log_every=1)["history"]
                sync()
                steps_s.append(time.perf_counter() - t0)
                TRACER.disable()
                tallies.append(collective_tally(TRACER))
                losses.append(h[-1]["loss"])
                digests.append(bits_digest(torch, trainer.state.params))
            res["launches"] = counts()
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card \
            else 0.0
    finally:
        TRACER.disable()
        TRACER.clear()
    res["losses"], res["step_s"], res["collectives"] = losses, steps_s, \
        tallies
    out["digests"]["l2 params by step"] = str(digests)
    # the launches reckoned from the code: per step and layer the zig-zag
    # ring forward twice (remat) and its backward once
    per = ring_bwd_launches(plan.width, True)
    want = {k_: MESH_TRAIN_STEPS * layers * n * (2 if k_ in (
        "tiles_state", "flash_attention") else 1) for k_, n in per.items()}
    have = {k_: res["launches"][k_] for k_ in want}
    if on_card and have != want:
        raise AssertionError(f"(l2) launches over {MESH_TRAIN_STEPS} steps "
                             f"{have}, reckoned {want}")
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:                       # the O2 Trainer, same depth and data
        o2 = Trainer(cfgn, lr=TRAIN_LR, total_steps=MESH_TRAIN_STEPS,
                     device=device)
        res["o2_moment_bytes"] = sum(
            x.numel() * x.element_size() for x in tree_leaves(
                (o2.state.opt_state.mu, o2.state.opt_state.nu)))
        res["o2_losses"], res["o2_step_s"] = [], []
        for i in range(MESH_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            h = o2.fit(data, i + 1, log_every=1)["history"]
            sync()
            res["o2_step_s"].append(time.perf_counter() - t0)
            res["o2_losses"].append(h[-1]["loss"])
        del o2
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        diffs = [abs(a - b) for a, b in zip(res["losses"],
                                            res["o2_losses"])]
        res["max_loss_diff"] = max(diffs)
        if not all(np.isfinite(res["losses"])) or \
                not res["losses"][-1] < res["losses"][0] or \
                res["max_loss_diff"] > MESH_BF16_LOSS_TOL:
            raise AssertionError(f"(l2) bf16 losses {res['losses']}, O2's "
                                 f"{res['o2_losses']}")
        if res["moment_bytes"] * plan.width != res["o2_moment_bytes"]:
            raise AssertionError(f"(l2) moment bytes a rank "
                                 f"{res['moment_bytes']}, O2's "
                                 f"{res['o2_moment_bytes']}")
    dist.barrier()

    # f32 at 2 layers: the gradients, then the losses of MESH_CHECK_STEPS
    # steps (which (l3) reuses as its uninterrupted run)
    cfg32 = dataclasses.replace(cfg, num_layers=MESH_CHECK_LAYERS,
                                dtype="float32", param_dtype="float32")
    lm32 = LM(cfg32)
    data32 = learnable_data(MESH_TRAIN_BATCH, MESH_CHECK_SEQ)
    params = lm32.init(0, device=device)
    batch = data32.batch(0)
    with use_level(level, mesh), sharded_rows(plan):
        _, g = value_and_grad(mesh_loss(lm32.loss, plan), params,
                              shard_batch(mesh, batch))
    g = tree_map(plan.psum_all, g)
    if rank == 0:
        _, g2 = value_and_grad(lm32.loss, params, {
            k_: torch.as_tensor(v_, device=device) for k_, v_ in
            batch.items()})
        rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(tree_leaves(g), tree_leaves(g2))]
        res["grad_rel"] = max(rel)
        if res["grad_rel"] > MESH_GRAD_REL_TOL:
            raise AssertionError(f"(l2) f32 gradients: max |mesh - O2| / "
                                 f"max |O2| {res['grad_rel']}")
        del g2
    del g, params

    def run32(**kw):
        with use_level(level, mesh):
            tr = Trainer(cfg32, mesh=mesh, lr=TRAIN_LR,
                         total_steps=MESH_CHECK_STEPS, device=device, **kw)
            return tr, tr.fit(data32, MESH_CHECK_STEPS,
                              log_every=1)["history"]
    tr, hist = run32()
    res["f32_losses"] = [h["loss"] for h in hist]
    ref_digest = bits_digest(torch, tr.state.params)
    del tr
    if rank == 0:
        o2 = Trainer(cfg32, lr=TRAIN_LR, total_steps=MESH_CHECK_STEPS,
                     device=device)
        res["f32_o2_losses"] = [h["loss"] for h in o2.fit(
            data32, MESH_CHECK_STEPS, log_every=1)["history"]]
        del o2
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["f32_losses"],
                                                      res["f32_o2_losses"]))
        res["f32_loss_rel"] = rel
        if rel > MESH_F32_LOSS_RTOL:
            raise AssertionError(f"(l2) f32 losses {res['f32_losses']}, "
                                 f"O2's {res['f32_o2_losses']}")
    out["l2"] = res
    out["seconds"]["l2"] = time.perf_counter() - t

    # -- (l3) save, crash, resume at mesh scope; the elastic shrink -----------
    t = time.perf_counter()
    ck = os.path.join(tmp, "ckpt")

    class Crashing:
        """data32, failing at MESH_CRASH_AT."""

        def batch(self, i):
            if i == MESH_CRASH_AT:
                raise RuntimeError(f"injected failure at step {i}")
            return data32.batch(i)

    with use_level(level, mesh):
        tr = Trainer(cfg32, mesh=mesh, lr=TRAIN_LR,
                     total_steps=MESH_CHECK_STEPS, device=device,
                     ckpt_dir=ck, save_every=MESH_SAVE_AT)
        try:
            tr.fit(Crashing(), MESH_CHECK_STEPS, log_every=1)
            raise AssertionError("(l3) the injected failure did not fire")
        except RuntimeError as exc:
            if "injected failure" not in str(exc):
                raise
    del tr
    tr, hist = run32(ckpt_dir=ck)
    l3 = {"resumed_at": hist[0]["step"] - 1,
          "bitwise": bits_digest(torch, tr.state.params) == ref_digest}
    del tr
    if l3["resumed_at"] != MESH_SAVE_AT or not l3["bitwise"]:
        raise AssertionError(f"(l3) resumed at {l3['resumed_at']}, bitwise "
                             f"equal to the uninterrupted run: "
                             f"{l3['bitwise']}")
    if rank == 0:                       # the elastic shrink: one rank, O2
        shrink = replan(1, model=1, global_batch=MESH_TRAIN_BATCH,
                        per_replica_batch=1)
        el = Trainer(cfg32, lr=TRAIN_LR, total_steps=MESH_CHECK_STEPS,
                     device=device, microbatches=shrink.microbatches)
        # the mesh run's checkpoint of MESH_SAVE_AT (the resumed run wrote
        # a later one beside it), restored whole as Trainer restores
        el.state = Checkpointer(ck).restore(el.state, step=MESH_SAVE_AT)
        l3["elastic_microbatches"] = shrink.microbatches
        l3["elastic_losses"] = [h["loss"] for h in el.fit(
            data32, MESH_CHECK_STEPS, log_every=1)["history"]]
        del el
        want = res["f32_losses"][MESH_SAVE_AT:]
        l3["elastic_diff"] = max(abs(a - b) for a, b in
                                 zip(l3["elastic_losses"], want))
        if len(l3["elastic_losses"]) != len(want) or \
                l3["elastic_diff"] > MESH_ELASTIC_TOL:
            raise AssertionError(f"(l3) elastic shrink: losses "
                                 f"{l3['elastic_losses']}, the uninterrupted "
                                 f"run's {want}")
        shutil.rmtree(ck)
    dist.barrier()
    out["l3"] = l3
    out["seconds"]["l3"] = time.perf_counter() - t

    # -- (l4) compressed_psum over pod at O4 ----------------------------------
    t = time.perf_counter()
    level, mesh = meshes["O4"]

    def x_of(r):
        g_ = torch.Generator(device=device).manual_seed(100 + r)
        return torch.rand(COMPRESS_N, generator=g_, device=device) * 2 - 1
    with use_level(level, mesh):
        got = compressed_psum(x_of(rank), "pod")
    data_w = world // 2                  # (pod 2, data 2): pod-major ranks
    peers = [p * data_w + rank % data_w for p in range(2)]
    xs = [x_of(r) for r in peers]
    exact = sum(xs)
    scale = max(float(x.abs().max()) for x in xs) / 127.0
    err = float((got - exact).abs().max())
    bound = len(peers) * scale
    if not err <= bound:
        raise AssertionError(f"(l4) compressed_psum over pod: max |got - "
                             f"exact| {err} above {bound}")
    out["l4"] = {"err": err, "bound": bound, "peers": peers}
    out["seconds"]["l4"] = time.perf_counter() - t
    return out


#: Seconds phase 2l may take on a rank.
MESH_TRAIN_TIMEOUT_S = 300


def train_path_results(ranks: list) -> dict:
    """Phase 2l's results: :func:`mesh_train_rank` 's on every rank; every
    rank's digests (the parameters after each step of (l2)) the same, the
    main path's launches summed over the ranks."""
    out = {"rank0": ranks[0]}
    for r, res in enumerate(ranks[1:], 1):
        if res["digests"] != ranks[0]["digests"]:
            raise AssertionError(f"phase 2l: rank {r} holds other parameter "
                                 f"bits than rank 0 after (l2)'s steps")
    out["launches"] = {
        "flash_attention": sum(r["l2"]["launches"]["flash_attention"]
                               for r in ranks),
        "flash_attention_tiles": sum(r["l2"]["launches"]["tiles_state"]
                                     for r in ranks),
        **{k: sum(r["l2"]["launches"][k] for r in ranks)
           for k in BWD_KERNELS}}
    out["ranks"] = [{"step_s": r["l2"]["step_s"], "peak_gb":
                     r["l2"]["peak_gb"], "collectives":
                     r["l2"]["collectives"]} for r in ranks]
    out["setup_s"] = max(r["setup_s"] for r in ranks)
    out["seconds"] = {k: max(r["seconds"][k] for r in ranks)
                      for k in ranks[0]["seconds"]}
    return out


def report_train_mesh_path(mt: dict, card: str) -> None:
    """Log phase 2l's rows and checks (:func:`train_path_results`)."""
    r0 = mt["rank0"]
    for _, label, err, ms, n in r0["rows"]:
        log(f"  (l1) ring backward {label}: max |ring - chip| of dq, dk, dv "
            f"{err:.3g}, {ms:.2f} ms forward and backward on rank 0, "
            f"launches a rank {n} (as reckoned)")
    for what, err in r0["holds"]:
        log(f"  {what}: backward kernels against the plain backward, max "
            f"|diff| / max |plain| {err:.3g}")
    l2, l3, l4 = r0["l2"], r0["l3"], r0["l4"]
    W = MESH_RANKS
    n = l2["param_count"]
    log(f"  (l2) {ARCH} at full width, {l2['layers']} of 28 layers (the "
        f"mesh-aware count fits {l2['fit_layers']} on {card} at data width "
        f"{W} with {W} ranks on the card; capped at {MESH_TRAIN_MAX_LAYERS}"
        f"), {n} parameters, Trainer(mesh=make_mesh(data={W})) at O3, "
        f"{MESH_TRAIN_STEPS} steps of {MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ} "
        f"tokens: losses {l2['losses']} against O2's {l2['o2_losses']} (max "
        f"|diff| {l2['max_loss_diff']:.4g}, bar {MESH_BF16_LOSS_TOL}); "
        f"moments {l2['moment_bytes'] / 1e9:.3f} GB a rank against O2's "
        f"{l2['o2_moment_bytes'] / 1e9:.3f}; every rank the same parameter "
        f"bits after each step")
    for r, rk in enumerate(mt["ranks"]):
        later = rk["collectives"][1:]
        coll_s = sum(sum(c["seconds"].values()) for c in later)
        stage_s = sum(c["stage_s"] for c in later)
        step_s = sum(rk["step_s"][1:])
        log(f"  (l2) rank {r}: step seconds "
            f"{[round(x, 3) for x in rk['step_s']]} (O2 on rank 0 "
            f"{[round(x, 3) for x in l2['o2_step_s']]}), peak "
            f"{rk['peak_gb']:.2f} GB; collective bytes a step "
            + ", ".join(f"{k} {v}" for k, v in later[0]["bytes"].items())
            + f"; host-staged collectives (their spans) {coll_s:.2f} s of "
            f"steps 2-{len(rk['step_s'])}'s {step_s:.2f} s "
            f"({coll_s / max(step_s, 1e-9):.3f}), of which staging copies "
            f"{stage_s:.2f} s (with the wait for kernels queued before "
            f"them); by kind "
            + ", ".join(f"{k} {sum(c['seconds'][k] for c in later):.2f} s"
                        for k in later[0]["seconds"]))
    c0 = mt["ranks"][0]["collectives"][1]["bytes"]
    log(f"  (l2) the plan's ZeRO-1 bytes a rank a step: reduce-scatter "
        f"{2 * n} (each bf16 gradient whole), all-gather {2 * n // W} (its "
        f"bf16 tile); measured {c0.get('reduce_scatter', 0)} and "
        f"{c0.get('all_gather', 0)}")
    log(f"  (l2) f32 at {MESH_CHECK_LAYERS} layers: gradients max |mesh - "
        f"O2| / max |O2| {l2['grad_rel']:.3g} (bar {MESH_GRAD_REL_TOL}); "
        f"losses {l2['f32_losses']} against O2's {l2['f32_o2_losses']} (max "
        f"relative {l2['f32_loss_rel']:.3g}, bar {MESH_F32_LOSS_RTOL})")
    log(f"  (l3) f32 at {MESH_CHECK_LAYERS} layers on (data {W}): saved at "
        f"{MESH_SAVE_AT}, crashed fetching step {MESH_CRASH_AT + 1}, "
        f"resumed at "
        f"{l3['resumed_at']}: parameters bitwise equal to the uninterrupted "
        f"run on every rank; restored at O2 on one rank with "
        f"{l3['elastic_microbatches']} microbatches (replan): losses "
        f"{l3['elastic_losses']}, max |diff| {l3['elastic_diff']:.3g} (bar "
        f"{MESH_ELASTIC_TOL})")
    log(f"  (l4) compressed_psum over pod at O4, {COMPRESS_N} elements a "
        f"rank: max |got - exact| {l4['err']:.4g}, bound {l4['bound']:.4g} "
        f"(one int8 step a participant)")
    log(f"  seconds by step (slowest rank) " + ", ".join(
        f"{k} {v:.1f}" for k, v in mt["seconds"].items())
        + f"; a rank's set-up {mt['setup_s']:.2f} s")


# -- phase 2m: the model axis's compute split --------------------------------

#: (m1): the blocks' rows, B x L of ATTN_SHAPE; the bf16 bar is phase 2l's
#: ring bar with one piece a model rank (each rank's partial product is
#: rounded to bf16 once before the all-reduce adds them).
MA_BLOCK_MESHES = (("data2 model2", 2, 2), ("model4", 1, 4))
#: (m2): qwen3-1.7b at full width cut to MA_TRAIN_LAYERS layers through
#: Trainer(mesh=make_mesh(data=2, model=2)) at O3, MA_TRAIN_STEPS steps of
#: MA_TRAIN_BATCH x MA_TRAIN_SEQ tokens; its f32 checks at
#: MESH_CHECK_LAYERS layers on MA_TRAIN_BATCH x MA_CHECK_SEQ tokens.
MA_TRAIN_LAYERS, MA_TRAIN_STEPS = 4, 3
MA_TRAIN_BATCH, MA_TRAIN_SEQ, MA_CHECK_SEQ = 4, 1024, 512
#: (m3): qwen3-moe-30b-a3b at full width cut to MA_MOE_LAYERS layers, one
#: step of MA_TRAIN_BATCH x MA_MOE_SEQ tokens; aux_lb within MA_AUX_TOL of
#: O2's.
MA_MOE_LAYERS, MA_MOE_SEQ, MA_AUX_TOL = 2, 512, 1e-3
#: (m4): qwen3-1.7b whole through the Engine at O3 on (model 4): FIXED_BATCH
#: prompts of FIXED_PROMPT tokens, FIXED_NEW new, greedy.
MA_ENGINE_MODEL = 4
#: Seconds phase 2m may take on a rank.
MODEL_AXIS_TIMEOUT_S = 300


def model_axis_tol(torch, dtype, pieces: int) -> tuple[float, float]:
    """(m1)'s bars, relative and (times the O2 tensor's largest entry, at
    least 1) absolute: f32, :func:`bwd_tol` (the JAX suites' 1e-5); bf16,
    :func:`ring_bwd_tol` with ``pieces`` partial products."""
    if dtype == torch.float32:
        return bwd_tol(torch, dtype)
    return ring_bwd_tol(torch, dtype, pieces)


def model_axis_block_bytes(block: str, rows: int, L: int, cfg, elem: int
                           ) -> int:
    """The all-reduce bytes a rank of (m1)'s forward and backward of one
    block, reckoned from ``distributed/model_split.py``'s pairs: the row
    product's ``out_of`` and the input's ``into`` (rows x L x d each); the
    attention block adds the lane floor's replicated ``wk`` and ``wv``
    (d x kv heads x hd each) and qk_norm's two scales (hd each), whose
    gradients ``into`` sums."""
    act = 2 * rows * L * cfg.d_model
    if block == "attn":
        act += 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim \
            + 2 * cfg.head_dim
    return act * elem


def hold_local_head_kernels(torch, device: str, cfg, model: int) -> list:
    """Kernels 8-10 against their plain versions at the local heads of a
    model axis of ``model`` ranks (qwen3-1.7b's 16/8 heads: 4/2 at 4):
    the tiles kernel at (m4)'s prefill shape (FIXED_BATCH x FIXED_PROMPT,
    causal), the lens kernel at its decode (one query a row against
    FIXED_PROMPT + FIXED_NEW cache slots, kv_len FIXED_PROMPT + 1), and the
    dense grid at the same prefill shape, full; in bf16, each at
    :func:`attn_tol`.  Returns (what, max |kernel - plain|) rows; none on
    host tensors (a rehearsal)."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.sparse.maskcompiler import causal_layout

    if device != "cuda":
        return []
    dtype = torch.bfloat16
    rtol, atol = attn_tol(torch, dtype)
    hq, hk, d = cfg.num_heads // model, cfg.num_kv_heads // model, \
        cfg.head_dim
    B, L, S = FIXED_BATCH, FIXED_PROMPT, FIXED_PROMPT + FIXED_NEW
    rng = np.random.default_rng(43)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=device).to(dtype)

    rows = []
    q, k, v = randn(B, hq, L, d), randn(B, hk, L, d), randn(B, hk, L, d)
    layout = causal_layout(L, L, 128, 128)
    cases = [(f"tiles {hq}/{hk} heads {L}x{L} causal",
              fa_k.flash_attention_tiles(q, k, v, layout),
              fa_k.flash_attention_tiles_plain(q, k, v, layout)),
             (f"dense grid {hq}/{hk} heads {L}x{L} full",
              fa_k.flash_attention(q, k, v, causal=False),
              fa_k.flash_attention_plain(q, k, v, causal=False))]
    q1, kc, vc = randn(B, hq, 1, d), randn(B, hk, S, d), randn(B, hk, S, d)
    kv_len = torch.full((B,), L + 1, dtype=torch.int32, device=device)
    cases.append((f"lens {hq}/{hk} heads 1x{S} kv_len {L + 1}",
                  fa_k.flash_attention_lens(q1, kc, vc, kv_len=kv_len),
                  fa_k.flash_attention_plain(q1, kc, vc, causal=False,
                                             kv_len=kv_len)))
    torch.cuda.synchronize()
    for what, got, want in cases:
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol,
                                   msg=lambda m: f"(m1) {what}: {m}")
        rows.append((what, float((got.float() - want.float()).abs().max())))
    return rows


def model_axis_rank(rank: int, world: int, device: str, tmp: str) -> dict:
    """One rank of phase 2m.  (m1) qwen3-1.7b's MLP and attention blocks
    at full width, bf16 and f32, forward and backward, split over
    (data 2, model 2) at O3 (the data ring at 8/4 heads) and over (model
    4) (the chip kernels at 4/2 heads), against the O2 block on this
    rank's rows: outputs and every gradient, the all-reduce bytes against
    :func:`model_axis_block_bytes`, the attention launches against the
    count at the local heads; kernels 8-13 against their plain versions at
    the local heads.  (m2) qwen3-1.7b at MA_TRAIN_LAYERS layers through
    ``Trainer(mesh=make_mesh(data=2, model=2))`` at O3, step by step (the
    parameter bits digested, the collectives' spans read), against the O2
    Trainer on rank 0; in f32 at MESH_CHECK_LAYERS layers the gradients and
    MA_TRAIN_STEPS losses.  (m3) qwen3-moe-30b-a3b at MA_MOE_LAYERS layers,
    64 experts a rank, one step and its loss and aux_lb against O2 on rank
    0 (O2's dispatch groups the mesh's data shards, as the reference's
    under its mesh).  (m4) qwen3-1.7b whole through the Engine at O3 on
    (model 4) in bf16, and at MESH_CHECK_LAYERS layers in f32, against the
    O2 Engine on rank 0.
    Returns the rows, the launches and the digests."""
    import torch

    t_start = time.perf_counter()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        gc.collect()
        torch.cuda.empty_cache()
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import ExecLevel, use_level
    from repro_torch.distributed import model_split as ms
    from repro_torch.distributed.collectives import reduce_plan
    from repro_torch.distributed.partition import model_dims, param_specs
    from repro_torch.distributed.sharding import sharded_rows
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer, rank_param_count
    from repro_torch.models.attention import attention_apply, attention_init
    from repro_torch.models.layers import mlp, mlp_init
    from repro_torch.models.lm import LM
    from repro_torch.obs.trace import TRACER
    from repro_torch.serve import Engine, SamplingParams
    from repro_torch.train.step import (model_shard, mesh_loss,
                                        shard_batch, value_and_grad)
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    wrappers = {"flash_attention": fa_k.flash_attention,
                "flash_attention_lens": fa_k.flash_attention_lens,
                "flash_attention_tiles": fa_k.flash_attention_tiles}
    bwd = {k: getattr(fa_k, k) for k in BWD_KERNELS}

    def reset():
        reset_attention_counts(wrappers)
        for w in bwd.values():
            w.launches = 0

    def counts():
        n = read_attention_counts(wrappers)
        n.update({k: w.launches for k, w in bwd.items()})
        return n

    O3 = ExecLevel.O3
    meshes = {key: make_mesh(data=dw, model=mw, device_type=device)
              for key, dw, mw in MA_BLOCK_MESHES}
    out = {"rows": [], "holds": [], "digests": {}, "seconds": {},
           "setup_s": time.perf_counter() - t_start}
    cfg = get_config(ARCH)

    # -- (m1) the blocks ---------------------------------------------------
    t = time.perf_counter()
    B, _, _, L, d = ATTN_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        cfgd = dataclasses.replace(cfg, dtype=dname, param_dtype=dname)
        gen = torch.Generator(device=device).manual_seed(41)
        blocks = {"attn": attention_init(gen, cfgd),
                  "mlp": mlp_init(gen, cfgd.d_model, cfgd.d_ff, dtype)}
        mdims = model_dims(param_specs({"layers": [blocks]}))["layers"][0]
        rng = np.random.default_rng(47)
        x, dy = (torch.as_tensor(rng.standard_normal(
            (B, L, cfgd.d_model)).astype(np.float32), device=device).to(
                dtype) for _ in range(2))
        for key, mesh in meshes.items():
            plan = reduce_plan(mesh)
            split = ms.split_of(mesh, held=True)
            n = B // plan.width
            i = plan.shard_index() if plan.width > 1 else 0
            rows, drows = x[i * n:(i + 1) * n], dy[i * n:(i + 1) * n]
            cos, sin = LM(cfgd)._rope_tables(n, L, device)
            fns = {"mlp": lambda h, p: mlp(h, p, cfgd.mlp_kind),
                   "attn": lambda h, p: attention_apply(h, p, cfgd, cos,
                                                        sin)}
            for block in ("mlp", "attn"):
                whole = blocks[block]
                names = [p_ for p_, _ in tree_paths(whole)]
                mds = []                # each leaf's model-split dim
                tree_map(lambda x_, m_: mds.append(m_), whole,
                         mdims[block])

                def leaves_of(params):
                    """(x, the leaves) as fresh autograd leaves, and the
                    block's parameters over them."""
                    got = [rows.clone().requires_grad_(True)] + [
                        x_.detach().requires_grad_(True)
                        for x_ in tree_leaves(params)]
                    it = iter(got[1:])
                    return got, tree_map(lambda _: next(it), params)
                o2_in, o2_p = leaves_of(whole)
                y2 = fns[block](o2_in[0], o2_p)
                want = [y2.detach()] + list(torch.autograd.grad(
                    y2, o2_in, drows))
                mine, mine_p = leaves_of(tree_map(
                    lambda p_, m_: model_shard(p_, m_, split), whole,
                    mdims[block]))
                reset()
                sync()
                TRACER.clear()
                TRACER.enable()
                t0 = time.perf_counter()
                try:
                    with use_level(O3, mesh), sharded_rows(plan), \
                            ms.splitting(split):
                        y = fns[block](mine[0], mine_p)
                        grads = torch.autograd.grad(y, mine, drows)
                    sync()
                    ms_ = (time.perf_counter() - t0) * 1e3
                finally:
                    TRACER.disable()
                tally = collective_tally(TRACER)
                TRACER.clear()
                have_n = counts()
                got = [y.detach(), grads[0]] + [
                    g if m_ is None else split.all_gather(g, m_)
                    for m_, g in zip(mds, grads[1:])]
                what = f"(m1) {block} {dname} on {key}"
                rtol, atol = model_axis_tol(torch, dtype, split.size)
                errs = []
                for name, g, w in zip(["y", "dx"] + names, got, want):
                    scale = max(1.0, float(w.float().abs().max()))
                    torch.testing.assert_close(
                        g.float(), w.float(), rtol=rtol, atol=atol * scale,
                        msg=lambda m_: f"{what}: {name}: {m_}")
                    errs.append(float((g.float() - w.float()).abs().max())
                                / scale)
                elem = torch.empty((), dtype=dtype).element_size()
                reckoned = model_axis_block_bytes(block, n, L, cfgd, elem)
                ar = tally["bytes"].get("all_reduce", 0)
                if ar != reckoned:
                    raise AssertionError(f"{what}: all-reduce bytes {ar}, "
                                         f"reckoned {reckoned}")
                if block == "attn":
                    W = plan.width
                    # one data rank: the chip's causal tiles walk, its
                    # forward the state variant (the backward reads lse)
                    want_n = ring_bwd_launches(W, True) if W > 1 else {
                        "tiles_state": 1, "fa_bwd_delta": 1,
                        "fa_bwd_dkdv": 1, "fa_bwd_dq": 1}
                    have = {k_: have_n[k_] for k_ in want_n}
                    if on_card and have != want_n:
                        raise AssertionError(f"{what}: launches {have}, "
                                             f"reckoned {want_n}")
                else:
                    have = {}
                out["rows"].append(("m1", f"{block} {dname} {key}",
                                    max(errs), ms_, tally["bytes"], have))
        del blocks, x, dy
    local = dataclasses.replace(cfg, num_heads=cfg.num_heads // 2,
                                num_kv_heads=cfg.num_kv_heads // 2)
    out["holds"] = hold_local_head_kernels(torch, device, cfg,
                                           MA_ENGINE_MODEL) \
        + hold_ring_backward_kernels(torch, device, local, 2,
                                     seq=MA_TRAIN_SEQ, batch=MA_TRAIN_BATCH)
    free()
    out["seconds"]["m1"] = time.perf_counter() - t

    # -- (m2) qwen3-1.7b, Trainer(mesh=make_mesh(data=2, model=2)) at O3 ----
    t = time.perf_counter()
    mesh = meshes["data2 model2"]
    plan = reduce_plan(mesh)
    split = ms.split_of(mesh, held=True)
    cfgn = dataclasses.replace(cfg, num_layers=MA_TRAIN_LAYERS)
    data = learnable_data(MA_TRAIN_BATCH, MA_TRAIN_SEQ)
    res = {"layers": MA_TRAIN_LAYERS,
           "reckoned_param_bytes": 2 * rank_param_count(cfgn, split.size),
           "o2_param_bytes": 2 * sum(x.numel() for x in tree_leaves(
               LM(cfgn).init(device="meta")))}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        with use_level(O3, mesh):
            trainer = Trainer(cfgn, mesh=mesh, lr=TRAIN_LR,
                              total_steps=MA_TRAIN_STEPS, device=device)
            res["param_bytes"] = sum(x.numel() * x.element_size() for x in
                                     tree_leaves(trainer.state.params))
            res["moment_bytes"] = sum(
                x.numel() * x.element_size() for x in tree_leaves(
                    (trainer.state.opt_state.mu, trainer.state.opt_state.nu)))
            losses, steps_s, digests, tallies = [], [], [], []
            reset()
            for i in range(MA_TRAIN_STEPS):
                sync()
                TRACER.clear()
                TRACER.enable()
                t0 = time.perf_counter()
                h = trainer.fit(data, i + 1, log_every=1)["history"]
                sync()
                steps_s.append(time.perf_counter() - t0)
                TRACER.disable()
                tallies.append(collective_tally(TRACER))
                losses.append(h[-1]["loss"])
                digests.append(bits_digest(torch, trainer.state.params))
            res["launches"] = counts()
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card \
            else 0.0
    finally:
        TRACER.disable()
        TRACER.clear()
    res["losses"], res["step_s"], res["collectives"] = losses, steps_s, \
        tallies
    res["model_index"] = split.index
    out["digests"]["m2 params by step"] = str(digests)
    per = ring_bwd_launches(plan.width, True)
    want = {k_: MA_TRAIN_STEPS * MA_TRAIN_LAYERS * n_ * (2 if k_ in (
        "tiles_state", "flash_attention") else 1) for k_, n_ in per.items()}
    have = {k_: res["launches"][k_] for k_ in want}
    if on_card and have != want:
        raise AssertionError(f"(m2) launches over {MA_TRAIN_STEPS} steps "
                             f"{have}, reckoned {want}")
    if res["param_bytes"] != res["reckoned_param_bytes"]:
        raise AssertionError(f"(m2) parameter bytes a rank "
                             f"{res['param_bytes']}, reckoned from the specs "
                             f"{res['reckoned_param_bytes']}")
    del trainer
    free()
    dist.barrier()
    if rank == 0:                       # the O2 Trainer, same depth and data
        o2 = Trainer(cfgn, lr=TRAIN_LR, total_steps=MA_TRAIN_STEPS,
                     device=device)
        res["o2_moment_bytes"] = sum(
            x.numel() * x.element_size() for x in tree_leaves(
                (o2.state.opt_state.mu, o2.state.opt_state.nu)))
        res["o2_losses"], res["o2_step_s"] = [], []
        for i in range(MA_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            h = o2.fit(data, i + 1, log_every=1)["history"]
            sync()
            res["o2_step_s"].append(time.perf_counter() - t0)
            res["o2_losses"].append(h[-1]["loss"])
        del o2
        free()
        res["max_loss_diff"] = max(abs(a - b) for a, b in
                                   zip(res["losses"], res["o2_losses"]))
        if not all(np.isfinite(res["losses"])) or \
                not res["losses"][-1] < res["losses"][0] or \
                res["max_loss_diff"] > MESH_BF16_LOSS_TOL:
            raise AssertionError(f"(m2) bf16 losses {res['losses']}, O2's "
                                 f"{res['o2_losses']}")
    dist.barrier()

    # f32 at 2 layers: the gradients gathered whole, then the losses of
    # MA_TRAIN_STEPS steps
    cfg32 = dataclasses.replace(cfg, num_layers=MESH_CHECK_LAYERS,
                                dtype="float32", param_dtype="float32")
    lm32 = LM(cfg32)
    data32 = learnable_data(MA_TRAIN_BATCH, MA_CHECK_SEQ)
    params = lm32.init(0, device=device)
    batch = data32.batch(0)
    mdims = model_dims(param_specs(params))
    shards = tree_map(lambda p, m: model_shard(p, m, split), params, mdims)
    with use_level(O3, mesh), sharded_rows(plan), ms.splitting(split):
        _, g = value_and_grad(mesh_loss(lm32.loss, plan), shards,
                              shard_batch(mesh, batch))
    g = tree_map(lambda x, m: x if m is None else split.all_gather(x, m),
                 tree_map(plan.psum_all, g), mdims)
    del shards
    if rank == 0:
        _, g2 = value_and_grad(lm32.loss, params, {
            k_: torch.as_tensor(v_, device=device) for k_, v_ in
            batch.items()})
        rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(tree_leaves(g), tree_leaves(g2))]
        res["grad_rel"] = max(rel)
        if res["grad_rel"] > MESH_GRAD_REL_TOL:
            raise AssertionError(f"(m2) f32 gradients: max |mesh - O2| / "
                                 f"max |O2| {res['grad_rel']}")
        del g2
    del g, params
    with use_level(O3, mesh):
        tr = Trainer(cfg32, mesh=mesh, lr=TRAIN_LR,
                     total_steps=MA_TRAIN_STEPS, device=device)
        res["f32_losses"] = [h["loss"] for h in tr.fit(
            data32, MA_TRAIN_STEPS, log_every=1)["history"]]
    del tr
    if rank == 0:
        o2 = Trainer(cfg32, lr=TRAIN_LR, total_steps=MA_TRAIN_STEPS,
                     device=device)
        res["f32_o2_losses"] = [h["loss"] for h in o2.fit(
            data32, MA_TRAIN_STEPS, log_every=1)["history"]]
        del o2
        res["f32_loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
            res["f32_losses"], res["f32_o2_losses"]))
        if res["f32_loss_rel"] > MESH_F32_LOSS_RTOL:
            raise AssertionError(f"(m2) f32 losses {res['f32_losses']}, "
                                 f"O2's {res['f32_o2_losses']}")
    free()
    out["m2"] = res
    out["seconds"]["m2"] = time.perf_counter() - t

    # -- (m3) qwen3-moe-30b-a3b, 64 experts a rank ---------------------------
    t = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mcfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MA_MOE_LAYERS)
    mdata = learnable_data(MA_TRAIN_BATCH, MA_MOE_SEQ)
    mbatch = mdata.batch(0)
    m3 = {"experts_a_rank": mcfg.num_experts // split.size}
    mlm = LM(mcfg)
    with use_level(O3, mesh):
        tr = Trainer(mcfg, mesh=mesh, lr=TRAIN_LR, total_steps=1,
                     device=device)
        free()                  # the whole parameters each rank drew
        with sharded_rows(plan), ms.splitting(split), torch.no_grad():
            _, metrics = mesh_loss(mlm.loss, plan)(
                tr.state.params, shard_batch(mesh, mbatch))
        m3["aux_lb"] = float(plan.psum_all(
            metrics["aux_lb"].reshape(1))[0] / plan.width)
        reset()
        sync()
        t0 = time.perf_counter()
        m3["loss"] = tr.fit(mdata, 1, log_every=1)["history"][0]["loss"]
        sync()
        m3["step_s"] = time.perf_counter() - t0
        m3["launches"] = counts()
        m3["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if on_card else 0.0
    # the step's launches as (m2)'s, one step of MA_MOE_LAYERS layers
    want = {k_: MA_MOE_LAYERS * n_ * (2 if k_ in (
        "tiles_state", "flash_attention") else 1) for k_, n_ in per.items()}
    have = {k_: m3["launches"][k_] for k_ in want}
    if on_card and have != want:
        raise AssertionError(f"(m3) launches of the step {have}, reckoned "
                             f"{want}")
    del tr
    free()
    dist.barrier()
    if rank == 0:
        # O2 on the whole batch, its dispatch groups the mesh's data shards
        # (the reference's groups under its mesh: moe_apply's ``groups``)
        import functools

        from repro_torch.models import moe as moe_mod

        real = moe_mod.moe_apply
        moe_mod.moe_apply = functools.partial(real, groups=plan.width)
        try:
            with torch.no_grad():
                loss, metrics = mlm.loss(mlm.init(0, device=device), {
                    k_: torch.as_tensor(v_, device=device) for k_, v_ in
                    mbatch.items()})
        finally:
            moe_mod.moe_apply = real
        m3["o2_loss"], m3["o2_aux_lb"] = float(loss), \
            float(metrics["aux_lb"])
        del loss, metrics
        free()
        if not abs(m3["loss"] - m3["o2_loss"]) <= MESH_BF16_LOSS_TOL or \
                not abs(m3["aux_lb"] - m3["o2_aux_lb"]) <= MA_AUX_TOL:
            raise AssertionError(f"(m3) loss {m3['loss']} against O2's "
                                 f"{m3['o2_loss']}, aux_lb {m3['aux_lb']} "
                                 f"against {m3['o2_aux_lb']}")
    dist.barrier()
    out["m3"] = m3
    out["seconds"]["m3"] = time.perf_counter() - t

    # -- (m4) qwen3-1.7b whole through the Engine at O3 on (model 4) ---------
    # in bf16 (the serve path's dtype), and in f32 at MESH_CHECK_LAYERS
    # layers, where the split's other summation order moves the logits by
    # ulps of f32 instead of bf16 (2c's (b) at the same depth)
    t = time.perf_counter()
    mesh4 = meshes["model4"]
    prompts = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (FIXED_BATCH, FIXED_PROMPT)).astype(np.int32),
        device=device)
    greedy = SamplingParams(greedy=True)
    max_len = FIXED_PROMPT + FIXED_NEW
    m4 = {}
    for dname in ("bfloat16", "float32"):
        cfgd = dataclasses.replace(cfg, dtype=dname, param_dtype=dname)
        if dname == "float32":
            cfgd = dataclasses.replace(cfgd, num_layers=MESH_CHECK_LAYERS)
        lm = LM(cfgd)
        params = lm.init(0, device=device)
        with use_level(O3, mesh4):
            eng = Engine(lm, params, max_len=max_len, sampling=greedy)
        with use_level(O3, mesh4), ms.splitting(eng.split):
            logits, cache = lm.prefill(params, prompts, max_len=max_len)
            kv_heads = ms.heads(cfgd)[1]    # this rank's (4 / 2 at model 4)
        r = {"cache_bytes": sum(cache[k_].numel() * cache[k_].element_size()
                                for k_ in ("k", "v")),
             "model": eng.split.size, "kv_heads": kv_heads,
             "layers": cfgd.num_layers}
        del cache
        reset()
        sync()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=FIXED_NEW)
        sync()
        r["generate_s"] = time.perf_counter() - t0
        r["launches"] = counts()
        out["digests"][f"m4 tokens {dname}"] = str(
            toks.cpu().numpy().tolist())
        want_n = {"tiles": cfgd.num_layers, "lens_decode": 0,
                  "lens_prefix": 0}
        have = {k_: r["launches"][k_] for k_ in want_n}
        if on_card and have != want_n:
            raise AssertionError(f"(m4) {dname} launches a rank {have}, "
                                 f"reckoned {want_n} (one prefill at 4/2 "
                                 f"heads; decode attends by einsum)")
        dist.barrier()
        if rank == 0:
            o2 = Engine(lm, params, max_len=max_len, sampling=greedy)
            logits2, cache2 = lm.prefill(params, prompts, max_len=max_len)
            r["o2_cache_bytes"] = sum(cache2[k_].numel()
                                      * cache2[k_].element_size()
                                      for k_ in ("k", "v"))
            del cache2
            t0 = time.perf_counter()
            toks2 = o2.generate(prompts, max_new_tokens=FIXED_NEW)
            sync()
            r["o2_generate_s"] = time.perf_counter() - t0
            scale = float(logits2.float().abs().max())
            r["logit_diff"] = float((logits.float()
                                     - logits2.float()).abs().max())
            r["logit_scale"] = scale
            # (a)'s bound in bf16 (8 ulps of the scale), (a-f32)'s in f32
            bound = (8 * 2.0 ** -8 if dname == "bfloat16" else 1e-3) * scale
            if not r["logit_diff"] <= bound:
                raise AssertionError(f"(m4) {dname} prefill logits: max |O3"
                                     f" - O2| {r['logit_diff']} above "
                                     f"{bound}")
            r["token_agree"] = float((toks == toks2).float().mean())
            if not torch.equal(toks, toks2):
                # a differing token sits at a near-tie of the O2 run's
                # logits where the rows part: in f32 a top-2 margin of
                # 1e-3 or less (2c's (b)); in bf16 one within the bound the
                # two runs' logits differ by
                r["margins"] = first_split_margins(torch, lm, params,
                                                   prompts, toks, toks2)
                bar = bound if dname == "bfloat16" else 1e-3
                if max(r["margins"]) > bar:
                    raise AssertionError(f"(m4) {dname} tokens differ from "
                                         f"O2's at top-2 margins "
                                         f"{r['margins']}, above {bar}")
            if r["cache_bytes"] * cfg.num_kv_heads != \
                    r["o2_cache_bytes"] * kv_heads:
                raise AssertionError(f"(m4) KV cache a rank "
                                     f"{r['cache_bytes']} at {kv_heads} kv "
                                     f"heads, O2's {r['o2_cache_bytes']}")
            del o2
        del params, eng, logits
        free()
        dist.barrier()
        m4[dname] = r
    out["m4"] = m4
    out["seconds"]["m4"] = time.perf_counter() - t
    return out


def first_split_margins(torch, lm, params, prompts, toks, toks2) -> list:
    """For each row whose tokens differ from O2's: the O2 run's top-2
    logit margin at the first differing step, from a teacher-forced
    prefill of the prompt and O2's tokens before it."""
    out = []
    for r in range(toks.shape[0]):
        diff = (toks[r] != toks2[r]).nonzero()
        if not len(diff):
            continue
        j = int(diff[0])
        seq = torch.cat([prompts[r], toks2[r, :j]])[None]
        logits, _ = lm.prefill(params, seq)
        top = torch.topk(logits[0].float(), 2).values
        out.append(float(top[0] - top[1]))
    return out


def model_axis_results(ranks: list) -> dict:
    """Phase 2m's results: :func:`model_axis_rank` 's on every rank; the
    ranks at the same model coordinate the same parameter bits after each
    of (m2)'s steps, every rank the same (m4) tokens, the launches summed
    over the ranks."""
    out = {"rank0": ranks[0]}
    by_coord: dict = {}
    for r, res in enumerate(ranks):
        by_coord.setdefault(res["m2"]["model_index"], []).append(r)
        for key in ("m4 tokens bfloat16", "m4 tokens float32"):
            if res["digests"][key] != ranks[0]["digests"][key]:
                raise AssertionError(f"phase 2m: rank {r}'s {key} differ "
                                     f"from rank 0's")
    for coord, rs in by_coord.items():
        for r in rs[1:]:
            if ranks[r]["digests"]["m2 params by step"] != \
                    ranks[rs[0]]["digests"]["m2 params by step"]:
                raise AssertionError(f"phase 2m: ranks {rs[0]} and {r} (model "
                                     f"coordinate {coord}) hold other "
                                     f"parameter bits after (m2)'s steps")
    out["model_groups"] = by_coord
    m1 = [n for r in ranks for _, label, _, _, _, n in r["rows"]
          if label.startswith("attn")]
    trained = [r[m]["launches"] for r in ranks for m in ("m2", "m3")]
    out["launches"] = {
        "flash_attention": sum(n["flash_attention"] for n in trained)
        + sum(n.get("flash_attention", 0) for n in m1),
        "flash_attention_tiles": sum(n["tiles_state"] for n in trained)
        + sum(m4["launches"]["tiles"] for r in ranks
              for m4 in r["m4"].values())
        + sum(n.get("tiles_state", 0) + n.get("tiles", 0) for n in m1),
        **{k: sum(n[k] for n in trained) + sum(n.get(k, 0) for n in m1)
           for k in BWD_KERNELS}}
    out["ranks"] = [{"step_s": r["m2"]["step_s"], "peak_gb":
                     r["m2"]["peak_gb"], "collectives":
                     r["m2"]["collectives"]} for r in ranks]
    out["setup_s"] = max(r["setup_s"] for r in ranks)
    out["seconds"] = {k: max(r["seconds"][k] for r in ranks)
                      for k in ranks[0]["seconds"]}
    return out


def report_model_axis_path(ma: dict, card: str) -> None:
    """Log phase 2m's rows and checks (:func:`model_axis_results`)."""
    r0 = ma["rank0"]
    for _, label, err, ms_, nbytes, n in r0["rows"]:
        log(f"  (m1) {label}: max |split - O2| / max(1, max |O2|) over y, "
            f"dx and every gradient {err:.3g}, {ms_:.2f} ms forward and "
            f"backward on rank 0, collective bytes {nbytes} (all-reduce as "
            f"reckoned)" + (f", launches {n} (as reckoned)" if n else ""))
    for what, err in r0["holds"]:
        log(f"  (m1) {what}: against the plain version, max |diff| "
            f"{err:.3g}")
    m2, m3, m4 = r0["m2"], r0["m3"], r0["m4"]
    log(f"  (m2) {ARCH} at full width, {m2['layers']} layers, Trainer(mesh="
        f"make_mesh(data=2, model=2)) at O3, {MA_TRAIN_STEPS} steps of "
        f"{MA_TRAIN_BATCH} x {MA_TRAIN_SEQ} tokens: losses {m2['losses']} "
        f"against O2's {m2['o2_losses']} (max |diff| "
        f"{m2['max_loss_diff']:.4g}, bar {MESH_BF16_LOSS_TOL}); parameters "
        f"{m2['param_bytes'] / 1e9:.4f} GB a rank (reckoned "
        f"{m2['reckoned_param_bytes'] / 1e9:.4f}) against O2's "
        f"{m2['o2_param_bytes'] / 1e9:.4f}, moments "
        f"{m2['moment_bytes'] / 1e9:.4f} GB against "
        f"{m2['o2_moment_bytes'] / 1e9:.4f}; ranks "
        f"{ma['model_groups']} (by model coordinate) the same bits after "
        f"each step")
    for r, rk in enumerate(ma["ranks"]):
        later = rk["collectives"][1:]
        coll_s = sum(sum(c["seconds"].values()) for c in later)
        step_s = sum(rk["step_s"][1:])
        log(f"  (m2) rank {r}: step seconds "
            f"{[round(x, 3) for x in rk['step_s']]} (O2 on rank 0 "
            f"{[round(x, 3) for x in m2['o2_step_s']]}), peak "
            f"{rk['peak_gb']:.2f} GB; collective bytes a step "
            + ", ".join(f"{k} {v}" for k, v in later[0]["bytes"].items())
            + f"; host-staged collectives {coll_s:.2f} s of steps 2-"
            f"{len(rk['step_s'])}'s {step_s:.2f} s; by kind "
            + ", ".join(f"{k} {sum(c['seconds'][k] for c in later):.2f} s"
                        for k in later[0]["seconds"]))
    log(f"  (m2) f32 at {MESH_CHECK_LAYERS} layers: gradients max |mesh - "
        f"O2| / max |O2| {m2['grad_rel']:.3g} (bar {MESH_GRAD_REL_TOL}); "
        f"losses {m2['f32_losses']} against O2's {m2['f32_o2_losses']} (max "
        f"relative {m2['f32_loss_rel']:.3g}, bar {MESH_F32_LOSS_RTOL})")
    log(f"  (m3) {MOE_ARCH} at {MA_MOE_LAYERS} layers, "
        f"{m3['experts_a_rank']} experts a rank, one step of "
        f"{MA_TRAIN_BATCH} x {MA_MOE_SEQ}: loss {m3['loss']:.5f} against "
        f"O2's {m3['o2_loss']:.5f}, aux_lb {m3['aux_lb']:.6f} against "
        f"{m3['o2_aux_lb']:.6f} (bars {MESH_BF16_LOSS_TOL}, {MA_AUX_TOL}); "
        f"{m3['step_s']:.2f} s, peak {m3['peak_gb']:.2f} GB on rank 0; "
        f"launches a rank {m3['launches']} (as reckoned)")
    for dname, r in m4.items():
        log(f"  (m4) {ARCH} at {r['layers']} layers in {dname}, Engine at "
            f"O3 on (model {r['model']}): {FIXED_BATCH} x {FIXED_PROMPT} "
            f"prompt tokens, {FIXED_NEW} new in {r['generate_s']:.2f} s (O2 "
            f"{r['o2_generate_s']:.2f} s); prefill logits max |O3 - O2| "
            f"{r['logit_diff']:.4g} of {r['logit_scale']:.4g}; tokens equal "
            f"to O2's {r['token_agree']:.4f}"
            + (f" (the rows part at O2's top-2 margins {r['margins']})"
               if "margins" in r else "")
            + f"; KV cache {r['cache_bytes'] / 1e6:.1f} MB a rank at "
            f"{r['kv_heads']} kv heads against O2's "
            f"{r['o2_cache_bytes'] / 1e6:.1f}; launches a rank "
            f"{r['launches']}; every rank the same tokens")
    log(f"  seconds by step (slowest rank) " + ", ".join(
        f"{k} {v:.1f}" for k, v in ma["seconds"].items())
        + f"; a rank's set-up {ma['setup_s']:.2f} s")


# -- the mesh phases' one world ------------------------------------------------

def mesh_world_rank(rank: int, world: int, device: str, inp: dict,
                    tmp: str, phases: tuple) -> dict:
    """One rank of the mesh phases' world: ``phases`` of "2j"
    (:func:`mesh_rank`), "2k" (:func:`ring_serve_rank`), "2l"
    (:func:`mesh_train_rank`) and "2m" (:func:`model_axis_rank`) in turn,
    each timed."""
    run = {"2j": lambda: mesh_rank(rank, world, device, inp),
           "2k": lambda: ring_serve_rank(rank, world, device),
           "2l": lambda: mesh_train_rank(rank, world, device, tmp),
           "2m": lambda: model_axis_rank(rank, world, device, tmp)}
    out = {}
    for phase in phases:
        t = time.perf_counter()
        out[phase] = run[phase]()
        out[phase]["phase_s"] = time.perf_counter() - t
    return out


def run_mesh_world(torch, inp: dict, device: str = "cuda",
                   phases: tuple = ("2j", "2k", "2l", "2m")) -> dict:
    """Phases 2j, 2k, 2l and 2m in one world of :data:`MESH_RANKS` ranks
    (one spawn, one load of the kernel library a rank), then each phase's
    results from every rank's; ``world_s`` the world's wall time and
    ``phase_s`` each phase's on its slowest rank.  A temporary directory
    holds 2l's checkpoints and goes with the world."""
    import shutil

    from repro_torch.launch.world import run_world

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    timeout = sum({"2j": MESH_TIMEOUT_S, "2k": RING_TIMEOUT_S,
                   "2l": MESH_TRAIN_TIMEOUT_S,
                   "2m": MODEL_AXIS_TIMEOUT_S}[p] for p in phases)
    t = time.perf_counter()
    try:
        ranks = run_world(mesh_world_rank, MESH_RANKS,
                          args=(device, inp, tmp, phases), timeout=timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"world_s": time.perf_counter() - t,
           "phase_s": {p: max(r[p]["phase_s"] for r in ranks)
                       for p in phases}}
    if "2j" in phases:
        out["2j"] = mesh_path_results(torch, [r["2j"] for r in ranks], inp,
                                      device)
    if "2k" in phases:
        out["2k"] = ring_path_results([r["2k"] for r in ranks])
    if "2l" in phases:
        out["2l"] = train_path_results([r["2l"] for r in ranks])
    if "2m" in phases:
        out["2m"] = model_axis_results([r["2m"] for r in ranks])
    return out


# -- phase 2i: measured dispatch ---------------------------------------------

#: The variables phase 2i points into a temporary directory, and restores.
MEASURED_ENV = ("REPRO_TORCH_COSTMODEL", "REPRO_TORCH_AUTOTUNE_CACHE",
                "REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_DRIFT_RATIO")
#: (i4): re-dispatches of each swept call under drift.collect(), the ratio
#: that flags, and the factor of the injected stale entry.
DRIFT_CALLS, DRIFT_RATIO, DRIFT_INJECT = 5, 4.0, 100.0
#: (i5): calls per host-cost measurement, and rounds of them.
HOST_CALLS, HOST_ROUNDS = 2000, 5
#: (i2): rounds of re-timing a calibrated choice against its runner-up.
RETIME_ROUNDS = 3


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn`` (enqueue time: no sync in the
    loop; the card keeps up with these small calls), the garbage collector
    paused."""
    from repro_torch.launch.calibrate import gc_paused

    fn()
    torch.cuda.synchronize()
    with gc_paused():
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


def retime(torch, op, case, chosen: str, runner: str) -> tuple[str, dict]:
    """(i2)'s second look at a calibrated choice: ``chosen`` (what dispatch
    runs) and ``runner`` (the fastest other variant calibration ranks)
    timed in turns, RETIME_ROUNDS times each, as the sweep times them.
    'confirmed' when the chosen one wins by more than the registry's
    margin and both spreads, 'contradicted' when the runner-up does,
    'unresolved' otherwise.  Returns the verdict and each one's median
    and spread (seconds)."""
    from repro_torch.core import registry
    from repro_torch.launch import calibrate

    samples: dict = {chosen: [], runner: []}
    for _ in range(RETIME_ROUNDS):
        for name in (chosen, runner):
            samples[name] += calibrate.timings(
                lambda: registry.dispatch(op, *case.args, variant=name,
                                          **case.kwargs), True)
    stats = {}
    for name, ts in samples.items():
        ts.sort()
        stats[name] = (calibrate.median(ts), calibrate.spread(ts))
    (c, c_sp), (r, r_sp) = stats[chosen], stats[runner]
    margin = max(registry.CALIBRATION_MARGIN * min(c, r), c_sp, r_sp)
    verdict = "confirmed" if r - c > margin else \
        "contradicted" if c - r > margin else "unresolved"
    return verdict, stats


def run_measured_dispatch(torch, wrappers) -> dict:
    """Phase 2i: the calibration sweep at the sources' sizes into a
    temporary cost model and block cache, then (i2) explain and dispatch
    against each other and a calibrated choice re-timed against its
    runner-up, (i3) the calibrated choices'
    results, (i4) drift, (i5) host cost.  Launch counts are reset just
    before the sweep and read just after (i2).  Returns the phase's
    numbers."""
    from repro_torch.core import blocking, costmodel, registry, settings
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import ops
    from repro_torch.launch import calibrate
    from repro_torch.numerics import solvers
    from repro_torch.obs import drift
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.sparse.maskcompiler import MaskSpec, compile_layout

    saved = {k: os.environ.get(k) for k in MEASURED_ENV}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_2i_")
    out: dict = {"seconds": {}}
    try:
        os.environ["REPRO_TORCH_COSTMODEL"] = os.path.join(tmp, "cm.json")
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp,
                                                                "at.json")
        os.environ["REPRO_TORCH_AUTOTUNE"] = "1"
        os.environ["REPRO_TORCH_DRIFT_RATIO"] = str(DRIFT_RATIO)
        settings.reload()
        t = time.perf_counter()
        cases = calibrate.default_cases(device="cuda")
        torch.cuda.synchronize()
        out["seconds"]["inputs"] = time.perf_counter() - t

        # (i1) the sweep
        for w in wrappers.values():
            w.launches = 0
        t = time.perf_counter()
        rows = calibrate.autotune_sweep(cases)
        torch.cuda.synchronize()
        out["seconds"]["sweep"] = time.perf_counter() - t
        out["rows"] = rows
        model = costmodel.get_model()

        # (i2) explain's pick == the dispatched variant; where calibration
        # had two variants to rank, the pick re-timed against the
        # runner-up, in turns
        t = time.perf_counter()
        m = obs_metrics.METRICS
        picks = []
        for op, op_cases in cases.items():
            for case in op_cases:
                timed = {r["variant"]: r["seconds"] for r in rows
                         if r.get("case") == case.label and r["op"] == op
                         and "blocks" not in r and "seconds" in r}
                sel = [r["variant"] for r in registry.explain(
                    op, *case.args, **case.kwargs) if r["selected"]]
                m.reset(f"dispatch.{op}.")
                registry.dispatch(op, *case.args, **case.kwargs)
                ran = [k.rsplit(".", 1)[1] for k, v in
                       m.snapshot(f"dispatch.{op}.").items()
                       if v["value"] > 0]
                if not (len(ran) == 1 and sel == ran and ran[0] in timed):
                    raise AssertionError(
                        f"(i2) {op} {case.label}: explain selects {sel}, "
                        f"dispatch ran {ran}, the sweep timed {timed}")
                # the variants calibration ranks on the card: no oracle
                ranked = [n for n in timed
                          if not registry.REGISTRY.get(op, n).oracle]
                verdict, again = "static", {}
                if len(ranked) >= 2:
                    runner = min((n for n in ranked if n != ran[0]),
                                 key=timed.get)
                    verdict, again = retime(torch, op, case, ran[0], runner)
                    if verdict == "contradicted":
                        raise AssertionError(
                            f"(i2) {op} {case.label}: dispatch runs "
                            f"{ran[0]}, but {runner} beats it re-timed "
                            f"beyond the margin and the spreads: {again}")
                picks.append((op, case.label, ran[0], verdict, timed, again))
        torch.cuda.synchronize()
        out["launches"] = {k: w.launches for k, w in wrappers.items()}
        out["picks"] = picks
        out["seconds"]["i2"] = time.perf_counter() - t

        # (i3) the calibrated choices compute the same function
        t = time.perf_counter()
        csr = next(c for c in cases["solver_spmv"]
                   if c.label.startswith("csr")).args[0]
        spd_np = csr.todense().astype(np.float64)
        n_cg = csr.shape[0]
        b_np = np.random.default_rng(18).standard_normal(n_cg).astype(
            np.float32)
        b_card = csr.matvals.new_tensor(b_np)
        out["cg_variant"] = registry.select("solver_spmv", csr,
                                            b_card).name
        res = solvers.cg_solve(csr, b_card, stop=1e-10, max_iters=2 * n_cg)
        x = res.x.read()
        out["cg_rel"] = float(np.linalg.norm(spd_np @ x - b_np)
                              / np.linalg.norm(b_np))
        out["cg_iters"] = int(res.iterations)
        if not out["cg_rel"] < 1e-3:
            raise AssertionError(f"(i3) CG through {out['cg_variant']}: "
                                 f"relative residual {out['cg_rel']}")
        out["attn"] = {}
        cache = blocking.get_cache()
        for case in cases["flash_attention"]:
            q, k, v = case.args
            lq, lk = q.shape[2], k.shape[2]
            mask = case.kwargs.get("mask")
            variant = registry.select("flash_attention", *case.args,
                                      **case.kwargs).name
            key = blocking.AutotuneCache.key(
                "flash_attention", ops._fa_dims(q, k, mask),
                costmodel.dtype_name(q.dtype))
            entry = cache.entry(key) or {}
            bq, bk = ops._fa_blocks(lq, lk, entry.get("q"), entry.get("k"))
            got = ops.flash_attention(q, k, v, **case.kwargs)
            # its plain version at the same blocks: the same arithmetic
            # (P rounded to the inputs' dtype before P V), phase 1's bar
            plain = fa_k.flash_attention_tiles_plain(q, k, v, compile_layout(
                mask if mask is not None else MaskSpec(causal=True), lq, lk,
                bq, bk))
            rtol, atol = attn_tol(torch, q.dtype)
            what = f"(i3) flash_attention {case.label} at blocks {bq}x{bk}"
            err = max_err(torch, got.float(), plain.float(), rtol, atol,
                          f"{what} against its plain version")
            # the torch plane keeps P in f32: rounding P to bf16 moves o by
            # at most 2^-8 of max |v| (f32: the same bar as above)
            with registry.use_backend("torch"):
                want = ops.flash_attention(q, k, v, **case.kwargs)
            atol_plane = atol if q.dtype == torch.float32 else \
                2.0 ** -8 * float(v.abs().max())
            err_plane = max_err(torch, got.float(), want.float(), rtol,
                                atol_plane, f"{what} against the torch "
                                            f"plane")
            default = ops.flash_attention(q, k, v, block_q=128, block_k=128,
                                          **case.kwargs)
            out["attn"][case.label] = {
                "variant": variant, "err": err, "err_plane": err_plane,
                "atol_plane": atol_plane,
                "err_plane_default": float(
                    (default.float() - want.float()).abs().max()),
                "blocks": f"{bq}x{bk}", "seconds": entry.get("_seconds")}
        torch.cuda.synchronize()
        out["seconds"]["i3"] = time.perf_counter() - t

        # (i4) drift: re-dispatching flags nothing; an injected stale entry
        # is flagged
        t = time.perf_counter()
        drift.DETECTOR.clear()
        with calibrate.gc_paused():
            for op, op_cases in cases.items():
                for case in op_cases:
                    # one warm call first, as the sweep's timing has one
                    registry.dispatch(op, *case.args, **case.kwargs)
                    with drift.collect():
                        for _ in range(DRIFT_CALLS):
                            registry.dispatch(op, *case.args, **case.kwargs)
        out["drift_rows"] = drift.DETECTOR.report()
        flagged = drift.DETECTOR.flagged()
        if flagged:
            raise AssertionError(f"(i4) drift flags at ratio {DRIFT_RATIO}:"
                                 f" {flagged}")
        mm = cases["matmul"][0]
        stored = model.seconds_for("matmul", mm.args)["cuda"]
        model.record("matmul", "cuda", seconds=stored * DRIFT_INJECT,
                     args=mm.args)
        drift.DETECTOR.clear()
        with drift.collect(), calibrate.gc_paused():
            for _ in range(DRIFT_CALLS):
                registry.dispatch("matmul", *mm.args)
        flagged = drift.DETECTOR.flagged()
        if [(r["op"], r["variant"]) for r in flagged] != [("matmul",
                                                           "cuda")]:
            raise AssertionError(f"(i4) the injected stale matmul entry "
                                 f"is not flagged: {flagged}, report "
                                 f"{drift.DETECTOR.report()}, unmatched "
                                 f"{drift.DETECTOR.unmatched}")
        out["drift_injected"] = flagged[0]
        drift.DETECTOR.clear()
        out["seconds"]["i4"] = time.perf_counter() - t

        # (i5) host cost per call: rounds of each way of calling, the
        # median of each (the host's clock jumps by microseconds)
        t = time.perf_counter()
        a = torch.randn(64, 64, device="cuda")
        impl = registry.REGISTRY.get("matmul", "cuda").impl
        costmodel.get_model().record("matmul", "torch", seconds=1.0,
                                     args=(a, a))
        costmodel.get_model().record("matmul", "cuda", seconds=1e-5,
                                     args=(a, a))
        q, k, v = cases["flash_attention"][0].args
        dims = ops._fa_dims(q, k)
        dtype = costmodel.dtype_name(q.dtype)
        rounds: dict = {}
        for _ in range(HOST_ROUNDS):
            os.environ["REPRO_TORCH_COSTMODEL"] = os.path.join(tmp,
                                                               "none.json")
            settings.reload()
            for name, fn in (
                    ("impl", lambda: impl(a, a)),
                    ("dispatch", lambda: registry.dispatch("matmul", a, a))):
                rounds.setdefault(name, []).append(host_us(torch, fn))
            os.environ["REPRO_TORCH_COSTMODEL"] = os.path.join(tmp,
                                                               "cm.json")
            settings.reload()
            rounds.setdefault("dispatch_model", []).append(host_us(
                torch, lambda: registry.dispatch("matmul", a, a)))
            with obs_trace.TRACER.tracing():
                rounds.setdefault("dispatch_traced", []).append(host_us(
                    torch, lambda: registry.dispatch("matmul", a, a)))
            obs_trace.TRACER.clear()
            rounds.setdefault("resolve_hit", []).append(host_us(
                torch, lambda: blocking.resolve_blocks(
                    "flash_attention", dims, dtype, ops._FA_DEFAULTS,
                    ops._FA_CANDIDATES)))
            # the default path: no cache file, autotune off
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
                tmp, "none-at.json")
            os.environ.pop("REPRO_TORCH_AUTOTUNE")
            settings.reload()
            rounds.setdefault("resolve_untuned", []).append(host_us(
                torch, lambda: blocking.resolve_blocks(
                    "flash_attention", dims, dtype, ops._FA_DEFAULTS,
                    ops._FA_CANDIDATES)))
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
                tmp, "at.json")
            os.environ["REPRO_TORCH_AUTOTUNE"] = "1"
            settings.reload()
        host = {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}
        out["host_rounds"] = rounds
        out["host_us"] = host
        out["seconds"]["i5"] = time.perf_counter() - t
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        settings.reload()
    return out



def report_measured_dispatch(md: dict, card: str) -> None:
    """Log phase 2i's table and checks (:func:`run_measured_dispatch`)."""
    log(f"  (i1) calibration sweep on {card}: op, case, variant, blocks, "
        f"measured ms (whole dispatched call), H100-predicted ms, ratio")
    for r in md["rows"]:
        if "premeasured" in r:
            log(f"    {r['op']} {r['case']}: blocks premeasured "
                f"{r['premeasured']}")
            continue
        pred = r.get("predicted_seconds")
        log(f"    {r['op']} {r['case']} {r['variant']} "
            f"{r.get('blocks', '-')} {r['seconds'] * 1e3:.5f}"
            + (f" {pred * 1e3:.5f} x{r['seconds'] / pred:.2f}"
               if pred else ""))
    log("  (i2) explain == dispatch; a calibrated choice re-timed against "
        "its runner-up in turns (median / spread ms): " + "; ".join(
            f"{op} {label} {ran} {verdict}" + (
                " (" + ", ".join(f"{n} {med * 1e3:.4f} / {sp * 1e3:.4f}"
                                 for n, (med, sp) in again.items()) + ")"
                if again else "") + (
                " (sweep: " + ", ".join(f"{n} {t * 1e3:.4f}"
                                        for n, t in timed.items()) + ")"
                if len(timed) > 1 else "")
            for op, label, ran, verdict, timed, again in md["picks"]))
    log(f"  (i3) CG conf 18 through {md['cg_variant']}: {md['cg_iters']} "
        f"iterations, relative residual {md['cg_rel']:.2e}; attention at "
        f"measured blocks, max |err| against the plain version at those "
        f"blocks, and against the torch plane (bar) beside the default "
        f"128x128 blocks' distance to it: " + "; ".join(
            f"{k} {v['variant']} {v['blocks']} {v['err']:.3g}, "
            f"{v['err_plane']:.3g} ({v['atol_plane']:.3g}) vs "
            f"{v['err_plane_default']:.3g}"
            for k, v in md["attn"].items()))
    worst = md["drift_rows"][0]            # the report sorts worst first
    log(f"  (i4) drift at ratio {DRIFT_RATIO}: {len(md['drift_rows'])} "
        f"keys observed {DRIFT_CALLS}x each, none flagged (worst "
        f"{worst['op']} {worst['variant']} ratio {worst['ratio']}); "
        f"matmul cuda injected at {DRIFT_INJECT:g}x flagged at ratio "
        f"{md['drift_injected']['ratio']}")
    hu = md["host_us"]
    log(f"  (i5) host us per call, median of {HOST_ROUNDS} rounds of "
        f"{HOST_CALLS} (matmul 64 x 64): impl {hu['impl']:.2f}, dispatch no "
        f"model {hu['dispatch']:.2f}, memoised model "
        f"{hu['dispatch_model']:.2f}, tracer on {hu['dispatch_traced']:.2f}; "
        f"resolve_blocks cache hit {hu['resolve_hit']:.2f}, no cache and "
        f"autotune off {hu['resolve_untuned']:.2f}; rounds "
        + "; ".join(f"{k} " + " ".join(f"{x:.2f}" for x in v)
                    for k, v in md["host_rounds"].items()))


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: src/repro_torch not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    bind_package_helpers()
    load_peaks()
    # f32 products run in full precision: the yardstick must not use TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--sparse-shapes"]:
        inp = sparse_inputs()
        run_sparse_path(torch, inp, say=lambda *_: None)
        print(json.dumps(time_sparse_shapes(torch, scrub_buffer(torch),
                                            inp)))
        return 0
    if sys.argv[1:] == ["--backward-shapes"]:
        return time_backward_only(torch)

    import repro_torch.core as C
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels import fft as fft_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import matmul as mm_k
    from repro_torch.kernels import spgemm as spgemm_k
    from repro_torch.kernels import spmm as spmm_k
    from repro_torch.kernels import spmv as spmv_k
    from repro_torch.numerics import fft as nfft
    from repro_torch.numerics import matmul as mm
    from repro_torch.numerics import solvers, sparse, spmv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    t0 = time.perf_counter()
    _lib.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name, r in _lib.ptxas_report(PTXAS_NAMES).items():
        log(f"ptxas {name}: {r['instantiations']} instantiations, at most "
            f"{r['registers']} registers, {r['spill_stores']} / "
            f"{r['spill_loads']} bytes of spill stores / loads")
    dev = torch.device("cuda")
    kernels = {k: {"name": k} for k in
               ("matmul", "spmv_ell", "spmv_dia", "fft_stage", "spmm_ell",
                "spmm_bsr", "spgemm_bsr", "flash_attention",
                "flash_attention_lens", "flash_attention_tiles",
                *BWD_KERNELS)}

    # -- inputs of the main path (fixed seeds, as benchmarks/*.py) ----------
    n_mm = 1024
    rng = np.random.default_rng(n_mm)
    a_np = rng.standard_normal((n_mm, n_mm)).astype(np.float32)
    b_np = rng.standard_normal((n_mm, n_mm)).astype(np.float32)
    A, B = C.bind(a_np), C.bind(b_np)

    n_as, fill = sparse.MOD2AS_TABLE1[-1]
    s_np = sparse.random_sparse(n_as, fill, seed=n_as)
    csr = sparse.csr_from_dense(s_np)
    ell = sparse.ell_from_csr(csr)
    xs_np = np.random.default_rng(n_as).standard_normal(n_as).astype(
        np.float32)
    XS = C.bind(xs_np)

    n_f = 1 << 20
    rng = np.random.default_rng(n_f)
    z_np = (rng.standard_normal(n_f) + 1j * rng.standard_normal(n_f)).astype(
        np.complex64)
    Z = C.bind(z_np)

    conf, (n_cg, bw) = 18, sparse.CG_TABLE2[17]
    spd_np = sparse.banded_spd(n_cg, bw, seed=conf)
    cg_csr = sparse.csr_from_dense(spd_np)
    cg_dia = sparse.dia_from_dense(spd_np)
    bcg_np = np.random.default_rng(conf).standard_normal(n_cg).astype(
        np.float32)
    BCG = C.bind(bcg_np)

    sparse_in = sparse_inputs()

    # -- phase 1: every kernel against its plain version --------------------
    kernels["matmul"]["max_abs_err"] = max_err(
        torch, mm_k.matmul(A.data, B.data), mm_k.matmul_plain(A.data, B.data),
        2e-5, 1e-3, "matmul f32 1024")
    # (129, 100, 132): the f32 cp.async ring at ragged M, N and K
    for m, k, n in ((130, 257, 129), (1, 7, 3), (96, 80, 112),
                    (129, 100, 132)):
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            a = torch.randn(m, k, device=dev).to(dt)
            b = torch.randn(k, n, device=dev).to(dt)
            max_err(torch, mm_k.matmul(a, b).float(),
                    mm_k.matmul_plain(a, b).float(), tol, tol * 10,
                    f"matmul {dt} {(m, k, n)}")
    ab = A.data.bfloat16(), B.data.bfloat16()
    max_err(torch, mm_k.matmul(*ab).float(), mm_k.matmul_plain(*ab).float(),
            2e-2, 0.5, "matmul bf16 1024")

    kernels["spmv_ell"]["max_abs_err"] = max_err(
        torch, spmv_k.spmv_ell(ell.values, ell.cols, XS.data),
        spmv_k.spmv_ell_plain(ell.values, ell.cols, XS.data), 1e-4, 1e-4,
        "spmv_ell 10240")
    small = sparse.ell_from_csr(sparse.csr_from_dense(
        sparse.random_sparse(100, 3.5, seed=100)))
    xsm = torch.randn(100, device=dev)
    max_err(torch, spmv_k.spmv_ell(small.values, small.cols, xsm),
            spmv_k.spmv_ell_plain(small.values, small.cols, xsm), 1e-4, 1e-4,
            "spmv_ell 100")

    xcg = torch.randn(n_cg, device=dev)
    kernels["spmv_dia"]["max_abs_err"] = max_err(
        torch, spmv_k.spmv_dia(cg_dia.diags, cg_dia.offsets, xcg),
        spmv_k.spmv_dia_plain(cg_dia.diags, cg_dia.offsets, xcg), 1e-4, 1e-4,
        "spmv_dia conf 18")
    d33 = sparse.dia_from_dense(sparse.banded_spd(33, 32, seed=33))
    x33 = torch.randn(33, device=dev)
    max_err(torch, spmv_k.spmv_dia(d33.diags, d33.offsets, x33),
            spmv_k.spmv_dia_plain(d33.diags, d33.offsets, x33), 1e-4, 1e-4,
            "spmv_dia 33")
    # a tridiagonal system at 2^20 (many row tiles, one chunk), and conf 18
    # run to run: its chunks' partial sums add in a fixed order
    n_tri = 1 << 20
    tri = torch.randn(3, n_tri, device=dev)
    tri[0, 0] = tri[2, -1] = 0.0
    xtri = torch.randn(n_tri, device=dev)
    max_err(torch, spmv_k.spmv_dia(tri, (-1, 0, 1), xtri),
            spmv_k.spmv_dia_plain(tri, (-1, 0, 1), xtri), 1e-4, 1e-4,
            "spmv_dia tridiagonal 2^20")
    y_cg = spmv_k.spmv_dia(cg_dia.diags, cg_dia.offsets, xcg)
    for _ in range(10):
        if not torch.equal(spmv_k.spmv_dia(cg_dia.diags, cg_dia.offsets, xcg),
                           y_cg):
            raise AssertionError("spmv_dia: two calls on the same inputs "
                                 "differ (conf 18)")

    perm, tw_re, tw_im = ops.fft_plan(n_f, torch.float32, dev)
    tangled = Z.data[perm]
    re0 = tangled.real.contiguous()
    im0 = tangled.imag.contiguous()
    errs = []
    for m in (n_f // 2, 1024, 1):
        got = fft_k.fft_stage(re0.view(-1, 2), im0.view(-1, 2), tw_re, tw_im,
                              m)
        want = fft_k.fft_stage_plain(re0.view(-1, 2), im0.view(-1, 2),
                                     tw_re, tw_im, m)
        errs += [max_err(torch, g, w, 1e-5, 1e-5, f"fft_stage m={m}")
                 for g, w in zip(got, want)]
    # the fused kernel at each pass size on the path's data: one pass of
    # 10 stages (first and last), of 7 and 6 (13 stages), of 1; the whole
    # transform (two passes of 10); FMA against two roundings per stage,
    # as for ops.fft below
    for s0, count in ((0, 10), (10, 10), (0, 13), (5, 1), (0, 20)):
        got = fft_k.fft_stages(re0, im0, tw_re, tw_im, s0, count)
        want = fft_k.fft_stages_plain(re0, im0, tw_re, tw_im, s0, count)
        atol = 4 * torch.finfo(torch.float32).eps * n_f ** 0.5 * count
        errs += [max_err(torch, g, w, 1e-5, atol,
                         f"fft_stages s0={s0} count={count} "
                         f"(passes {fft_k.pass_sizes(count)})")
                 for g, w in zip(got, want)]
    kernels["fft_stage"]["max_abs_err"] = max(errs)
    for zz in (Z.data, torch.randn(16, dtype=torch.complex128, device=dev)):
        got = ops.fft(zz)
        with ops.backend("torch"):
            plain = ops.fft(zz)
        # FMA in the kernel vs two roundings in the plain stage: a few ulps
        # of |x| (which grows like sqrt(n)) per stage, over log2 n stages.
        nz = zz.shape[0]
        atol = 4 * torch.finfo(got.real.dtype).eps * nz ** 0.5 * (
            nz.bit_length() - 1)
        max_err(torch, got, plain, 1e-5, atol, f"fft {nz}")

    hold_sparse_kernels(torch, sparse_in, ell, kernels)
    for name, e in hold_attention_kernels(torch, ATTN_SHAPE[1:3]
                                          + ATTN_SHAPE[4:]).items():
        kernels[name]["max_abs_err"] = e
    for heads in HEAD_DIM_SHAPES:
        hold_attention_kernels(torch, heads)
    for heads in MOE_HEADS:
        hold_moe_heads(torch, heads)
    hold_frontend_heads(torch)
    for name, e in hold_backward_kernels(torch).items():
        kernels[name]["max_abs_err"] = e
    torch.cuda.synchronize()
    log(f"phase 1: {len(kernels)} kernels agree with their plain versions")

    # -- phase 2a: the paper's path, counted --------------------------------
    wrappers = {"matmul": mm_k.matmul, "spmv_ell": spmv_k.spmv_ell,
                "spmv_dia": spmv_k.spmv_dia, "fft_stage": fft_k.fft_stages}
    for w in wrappers.values():
        w.launches = 0
    t_path = time.perf_counter()

    want = a_np.astype(np.float64) @ b_np.astype(np.float64)
    got = ops.matmul(A.data, B.data)
    np.testing.assert_allclose(C.wrap(got).read(), want, rtol=2e-3,
                               atol=2e-3)
    # the reference's block keywords pin a Pallas tile; here they change
    # nothing
    if not torch.equal(ops.matmul(A.data, B.data, block_m=256, block_n=256,
                                  block_k=512), got):
        raise AssertionError("ops.matmul: block keywords changed the result")
    for f in (mm.arbb_mxm1, mm.arbb_mxm2a, mm.arbb_mxm2b):
        np.testing.assert_allclose(f(A, B).read(), want, rtol=2e-3,
                                   atol=2e-3, err_msg=f.__name__)
    a256, b256 = C.bind(a_np[:256, :256]), C.bind(b_np[:256, :256])
    np.testing.assert_allclose(
        mm.arbb_mxm0(a256, b256).read(),
        a_np[:256, :256].astype(np.float64) @ b_np[:256, :256], rtol=2e-3,
        atol=2e-3)
    log(f"mod2am n={n_mm}: ops.matmul, arbb_mxm1/2a/2b ok; arbb_mxm0 n=256 ok")

    want = s_np @ xs_np.astype(np.float64)
    np.testing.assert_allclose(
        C.wrap(ops.spmv_ell(ell.values, ell.cols, XS.data)).read(), want,
        rtol=1e-3, atol=1e-3)
    for f in (spmv.arbb_spmv1, spmv.arbb_spmv2):
        np.testing.assert_allclose(f(csr, XS).read(), want, rtol=1e-3,
                                   atol=1e-3, err_msg=f.__name__)
    log(f"mod2as n={n_as} fill={fill}% nnz={csr.nnz} width={ell.width}: "
        f"ops.spmv_ell, arbb_spmv1, arbb_spmv2 ok")

    want = np.fft.fft(z_np)
    for name, out in (("ops.fft", C.wrap(ops.fft(Z.data)).read()),
                      ("split_stream_fft", nfft.split_stream_fft(Z).read())):
        np.testing.assert_allclose(out, want, rtol=1e-2, atol=1e-3 * n_f,
                                   err_msg=name)
    log(f"mod2f n={n_f}: ops.fft, split_stream_fft ok")

    cg_rows = []
    for backend, mat in (("spmv2", cg_csr), ("dia", cg_dia)):
        t = time.perf_counter()
        res = solvers.cg_solve(mat, BCG, stop=1e-10, max_iters=2 * n_cg,
                               backend=backend)
        x = res.x.read()
        rel = float(np.linalg.norm(spd_np @ x - bcg_np)
                    / np.linalg.norm(bcg_np))
        if not rel < 1e-3:
            raise AssertionError(f"CG {backend}: relative residual {rel}")
        cg_rows.append(f"{backend}: {int(res.iterations)} iters, rel "
                       f"residual {rel:.2e}, {time.perf_counter() - t:.2f} s")
    np.testing.assert_allclose(
        C.wrap(ops.spmv_dia(cg_dia.diags, cg_dia.offsets, BCG.data)).read(),
        spd_np @ bcg_np.astype(np.float64), rtol=1e-3, atol=1e-3)
    log(f"cg conf {conf} n={n_cg} bw={bw}: " + "; ".join(cg_rows)
        + "; ops.spmv_dia ok")
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"phase 2a: paper path in {time.perf_counter() - t_path:.2f} s, "
        f"kernel launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the paper path: "
                             f"{missing}")

    # -- phase 2b: the blocked-sparse path, counted -------------------------
    sparse_wrappers = {"spmm_ell": spmm_k.spmm_ell,
                       "spmm_bsr": spmm_k.spmm_bsr,
                       "spgemm_bsr": spgemm_k.spgemm_bsr}
    for w in sparse_wrappers.values():
        w.launches = 0
    t_path = time.perf_counter()
    run_sparse_path(torch, sparse_in)
    sparse_launches = {k: w.launches for k, w in sparse_wrappers.items()}
    log(f"phase 2b: blocked-sparse path in "
        f"{time.perf_counter() - t_path:.2f} s, kernel launches "
        f"{sparse_launches}")
    missing = [k for k, v in sparse_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the blocked-sparse "
                             f"path: {missing}")
    launches.update(sparse_launches)

    # -- phases 2j-2m: mesh scope, one world, counted on every rank ---------
    t_path = time.perf_counter()
    world = run_mesh_world(torch, mesh_inputs(csr, z_np, a_np, b_np, spd_np,
                                              bcg_np))
    log(f"phases 2j, 2k, 2l and 2m: one world of {MESH_RANKS} ranks on "
        f"the one card (gloo, staged through host memory; not scaling "
        f"numbers), in {time.perf_counter() - t_path:.2f} s (the world "
        f"{world['world_s']:.2f} s; each phase on its slowest rank: "
        + ", ".join(f"{p} {v:.2f} s" for p, v in world["phase_s"].items())
        + ")")
    mesh, ring, mtrain = world["2j"], world["2k"], world["2l"]
    log(f"phase 2j: mesh scope: matmul launches over the ranks "
        f"{mesh['launches']}")
    report_mesh_path(mesh)
    launches["matmul"] += mesh["launches"]
    log(f"phase 2k: serving at mesh scope: attention launches over the "
        f"ranks {ring['launches']}")
    report_ring_path(ring, smi[0])
    for k, n in ring["launches"].items():
        launches[k] = launches.get(k, 0) + n
    log(f"phase 2l: training at mesh scope: launches over the ranks "
        f"{mtrain['launches']}")
    report_train_mesh_path(mtrain, smi[0])
    for k, n in mtrain["launches"].items():
        launches[k] = launches.get(k, 0) + n
    maxis = world["2m"]
    log(f"phase 2m: the model axis's compute split: launches over the ranks "
        f"{maxis['launches']}")
    report_model_axis_path(maxis, smi[0])
    for k, n in maxis["launches"].items():
        launches[k] = launches.get(k, 0) + n

    # -- phase 2c: the serve path, counted ----------------------------------
    attn_wrappers = {"flash_attention": fa_k.flash_attention,
                     "flash_attention_lens": fa_k.flash_attention_lens,
                     "flash_attention_tiles": fa_k.flash_attention_tiles}
    t_path = time.perf_counter()
    serve = run_serve_path(torch, attn_wrappers)
    attn_launches = serve["launches"]
    log(f"phase 2c: {ARCH} serve path and its checks in "
        f"{time.perf_counter() - t_path:.2f} s, kernel launches: Engine "
        f"{serve['fixed_launches']}, ContinuousEngine "
        f"{serve['cont_launches']} (lens by kernel "
        f"{serve['cont_lens_kernels']})")
    missing = [f"Engine {k}" for k in ("flash_attention_tiles",)
               if serve["fixed_launches"][k] == 0] + [
        f"ContinuousEngine {k}" for k in ("flash_attention_lens",
                                          "flash_attention_tiles")
        if serve["cont_launches"][k] == 0] + [
        f"ContinuousEngine flash_attention_lens ({kind})"
        for kind, n in serve["cont_lens_kernels"].items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serve path: "
                             f"{missing}")
    for k, n in attn_launches.items():          # phase 2k counted some
        launches[k] = launches.get(k, 0) + n
    log(f"{ARCH} ({serve['params']} parameters, bf16, init "
        f"{serve['init_s']:.2f} s) on {smi[0]}:")
    log(f"  Engine: {FIXED_BATCH} x {FIXED_PROMPT} prompt tokens, "
        f"{FIXED_NEW} new: {serve['fixed_tok_s']:.1f} tok/s, time to first "
        f"token {serve['fixed_ttft_s'] * 1e3:.1f} ms, "
        f"{serve['fixed_step_s'] * 1e3:.2f} ms per decode step")
    log(f"  ContinuousEngine: {len(SERVE_REQS)} requests, {SERVE_SLOTS} "
        f"slots, chunk {SERVE_CHUNK}: {serve['cont_tok_s']:.1f} tok/s, "
        f"mean time to first token {serve['cont_ttft_s'] * 1e3:.1f} ms, "
        f"{serve['cont_iters']} iterations of "
        f"{serve['cont_iter_s'] * 1e3:.2f} ms")
    log(f"  (a) prefill logits cuda vs torch plane: max abs diff "
        f"{serve['a_max_abs']:.4g} (logit scale {serve['a_scale']:.4g}), "
        f"argmax agreement {serve['a_argmax_agree']:.3f}")
    log(f"  (b) f32, 2 layers: {serve['b_equal']}/{len(SERVE_REQS)} requests "
        f"token-equal; margins at divergences {serve['b_margins']}")
    tr = serve["traced"]
    log(f"  traced ContinuousEngine run (TRACER on, metrics reset, a "
        f"heartbeat store): tok/s in turns untraced, traced, untraced, "
        f"traced: {tr['untraced_tok_s'][0]:.1f}, {tr['tok_s'][0]:.1f}, "
        f"{tr['untraced_tok_s'][1]:.1f}, {tr['tok_s'][1]:.1f}; "
        f"{tr['iters']} iterations, "
        f"{tr['events']} trace events ({TRACE_PATH.name}); tokens bitwise "
        f"equal to the untraced run on {tr['bitwise']}/{len(SERVE_REQS)} "
        f"requests; " + ", ".join(f"{k} ({a} = {b})" for k, (a, b)
                                  in tr["relation"].items()))

    # -- phase 2d: the training path, counted -------------------------------
    train_wrappers = {**attn_wrappers,
                      **{k: getattr(fa_k, k) for k in BWD_KERNELS}}
    t_path = time.perf_counter()
    train = run_train_path(torch, train_wrappers)
    log(f"phase 2d: {ARCH} training path and its checks in "
        f"{time.perf_counter() - t_path:.2f} s, kernel launches over "
        f"{TRAIN_STEPS} steps: {train['launches']}")
    for k in BWD_KERNELS:                       # phase 2l counted some
        launches[k] = launches.get(k, 0) + train["launches"][k]
    log(f"{ARCH} training (full width, bf16 parameters, f32 AdamW moments, "
        f"remat; init {train['init_s']:.2f} s) on {smi[0]}: "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"lr {TRAIN_LR}")
    for h, dt in zip(train["history"], train["step_s"]):
        log(f"  step {h['step']}: loss {h['loss']:.4f}, grad_norm "
            f"{h['grad_norm']:.4f}, {dt * 1e3:.1f} ms")
    log(f"  {train['tok_s']:.1f} tokens/s over steps 2-{TRAIN_STEPS}; "
        f"peak memory allocated {train['peak_gb']:.2f} GB")
    named = {k: v for k, v in train["d_rel"].items()
             if any(f"['{n}']" in k for n in ("wq", "wk", "wv", "q_norm",
                                               "k_norm"))}
    log(f"  (d) f32, 2 layers, gradients cuda vs torch plane, max |diff| / "
        f"max |grad| (bar {D_REL_TOL}): worst "
        f"{max(train['d_rel'].values()):.3g}; "
        + ", ".join(f"{k} {v:.3g}" for k, v in named.items()))
    log(f"  (e) 2 layers, save at 3, crash at 5: resumed at step "
        f"{train['e_resumed_at']}, {train['e_equal']}/{train['e_leaves']} "
        f"parameters bitwise equal to the uninterrupted run")

    # -- phase 3: times, cold L2 --------------------------------------------
    scrub = scrub_buffer(torch)

    def cold_ms(fn, iters: int) -> float:
        return time_ms(torch, fn, iters, scrub)

    a, b = A.data, B.data
    rec = kernels["matmul"]
    rec["ms"] = cold_ms(lambda: mm_k.matmul(a, b), 50)
    rec["plain_ms"] = cold_ms(lambda: mm_k.matmul_plain(a, b), 50)
    rec["library_ms"] = cold_ms(lambda: torch.matmul(a, b), 50)
    rec["bound_ms"], rec["bound_by"] = bound_ms(3 * n_mm * n_mm * 4,
                                                2.0 * n_mm ** 3)
    # the register-staged path: bf16 in and out at n = 1024, and f32 at
    # n = 1023 (K and N not multiples of 4), each beside torch.matmul
    ab16 = a.bfloat16(), b.bfloat16()
    rec["bf16_ms"] = cold_ms(lambda: mm_k.matmul(*ab16), 50)
    rec["bf16_library_ms"] = cold_ms(lambda: torch.matmul(*ab16), 50)
    ar, br = a[:-1, :-1].contiguous(), b[:-1, :-1].contiguous()
    rec["ragged_ms"] = cold_ms(lambda: mm_k.matmul(ar, br), 50)
    rec["ragged_library_ms"] = cold_ms(lambda: torch.matmul(ar, br), 50)

    def csr_tensor(m: sparse.CSR):
        return torch.sparse_csr_tensor(m.rowp.long(), m.indx.long(),
                                       m.matvals, size=m.shape,
                                       check_invariants=False)

    vals, cols, x = ell.values, ell.cols, XS.data
    lib_as = csr_tensor(csr)
    rec = kernels["spmv_ell"]
    rec["ms"] = cold_ms(lambda: spmv_k.spmv_ell(vals, cols, x), 200)
    rec["plain_ms"] = cold_ms(
        lambda: spmv_k.spmv_ell_plain(vals, cols, x), 200)
    rec["library_ms"] = cold_ms(lambda: lib_as @ x, 200)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        csr.nnz * 8 + 2 * n_as * 4, 2.0 * csr.nnz)

    diags, offs = cg_dia.diags, cg_dia.offsets
    band = sum(n_cg - abs(o) for o in offs)
    lib_cg = csr_tensor(cg_csr)
    rec = kernels["spmv_dia"]
    rec["ms"] = cold_ms(lambda: spmv_k.spmv_dia(diags, offs, xcg), 200)
    rec["plain_ms"] = cold_ms(
        lambda: spmv_k.spmv_dia_plain(diags, offs, xcg), 5)
    rec["library_ms"] = cold_ms(lambda: lib_cg @ xcg, 200)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        band * 4 + len(offs) * 4 + 2 * n_cg * 4, 2.0 * band)

    # one transform's log2 n stages on tangled data: one call of the fused
    # wrapper (its launches per call counted), and the plain stage chain
    stages = n_f.bit_length() - 1
    rec = kernels["fft_stage"]
    before = fft_k.fft_stages.launches
    fft_k.fft_stages(re0, im0, tw_re, tw_im, 0, stages)
    rec["launches_per_call"] = fft_k.fft_stages.launches - before
    rec["ms"] = cold_ms(lambda: fft_k.fft_stages(
        re0, im0, tw_re, tw_im, 0, stages), 50)
    rec["plain_ms"] = cold_ms(lambda: fft_k.fft_stages_plain(
        re0, im0, tw_re, tw_im, 0, stages), 20)
    zd = Z.data
    rec["library_ms"] = cold_ms(lambda: torch.fft.fft(zd), 20)
    # The transform's inputs (tangled re/im, both twiddle tables) read once
    # and its output written once.  Each stage's output is the next stage's
    # input and need not leave the chip (it stays in L2 here), so charging
    # every stage's 16 B per point at the HBM rate would overstate the bound.
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        8 * n_f + (tw_re.numel() + tw_im.numel()) * 4 + 8 * n_f,
        stages * 5.0 * n_f)

    timed_sparse = time_sparse_kernels(torch, sparse_in, csr, ell, kernels,
                                       cold_ms, csr_tensor)
    shapes = time_sparse_shapes(torch, scrub, sparse_in)
    kernels["spmm_ell"]["path_kernel_ms"] = {
        k: v for k, v in shapes.items() if k.startswith("spmm_ell")}
    kernels["spmm_bsr"]["shapes_kernel_ms"] = {
        k: v for k, v in shapes.items() if k.startswith("spmm_bsr")}
    kernels["spgemm_bsr"]["cases_kernel_ms"] = {
        k: v for k, v in shapes.items() if k.startswith("spgemm_bsr")}
    for name in SPARSE_KERNELS:
        rec = shapes[f"path {name}"]
        kernels[name]["path_device_ms"] = rec["ms"]
        kernels[name]["path_traced_launches"] = rec["launches"]
    timed_attn, lens_prefix, lens112 = time_attention_kernels(
        torch, kernels, cold_ms)
    timed_bwd = time_backward_kernels(torch, kernels, cold_ms)
    timed_bwd112 = time_backward_kernels(torch, kernels, cold_ms,
                                         BWD_D112_SHAPE, "d112_")
    tiles64 = time_tiles_d64(torch, kernels, cold_ms)
    timed_bwd64 = time_backward_kernels(torch, kernels, cold_ms, D64_SHAPE,
                                        "d64_")

    routes = {
        "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:35"),
        "spmv_ell": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:42"),
        "spmv_dia": ("src/repro_torch/kernels/csrc/spmv.cu",
                     "src/repro/kernels/spmv.py:88"),
        "fft_stage": ("src/repro_torch/kernels/csrc/fft.cu",
                      "src/repro/kernels/fft.py:36"),
        "spmm_ell": ("src/repro_torch/kernels/csrc/spmm.cu",
                     "src/repro/kernels/spmm.py:41"),
        "spmm_bsr": ("src/repro_torch/kernels/csrc/spmm.cu",
                     "src/repro/kernels/spmm.py:91"),
        "spgemm_bsr": ("src/repro_torch/kernels/csrc/spgemm.cu",
                       "src/repro/kernels/spgemm.py:45"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:154"),
        "flash_attention_lens": (
            "src/repro_torch/kernels/csrc/flash_attention_lens.cu",
            "src/repro/kernels/flash_attention.py:183"),
        "flash_attention_tiles": (
            "src/repro_torch/kernels/csrc/flash_attention_tiles.cu",
            "src/repro/kernels/flash_attention.py:275"),
        **{k: ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               "none: port-only (src/repro/train/step.py:53 differentiates "
               "with jax.value_and_grad through the XLA plane)")
           for k in BWD_KERNELS},
    }
    timed = {"matmul": lambda: mm_k.matmul(a, b),
             "spmv_ell": lambda: spmv_k.spmv_ell(vals, cols, x),
             "spmv_dia": lambda: spmv_k.spmv_dia(diags, offs, xcg),
             "fft_stage": lambda: fft_k.fft_stages(re0, im0, tw_re, tw_im,
                                                  0, stages),
             **timed_sparse, **timed_attn, **timed_bwd}
    # the kernels' symbols, where the record's name is not "<name>_kernel"
    symbols = {"fft_stage": "fft_stages_kernel", **BWD_SYMBOLS,
               "flash_attention": "flash_attention_bf16_kernel",
               "flash_attention_lens": "flash_attention_lens_decode_kernel",
               "flash_attention_tiles": "flash_attention_tiles_"}
    for name, fn in timed.items():
        kernels[name]["kernel_ms"] = kernel_ms(
            torch, fn, 20, symbols.get(name, f"{name}_kernel"), scrub,
            kernels[name].get("launches_per_call", 1))
    kernels["flash_attention_lens"]["prefix_kernel_ms"] = kernel_ms(
        torch, lens_prefix, 20, "flash_attention_lens_prefix_kernel", scrub)
    kernels["flash_attention_lens"]["d112_kernel_ms"] = kernel_ms(
        torch, lens112, 20, "flash_attention_lens_decode_kernel", scrub)
    for name, fn in timed_bwd112.items():
        kernels[name]["d112_kernel_ms"] = kernel_ms(torch, fn, 20,
                                                    BWD_SYMBOLS[name], scrub)
    for name, fn in timed_bwd64.items():
        kernels[name]["d64_kernel_ms"] = kernel_ms(torch, fn, 20,
                                                   BWD_SYMBOLS[name], scrub)
    kernels["flash_attention_tiles"]["d64_kernel_ms"] = kernel_ms(
        torch, tiles64, 20, symbols["flash_attention_tiles"], scrub)
    fixed_prof, cont_prof = serve.pop("profile")()
    log(f"{ARCH} device time by kernel group on {smi[0]}:")
    log(f"  Engine, {PROFILE_NEW} new tokens: {fmt_breakdown(fixed_prof)}")
    log(f"  ContinuousEngine, first {SERVE_SLOTS} requests with "
        f"{PROFILE_NEW} new tokens: {fmt_breakdown(cont_prof)}")
    log(f"  training, one step of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
        f"{fmt_breakdown(train.pop('profile')())}")
    t = time.perf_counter()
    terms = train.pop("roofline")()
    t = time.perf_counter() - t
    step = sorted(train["step_s"][1:])[(TRAIN_STEPS - 1) // 2]
    log(f"  roofline of that step (utils.roofline.analyze, one counting "
        f"pass): {terms.flops_per_chip / 1e12:.3f} TFLOP, "
        f"{terms.hbm_bytes_per_chip / 1e9:.2f} GB, collective "
        f"{terms.coll_bytes_per_chip:.0f} B; compute "
        f"{terms.t_compute * 1e3:.2f} ms, memory {terms.t_memory * 1e3:.2f} "
        f"ms, collective {terms.t_collective * 1e3:.3f} ms (dominant "
        f"{terms.dominant}); useful_ratio {terms.useful_ratio:.3f}; "
        f"measured step {step * 1e3:.1f} ms (median of steps "
        f"2-{TRAIN_STEPS}), {step / terms.step_time:.1f}x the larger term; "
        f"the pass took {t:.1f} s")

    # -- phase 2e: the MoE serve path, counted ------------------------------
    # after phase 3, whose profiles keep phase 2c's and 2d's models: the
    # card must hold qwen3-moe-30b-a3b's 61 GB of weights alone
    del timed, timed_attn, timed_bwd, timed_bwd112, timed_bwd64, tiles64
    del timed_sparse, scrub
    del lens_prefix, lens112
    del sparse_in, A, B, Z, XS, BCG, a, b, ab, ab16, ar, br, zd, tangled
    del re0, im0, vals, x, lib_as, lib_cg, xcg, tri, xtri, y_cg, xsm
    t_path = time.perf_counter()
    moe = run_moe_path(torch, attn_wrappers)
    log(f"phase 2e: {MOE_ARCH} and {ARCTIC_ARCH} serve paths and their "
        f"checks in {time.perf_counter() - t_path:.2f} s; free on the card "
        f"before it {moe['free_gb']:.2f} GB ({moe['allocated_gb']:.2f} GB "
        f"still allocated); kernel launches: Engine "
        f"{moe['fixed_launches']}, ContinuousEngine "
        f"{moe['cont_launches']}, {ARCTIC_ARCH} (both engines) "
        f"{moe['arctic_launches']}")
    for name, kinds in (("flash_attention_lens", ("lens_decode",
                                                  "lens_prefix")),
                        ("flash_attention_tiles", ("tiles", "tiles_state"))):
        launches[name] += sum(moe[run][k] for k in kinds
                              for run in ("fixed_launches", "cont_launches",
                                          "arctic_launches"))
    log(f"{MOE_ARCH} at {MOE_SERVE_LAYERS} of 48 layers ({moe['params']} "
        f"parameters, "
        f"{moe['param_gb']:.2f} GB: bf16, routers f32; init "
        f"{moe['init_s']:.2f} s; peak memory allocated "
        f"{moe['peak_gb']:.2f} GB) on {smi[0]}:")
    log(f"  Engine: {FIXED_BATCH} x {FIXED_PROMPT} prompt tokens, "
        f"{FIXED_NEW} new: {moe['fixed_tok_s']:.1f} tok/s, time to first "
        f"token {moe['fixed_ttft_s'] * 1e3:.1f} ms, "
        f"{moe['fixed_step_s'] * 1e3:.2f} ms per decode step (bound "
        f"{moe['step_bound_ms']:.2f} ms: every weight but the embedding "
        f"read once at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    log(f"  ContinuousEngine: {len(SERVE_REQS)} requests, {SERVE_SLOTS} "
        f"slots, chunk {SERVE_CHUNK}: {moe['cont_tok_s']:.1f} tok/s, "
        f"mean time to first token {moe['cont_ttft_s'] * 1e3:.1f} ms, "
        f"{moe['cont_iters']} iterations of "
        f"{moe['cont_iter_s'] * 1e3:.2f} ms")
    log(f"  (a-moe) f32, 2 layers: prefill logits max |cuda - torch| / max "
        f"|torch| {moe['a_rel']:.3g} (bar {A_MOE_REL_TOL}); top-k sets "
        f"agree on {moe['a_sets'][0]}/{moe['a_sets'][1]} (token, layer) "
        f"pairs")
    log(f"  (f) two ContinuousEngine runs: {moe['f_equal']}/"
        f"{len(SERVE_REQS)} requests bitwise equal")
    agree, pairs = moe["route_share"]
    by_layer = moe["route_share_by_layer"]
    log(f"  bf16, {MOE_SERVE_LAYERS} layers, cuda vs torch plane (printed, "
        f"not held): top-k "
        f"sets agree on {agree}/{pairs} (token, layer) pairs "
        f"({agree / pairs:.4f}); by layer "
        + " ".join(f"{x:.3f}" for x in by_layer))
    log(f"  device time by kernel group, Engine, {PROFILE_NEW} new tokens: "
        f"{fmt_breakdown(moe['profile_fixed'])}")
    log(f"  ContinuousEngine, first {SERVE_SLOTS} requests with "
        f"{PROFILE_NEW} new tokens: {fmt_breakdown(moe['profile_cont'])}")
    log(f"{ARCTIC_ARCH} at {ARCTIC_LAYERS} layers ({moe['arctic_params']} "
        f"parameters, init {moe['arctic_init_s']:.2f} s, peak memory "
        f"allocated {moe['arctic_peak_gb']:.2f} GB): Engine on "
        f"{ARCTIC_BATCH} x {ARCTIC_PROMPT} tokens, {ARCTIC_NEW} new, and "
        f"the ContinuousEngine on the same requests in "
        f"{moe['arctic_s']:.2f} s; logits finite")
    log("  phase 2e's wall time by step: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in moe["seconds"].items()))

    # -- phase 2f: the SSM and hybrid serve paths, counted ------------------
    # after phase 2e, whose models run_moe_path has dropped
    t_path = time.perf_counter()
    ssm = run_ssm_path(torch, attn_wrappers)
    log(f"phase 2f: {' and '.join(SSM_ARCHS)} serve paths and their checks "
        f"in {time.perf_counter() - t_path:.2f} s; free on the card before "
        f"it {ssm['free_gb']:.2f} GB")
    for arch in SSM_ARCHS:
        r = ssm[arch]
        launches["flash_attention_tiles"] += r["launches"]["tiles"]
        log(f"{arch} ({r['params']} parameters, {r['param_gb']:.2f} GB, "
            f"init {r['init_s']:.2f} s, peak memory allocated "
            f"{r['peak_gb']:.2f} GB) on {smi[0]}:")
        log(f"  Engine: {FIXED_BATCH} x {SSM_PROMPT} prompt tokens, "
            f"{SSM_NEW} new: {r['tok_s']:.1f} tok/s, time to first token "
            f"{r['ttft_s'] * 1e3:.1f} ms, {r['step_s'] * 1e3:.2f} ms per "
            f"decode step (bound {r['step_bound_ms']:.2f} ms: the weights a "
            f"step reads, once, at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s); "
            f"kernel launches "
            f"{r['launches']}")
        log(f"  (a-ssm) f32, {SSM_CHECK_LAYERS[arch]} layers: prefill "
            f"logits max |cuda - torch| / max |torch| {r['a_rel']:.3g}; (g) "
            f"{SSM_PROMPT // 2}-token prefill + {SSM_PROMPT // 2} decode "
            f"steps against a {SSM_PROMPT}-token prefill: last logits "
            f"{r['g_rel']:.3g} (bar {SSM_REL_TOL}); checks "
            f"{r['checks_s']:.1f} s, the config's run {r['s_all']:.1f} s")
        log(f"  device time by kernel group, Engine, {PROFILE_NEW} new "
            f"tokens: {fmt_breakdown(r['profile'])}")

    # -- phase 2g: training the MoE, SSM and hybrid families, counted -------
    # after phase 2f, whose models run_ssm_path has dropped
    t_path = time.perf_counter()
    fam = run_train_families(torch, train_wrappers)
    log(f"phase 2g: training {', '.join(FAMILY_TRAIN)} and their checks in "
        f"{time.perf_counter() - t_path:.2f} s; free on the card before it "
        f"{fam['free_gb']:.2f} GB")
    for arch in FAMILY_TRAIN:
        r = fam[arch]
        for k in ("flash_attention_tiles", *BWD_KERNELS):
            launches[k] += r["launches"][k]
        log(f"{arch} training at {r['layers']} layers ({r['params']} "
            f"parameters; peak memory allocated {r['peak_gb']:.2f} GB) on "
            f"{smi[0]}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
            f"tokens, lr {TRAIN_LR}; kernel launches {r['launches']}")
        for h, dt in zip(r["history"], r["step_s"]):
            log(f"  step {h['step']}: loss {h['loss']:.4f}, grad_norm "
                f"{h['grad_norm']:.4f}, {dt * 1e3:.1f} ms")
        log(f"  {r['tok_s']:.1f} tokens/s over steps 2-{TRAIN_STEPS}; one "
            f"more step: {fmt_breakdown(r['profile'])}")
        log(f"  (d) f32, {FAMILY_CHECK_LAYERS[arch]} layers, gradients cuda "
            f"vs torch plane, max |diff| / max |grad| (bar {D_REL_TOL}): "
            f"worst {max(r['d_rel'].values()):.3g}"
            + (f"; top-k sets agree on {r['d_sets'][0]}/{r['d_sets'][1]} "
               f"(token, call) pairs" if r["d_sets"][1] else ""))
        log(f"  (e) {FAMILY_CHECK_LAYERS[arch]} layers, save at 3, crash at "
            f"5: resumed at step {r['e_resumed_at']}, {r['e_equal']}/"
            f"{r['e_leaves']} parameters bitwise equal to the uninterrupted "
            f"run")
        log(f"  wall time by step: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in r["seconds"].items()))

    # -- phase 2h: the VLM and audio families, counted ----------------------
    # after phase 2g, whose models run_train_families has dropped
    t_path = time.perf_counter()
    front = run_frontend_path(torch, attn_wrappers, train_wrappers)
    log(f"phase 2h: {VLM_ARCH} and {AUDIO_ARCH} serve paths, {AUDIO_ARCH} "
        f"training and their checks in {time.perf_counter() - t_path:.2f} s; "
        f"free on the card before it {front['free_gb']:.2f} GB")
    for arch in (VLM_ARCH, AUDIO_ARCH):
        r = front[arch]
        launches["flash_attention_tiles"] += r["launches"]["tiles"]
        log(f"{arch} at {r['layers']} layers ({r['params']} parameters, "
            f"{r['param_gb']:.2f} GB, init {r['init_s']:.2f} s, peak memory "
            f"allocated {r['peak_gb']:.2f} GB serving, {r['peak_gb_all']:.2f}"
            f" GB with check (a)) on {smi[0]}:")
        log(f"  Engine: {FIXED_BATCH} x ({r['frontend_len']} frontend "
            f"+ {FIXED_PROMPT} prompt tokens), {FIXED_NEW} new: "
            f"{r['tok_s']:.1f} tok/s, time to first token "
            f"{r['ttft_s'] * 1e3:.1f} ms, {r['step_s'] * 1e3:.2f} ms per "
            f"decode step (bound {r['step_bound_ms']:.2f} ms: every weight "
            f"but the embedding read once at {PEAK_BYTES_PER_S / 1e12:.2f} "
            f"TB/s); kernel launches {r['launches']}")
        log(f"  (a) prefill logits cuda vs torch plane: max abs diff "
            f"{r['a_max_abs']:.4g} (logit scale {r['a_scale']:.4g}), argmax "
            f"agreement {r['a_argmax_agree']:.3f}; (a-f32) "
            f"{FRONT_CHECK_LAYERS} layers: max |cuda - torch| / max |torch| "
            f"{r['a32_rel']:.3g}; (g-frontend) {FIXED_PROMPT // 2}-token "
            f"prefill + {FIXED_PROMPT // 2} decode steps against a "
            f"{FIXED_PROMPT}-token prefill, behind the frontend: last logits "
            f"{r['g_rel']:.3g} (bar {FRONT_REL_TOL}); checks "
            f"{r['checks_s']:.1f} s, the config's run {r['s_all']:.1f} s")
        log(f"  device time by kernel group, Engine, {PROFILE_NEW} new "
            f"tokens: {fmt_breakdown(r['profile'])}")
    r = front["train"]
    for k in ("flash_attention_tiles", *BWD_KERNELS):
        launches[k] += r["launches"][k]
    log(f"{AUDIO_ARCH} training at {r['layers']} layers ({r['params']} "
        f"parameters; peak memory allocated {r['peak_gb']:.2f} GB) on "
        f"{smi[0]}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"({front[AUDIO_ARCH]['frontend_len']} frame embeddings + "
        f"{TRAIN_SEQ} tokens), lr {TRAIN_LR}; kernel launches "
        f"{r['launches']}")
    for h, dt in zip(r["history"], r["step_s"]):
        log(f"  step {h['step']}: loss {h['loss']:.4f}, grad_norm "
            f"{h['grad_norm']:.4f}, {dt * 1e3:.1f} ms")
    log(f"  {r['tok_s']:.1f} text tokens/s ({r['pos_s']:.1f} positions/s) "
        f"over steps 2-{TRAIN_STEPS}; one more step: "
        f"{fmt_breakdown(r['profile'])}")
    log(f"  (d) f32, {FRONT_CHECK_LAYERS} layers, gradients cuda vs torch "
        f"plane, max |diff| / max |grad| (bar {D_REL_TOL}): worst "
        f"{max(r['d_rel'].values()):.3g}")
    log(f"  (e) {FRONT_CHECK_LAYERS} layers, save at 3, crash at 5: resumed "
        f"at step {r['e_resumed_at']}, {r['e_equal']}/{r['e_leaves']} "
        f"parameters bitwise equal to the uninterrupted run")
    log(f"  wall time by step: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in r["seconds"].items()))
    vd = front["vlm_d"]["d_rel"]
    log(f"{VLM_ARCH} (d) f32, {FRONT_CHECK_LAYERS} layers, {VLM_GRAD_BATCH} x "
        f"({front[VLM_ARCH]['frontend_len']} + {TRAIN_SEQ}) positions, "
        f"gradients cuda vs torch plane, max |diff| / max |grad| (bar "
        f"{D_REL_TOL}): worst {max(vd.values()):.3g}; wq "
        f"{max(v for k, v in vd.items() if 'wq' in k):.3g}; in "
        f"{front['vlm_d']['s']:.1f} s")
    # -- phase 2i: measured dispatch, counted ------------------------------
    measured_wrappers = {**wrappers, **sparse_wrappers, **attn_wrappers}
    t_path = time.perf_counter()
    md = run_measured_dispatch(torch, measured_wrappers)
    md_s = time.perf_counter() - t_path
    log(f"phase 2i: measured dispatch in {md_s:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in md["seconds"].items())
        + f"); kernel launches {md['launches']}")
    report_measured_dispatch(md, smi[0])
    expect = ("matmul", "spmv_ell", "spmv_dia", "fft_stage", "spmm_ell",
              "spmm_bsr", "spgemm_bsr", "flash_attention_tiles")
    missing = [k for k in expect if md["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on phase 2i's path: "
                             f"{missing}")
    if md_s > 60:
        raise AssertionError(f"phase 2i took {md_s:.1f} s, above 60 s")
    for k, n in md["launches"].items():
        launches[k] += n

    KEYS = ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "kernel_ms")
    out = []
    for name, r in kernels.items():
        src, replaces = routes[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "kernel_ms": r["kernel_ms"],
                    **{k: v for k, v in r.items() if k not in KEYS}})
    log(json.dumps({"kernels": out}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
