"""repro_torch — the ArBB reproduction ported to PyTorch and CUDA (Hopper).

A package beside ``repro`` (the JAX/Pallas reference).  It imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.

    core       the DSL: containers, operators, control flow, registry,
               the measured cost model and block cache
    kernels    hand-written CUDA kernels (``kernels/csrc``), their plain
               PyTorch versions and the registered entry points
    numerics   the paper's four Euroben kernels, CG and block-CG
    sparse     the blocked-sparse plane: BSR, statistics, the format
               selector, SpMM and SpGEMM, and the attention mask compiler
    configs    the ten model configurations and the paper's Euroben sizes
    models     the LM: layers, GQA attention, the dense block, the loss
    optim      AdamW, LR schedules, int8 gradient compression
    train      the train state and the train / eval step factories
    data       seeded token streams (synthetic, byte corpus), prefetch
    checkpoint async checkpoints in the JAX package's on-disk layout
    runtime    heartbeats, failure verdicts, the training supervisor
    serve      the fixed and continuous-batching engines, the paged cache
    obs        spans (Chrome traces), counters and histograms, drift of
               the cost model, ``explain``
    launch     command-line entry points (``python -m
               repro_torch.launch.train``, ``... .launch.serve``,
               ``... .launch.calibrate``), meshes and worlds of ranks
    interop    carries the JAX package's objects (as numpy) across
    distributed  the mesh scope (O3/O4): sharding rules, the collective
               plans over ``torch.distributed``, the mesh-scoped numerics
    utils      parameter trees, the roofline (``analyze``), trace
               introspection (collective bytes, device time by kernel)
"""
