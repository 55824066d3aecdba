"""repro_torch — the ArBB reproduction ported to PyTorch and CUDA (Hopper).

A package beside ``repro`` (the JAX/Pallas reference).  It imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.

    core       the DSL: containers, operators, control flow, registry
    kernels    hand-written CUDA kernels (``kernels/csrc``), their plain
               PyTorch versions and the registered entry points
    numerics   the paper's four Euroben kernels, CG and block-CG
    sparse     the blocked-sparse plane: BSR, statistics, the format
               selector, SpMM and SpGEMM, and the attention mask compiler
    configs    model configurations (qwen3-1.7b so far)
    models     the LM: layers, GQA attention, the dense block
    serve      the fixed and continuous-batching engines, the paged cache
    launch     command-line entry points (``python -m
               repro_torch.launch.serve``)
    interop    carries the JAX package's objects (as numpy) across
"""
