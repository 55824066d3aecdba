"""repro_torch.serve — the serving engines (counterpart of ``repro.serve``).

    Engine              fixed-slot batched generation (prefill + decode)
    ContinuousEngine    continuous batching over a paged KV cache
    Scheduler, Request  admission and page accounting
    make_spec, init_cache_state, PagedCacheSpec   the paged cache
"""
from repro_torch.serve.engine import (ContinuousEngine, Engine,
                                      SamplingParams, ServeStats,
                                      sample_token)
from repro_torch.serve.kvcache import (PagedCacheSpec, init_cache_state,
                                       make_spec)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["Engine", "ContinuousEngine", "SamplingParams", "ServeStats",
           "sample_token", "PagedCacheSpec", "make_spec", "init_cache_state",
           "Request", "Scheduler"]
