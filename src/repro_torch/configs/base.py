"""ModelConfig: the architecture schema of the dense family + registry
(counterpart of ``repro.configs.base``, a copy: the port imports nothing of
the JAX package).

Every field is a static (hashable) property.  Only the fields the dense
family reads are here; the other families' fields (MoE, SSM, hybrid,
frontends, M-RoPE) come with their slices (ROADMAP queue 1 items 5-7).
``dtype`` / ``param_dtype`` keep the JAX package's names;
:attr:`ModelConfig.act_dtype` and :attr:`ModelConfig.pdtype` are the
``torch.dtype`` s.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "register", "get_config", "list_configs", "REGISTRY"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the only family ported yet)
    num_layers: int
    d_model: int
    vocab_size: int

    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # sparse attention pattern (LongFormer/BigBird-shaped archs): a causal
    # sliding window plus optional global-attention token positions, lowered
    # to a MaskSpec and dispatched to the block-sparse tile-skipping kernel
    # when tile density warrants (DESIGN.md §12).  0 / () = plain causal.
    attn_window: int = 0
    attn_global_tokens: tuple[int, ...] = ()

    # MLP
    d_ff: int = 0
    mlp_kind: str = "swiglu"                 # swiglu | geglu

    # embeddings
    tie_embeddings: bool = False
    scale_embeddings: bool = False           # gemma: * sqrt(d_model)

    # dtypes / execution
    dtype: str = "bfloat16"                  # activations
    param_dtype: str = "float32"             # storage
    # recompute each block's activations in the backward
    # (torch.utils.checkpoint around every block of models.transformer.
    # stack_apply); it changes what is kept, never what is computed
    remat: bool = True
    # kept for field parity with the JAX package, where it picks lax.scan
    # over an unrolled layer loop; the port always loops over its list of
    # layers in Python, so it has no effect here
    scan_layers: bool = True
    logit_softcap: float = 0.0

    # continuous-batching serve tier (DESIGN.md §13): KV-cache page size
    # (tokens per page) and the scheduler's admission-queue depth
    serve_page_size: int = 64
    serve_queue_depth: int = 64

    # ------------------------------------------------------------------
    def attn_mask_spec(self):
        """The declarative attention mask of this architecture — a
        :class:`repro_torch.sparse.maskcompiler.MaskSpec` for sparse-attention
        configs (``attn_window`` / ``attn_global_tokens``), None for plain
        causal (the common case keeps the dense row-extent path)."""
        if not self.attn_window and not self.attn_global_tokens:
            return None
        from repro_torch.sparse.maskcompiler import MaskSpec
        return MaskSpec(causal=True,
                        window=self.attn_window or None,
                        global_tokens=self.attn_global_tokens)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 — shardable 16-way and
        MXU-lane aligned (the GPT-NeoX/Megatron convention).  Logits are
        sliced back to ``vocab_size`` so semantics don't change."""
        return -(-self.vocab_size // 256) * 256

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Analytic parameter count of the dense family."""
        d, v = self.d_model, self.vocab_size
        per = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim * d \
            + self.num_heads * self.head_dim * d + 3 * d * self.d_ff
        return v * d * (1 if self.tie_embeddings else 2) \
            + self.num_layers * per


REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import side-effect: populate registry
    import repro_torch.configs  # noqa: F401
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(REGISTRY)
