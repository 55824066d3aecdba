"""ModelConfig: the architecture schema of every family + registry
(counterpart of ``repro.configs.base``, a copy: the port imports nothing of
the JAX package).

Every field is a static (hashable) property.  Families: dense | moe | ssm
| hybrid | vlm | audio (vlm/audio are dense backbones + a stubbed modality
frontend).  ``dtype`` / ``param_dtype`` keep the JAX package's names;
:attr:`ModelConfig.act_dtype` and :attr:`ModelConfig.pdtype` are the
``torch.dtype`` s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ModelConfig", "register", "get_config", "list_configs", "REGISTRY"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int

    # attention (unused for pure-ssm)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    m_rope: bool = False
    mrope_sections: tuple[int, ...] = ()     # splits head_dim/2 across t/h/w
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

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False             # arctic: parallel dense MLP
    capacity_factor: float = 1.25
    # kept for field parity with the JAX package, where it picks the
    # expert-parallel dispatch's sharding constraints over a mesh ("a2a" or
    # "gather"); at chip scope nothing is sharded, so it has no effect here
    moe_dispatch: str = "a2a"

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4

    # hybrid (zamba2): one weight-shared attention block every N ssm layers
    attn_every: int = 0

    # modality frontend stub (vlm/audio): frontend_len positions arrive as
    # precomputed d_model embeddings instead of token ids
    frontend: Optional[str] = None           # None | "vision" | "audio"
    frontend_len: int = 0
    grid_hw: int = 32                        # vlm patch raster width (M-RoPE)

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

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count of every family (the hybrid's shared
        attention block counted once; vlm and audio count as dense: their
        frontends are stubs and hold no parameters)."""
        d, v = self.d_model, self.vocab_size
        attn = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim * d \
            + self.num_heads * self.head_dim * d
        if self.family == "moe":
            moe = self.num_experts * 3 * d * self.moe_d_ff \
                + d * self.num_experts
            dense = 3 * d * self.d_ff if self.dense_residual else 0
            per, shared = attn + moe + dense, 0
        elif self.has_ssm:
            di, g, ns, h = (self.d_inner, self.ssm_groups, self.ssm_state,
                            self.ssm_heads)
            per = d * (2 * di + 2 * g * ns + h) + di * d + h * 2 \
                + (di + 2 * g * ns) * self.conv_width
            shared = attn + 3 * d * self.d_ff \
                if self.family == "hybrid" and self.attn_every else 0
        else:                        # dense, vlm, audio
            per, shared = attn + 3 * d * self.d_ff, 0
        return v * d * (1 if self.tie_embeddings else 2) \
            + self.num_layers * per + shared


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
