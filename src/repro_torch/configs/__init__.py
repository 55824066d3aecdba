"""Architecture registry of the port: importing this package registers its
configs.  The four dense configs (``qwen3-1.7b``, ``gemma-2b``,
``minicpm-2b``, ``phi3-mini-3.8b``), the two MoE configs
(``qwen3-moe-30b-a3b``, ``arctic-480b``), the SSM config
(``mamba2-370m``) and the hybrid one (``zamba2-7b``) are ported; the VLM
and audio architectures of ``repro.configs`` come with their slice
(ROADMAP queue 1 item 7)."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      REGISTRY)
from repro_torch.configs import (arctic_480b, gemma_2b,  # noqa: F401
                                 mamba2_370m, minicpm_2b, phi3_mini_3p8b,
                                 qwen3_1p7b, qwen3_moe_30b_a3b, zamba2_7b)

__all__ = ["ModelConfig", "get_config", "list_configs", "REGISTRY"]
