"""Architecture registry of the port: importing this package registers its
configs, the ten model configs of ``repro.configs``: the dense
``qwen3-1.7b``, ``gemma-2b``, ``minicpm-2b`` and ``phi3-mini-3.8b``, the
VLM ``qwen2-vl-72b``, the audio ``musicgen-medium``, the MoE
``qwen3-moe-30b-a3b`` and ``arctic-480b``, the SSM ``mamba2-370m`` and the
hybrid ``zamba2-7b``."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      REGISTRY)
from repro_torch.configs import (arctic_480b, gemma_2b,  # noqa: F401
                                 mamba2_370m, minicpm_2b, musicgen_medium,
                                 phi3_mini_3p8b, qwen2_vl_72b, qwen3_1p7b,
                                 qwen3_moe_30b_a3b, zamba2_7b)

__all__ = ["ModelConfig", "get_config", "list_configs", "REGISTRY"]
