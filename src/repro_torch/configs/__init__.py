"""Architecture registry of the port: importing this package registers its
configs.  The four dense configs (``qwen3-1.7b``, ``gemma-2b``,
``minicpm-2b``, ``phi3-mini-3.8b``) are ported; the other architectures of
``repro.configs`` come with their families' slices (ROADMAP queue 1 items
5-7)."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      REGISTRY)
from repro_torch.configs import (gemma_2b, minicpm_2b,  # noqa: F401
                                 phi3_mini_3p8b, qwen3_1p7b)

__all__ = ["ModelConfig", "get_config", "list_configs", "REGISTRY"]
