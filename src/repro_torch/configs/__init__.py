"""Architecture registry of the port: importing this package registers its
configs.  The dense ``qwen3-1.7b`` is ported; the other architectures of
``repro.configs`` come with their families' slices (ROADMAP queue 1
item 7)."""
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      REGISTRY)
from repro_torch.configs import qwen3_1p7b  # noqa: F401

__all__ = ["ModelConfig", "get_config", "list_configs", "REGISTRY"]
