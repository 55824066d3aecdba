"""The dispatch settings the environment gives, read once.

Three variables steer measured dispatch:

    REPRO_TORCH_AUTOTUNE        "1", "true" or "measure": an uncached block
                                key is measured on the spot
    REPRO_TORCH_AUTOTUNE_CACHE  the block cache's file
                                (default ``results/torch/autotune.json``)
    REPRO_TORCH_COSTMODEL       the cost model's file
                                (default ``results/torch/costmodel.json``)

They are read when this module is imported and again by :func:`reload`,
the one re-read hook: a program (or a test) that changes one of them
after import calls ``reload()`` for the change to take effect.  No
dispatch reads ``os.environ`` (the attention entry points resolve their
blocks on every call, and a read costs microseconds a call), as the
tracer and the drift detector read their own variables at import
(``obs/trace.py``, ``obs/drift.py``).
"""
from __future__ import annotations

import os

__all__ = ["reload", "AUTOTUNE", "AUTOTUNE_CACHE", "COSTMODEL",
           "DEFAULT_CACHE_PATH", "DEFAULT_MODEL_PATH"]

DEFAULT_CACHE_PATH = os.path.join("results", "torch", "autotune.json")
DEFAULT_MODEL_PATH = os.path.join("results", "torch", "costmodel.json")

#: Whether uncached block keys are measured (``REPRO_TORCH_AUTOTUNE``).
AUTOTUNE: bool = False
#: The block cache's path (``REPRO_TORCH_AUTOTUNE_CACHE``).
AUTOTUNE_CACHE: str = DEFAULT_CACHE_PATH
#: The cost model's path (``REPRO_TORCH_COSTMODEL``).
COSTMODEL: str = DEFAULT_MODEL_PATH


def reload() -> None:
    """Re-read the three variables from ``os.environ``.  The block cache
    and the cost model re-open their files at their next use when a path
    changed."""
    global AUTOTUNE, AUTOTUNE_CACHE, COSTMODEL
    env = os.environ
    AUTOTUNE = env.get("REPRO_TORCH_AUTOTUNE", "") in ("1", "true",
                                                       "measure")
    AUTOTUNE_CACHE = env.get("REPRO_TORCH_AUTOTUNE_CACHE", DEFAULT_CACHE_PATH)
    COSTMODEL = env.get("REPRO_TORCH_COSTMODEL", DEFAULT_MODEL_PATH)


reload()
