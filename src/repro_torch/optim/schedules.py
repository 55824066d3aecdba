"""LR schedules: WSD (minicpm's Warmup-Stable-Decay), cosine, linear
(counterpart of ``repro.optim.schedules``).

Pure ``step -> lr`` functions; ``step`` is a Python number or a tensor, and
the result is an f32 0-d tensor (on the step's device when it is one).
"""
from __future__ import annotations

import math

import torch

__all__ = ["wsd", "cosine", "constant", "linear_warmup"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def f(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), lr, dtype=torch.float32, device=dev)
    return f


def linear_warmup(lr: float, warmup: int):
    def f(step):
        frac = torch.clamp(_f32(step) / max(warmup, 1), max=1.0)
        return (lr * frac).to(torch.float32)
    return f


def wsd(peak_lr: float, total_steps: int, *, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, floor: float = 0.1):
    """Warmup-Stable-Decay (minicpm, arXiv:2404.06395).

    Linear warmup -> flat plateau -> exponential decay to floor*peak over the
    final ``decay_frac`` of training.  The plateau is what lets minicpm resume
    and branch runs (continual pretraining) — which is also why the
    checkpoint/restart logic stores the step: restarting mid-plateau is
    schedule-exact.
    """
    warmup = max(1, int(total_steps * warmup_frac))
    decay_start = int(total_steps * (1.0 - decay_frac))

    def f(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / warmup, max=1.0)
        decay_t = torch.clamp((step - decay_start)
                              / max(total_steps - decay_start, 1), 0.0, 1.0)
        decay = peak_lr * torch.pow(torch.tensor(floor, dtype=torch.float32,
                                                 device=step.device),
                                    decay_t)
        return torch.where(step < decay_start, warm, decay).to(torch.float32)

    return f


def cosine(peak_lr: float, total_steps: int, *, warmup_frac: float = 0.01,
           floor: float = 0.1):
    warmup = max(1, int(total_steps * warmup_frac))

    def f(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / warmup, max=1.0)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos).to(
            torch.float32)

    return f
