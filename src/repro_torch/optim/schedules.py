"""LR schedules as step -> lr callables (port of
`repro/optim/schedules.py`).

The optimizers call `lr(step)` with their int32 `step` tensor, on the
state's device, so each schedule takes a tensor (or a number) and
returns a float32 tensor on the same device, with no host sync.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_f32(step), lr)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(1, warmup_steps)
        prog = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    def fn(step):
        step = _f32(step)
        warm = peak_lr * step / max(1, warmup_steps)
        decay = peak_lr * torch.sqrt(warmup_steps
                                     / torch.clamp_min(step, 1.0))
        return torch.where(step < warmup_steps, warm, decay)
    return fn
