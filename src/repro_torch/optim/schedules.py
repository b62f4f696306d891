"""Learning-rate schedules as step -> lr callables (port of
``repro.optim.schedules``). ``step`` is an integer tensor; the result is
a float32 tensor on its device."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def sched(step):
        return torch.tensor(lr, dtype=torch.float32,
                            device=torch.as_tensor(step).device)
    return sched


def cosine_decay(lr: float, decay_steps: int, final_frac: float = 0.1):
    def sched(step):
        frac = torch.clamp(torch.as_tensor(step).to(torch.float32)
                           / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1.0 - final_frac) * cos)
    return sched


def linear_warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), final_frac)

    def sched(step):
        step = torch.as_tensor(step)
        step_f = step.to(torch.float32)
        warm = lr * step_f / max(warmup_steps, 1)
        return torch.where(step_f < warmup_steps, warm,
                           cos(step - warmup_steps))
    return sched
