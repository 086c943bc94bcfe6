"""Learning-rate schedules: functions of the step (a 0-dim int tensor)
returning a 0-dim f32 tensor on the step's device, as in
``repro.optim.schedules``. They branch with ``torch.where``, never on the
host, so a step on the card stays free of host syncs."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def constant(lr: float):
    def sched(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr, dtype=F32, device=step.device)

    return sched


def warmup_linear(lr: float, warmup_steps: int, total_steps: int,
                  end: float = 0.0):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        warm = lr * step / max(warmup_steps, 1)
        frac = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0,
        )
        decay = lr + (end - lr) * frac
        return torch.where(step < warmup_steps, warm, decay)

    return sched


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  end: float = 0.0):
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        warm = lr * step / max(warmup_steps, 1)
        frac = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0,
        )
        decay = end + 0.5 * (lr - end) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, decay)

    return sched


def exponential_decay(lr: float, decay_rate: float, decay_steps: float,
                      staircase: bool = True):
    """The paper's ImageNet schedule shape: decay by 0.97 every 2.4 epochs."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        e = step.to(F32) / decay_steps
        if staircase:
            e = torch.floor(e)
        return lr * torch.pow(torch.full_like(e, decay_rate), e)

    return sched


def warmup_exponential(lr: float, warmup_steps: int, decay_rate: float,
                       decay_steps: float):
    """Linear warmup then staircase exponential decay (MNasNet/paper §4.3)."""
    expo = exponential_decay(lr, decay_rate, decay_steps)

    def sched(step: torch.Tensor) -> torch.Tensor:
        stepf = step.to(F32)
        warm = lr * stepf / max(warmup_steps, 1)
        return torch.where(stepf < warmup_steps, warm,
                           expo(step - warmup_steps))

    return sched
