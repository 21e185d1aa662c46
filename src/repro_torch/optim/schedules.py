"""Learning-rate schedules: plain functions of the step counter, returning a
Python float (the twins of the JAX package's ``optim/schedules.py``)."""
from __future__ import annotations

import math


def _progress(step: float, warmup_steps: int, total_steps: int) -> float:
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    return min(max(prog, 0.0), 1.0)


def warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, end_frac: float = 0.1) -> float:
    step = float(step)
    if step < warmup_steps:
        return base_lr * step / max(warmup_steps, 1)
    prog = _progress(step, warmup_steps, total_steps)
    return base_lr * (end_frac + (1 - end_frac) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def warmup_linear(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, end_frac: float = 0.0) -> float:
    step = float(step)
    if step < warmup_steps:
        return base_lr * step / max(warmup_steps, 1)
    prog = _progress(step, warmup_steps, total_steps)
    return base_lr * (1.0 - (1.0 - end_frac) * prog)


def constant(step, *, base_lr: float, **_) -> float:
    return float(base_lr)


SCHEDULES = {"warmup_cosine": warmup_cosine, "warmup_linear": warmup_linear,
             "constant": constant}
