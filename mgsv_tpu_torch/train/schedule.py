"""Learning-rate schedules, ported from mgsv_tpu/train/schedule.py.

Each is a function of the update count k (0 for the first update), as torch
LambdaLR stepped after every optimizer step gives them: the warmup
schedules start from lambda(0) = 0, so the first update of a warmup run
changes nothing.  Values are computed in float32, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

f32 = np.float32


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  cycles: float = 0.5) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        count = f32(count)
        if count < warmup_steps:
            return float(f32(base_lr) * (count / f32(max(1.0, warmup_steps))))
        progress = (count - f32(warmup_steps)) / f32(max(1.0, total_steps - warmup_steps))
        cos = np.maximum(f32(0.0), f32(0.5) * (f32(1.0) + np.cos(
            f32(math.pi * cycles * 2.0) * progress, dtype=f32)))
        return float(f32(base_lr) * cos)

    return schedule


def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        count = f32(count)
        if count < warmup_steps:
            return float(f32(base_lr) * (count / f32(max(1.0, warmup_steps))))
        lin = np.maximum(f32(0.0), (f32(total_steps) - count)
                         / f32(max(1.0, total_steps - warmup_steps)))
        return float(f32(base_lr) * lin)

    return schedule


def warmup_constant(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        return float(f32(base_lr) * np.minimum(f32(1.0), f32(count) / f32(max(1.0, warmup_steps))))

    return schedule


def constant(base_lr: float) -> Callable[[int], float]:
    return lambda count: float(f32(base_lr))


def exponential(base_lr: float, gamma: float, update_every: int) -> Callable[[int], float]:
    """torch ExponentialLR stepped every `update_every` updates, gated as
    the reference does: update k runs at base * gamma^ceil(k / r)."""
    def schedule(count: int) -> float:
        fires = np.ceil(f32(count) / f32(max(1, update_every)))
        return float(f32(base_lr) * np.power(f32(gamma), fires, dtype=f32))

    return schedule


def make_schedule(name: str, base_lr: float, warmup_steps: int, total_steps: int,
                  decay_rate: float = 0.9, lr_update_rate: int = 50) -> Callable[[int], float]:
    if name == "warmupcosine":
        return warmup_cosine(base_lr, warmup_steps, total_steps)
    if name == "warmuplinear":
        return warmup_linear(base_lr, warmup_steps, total_steps)
    if name == "warmupconstant":
        return warmup_constant(base_lr, warmup_steps)
    if name == "constant":
        return constant(base_lr)
    if name == "exponential":
        return exponential(base_lr, decay_rate, lr_update_rate)
    raise ValueError(f"unknown scheduler: {name}")
