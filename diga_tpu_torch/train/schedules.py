"""LR schedules: poly decay and warm-up-then-poly.

Counterpart of ``diga_tpu/train/schedules.py`` (:14-30), reference
util/utils.py:25-48.  The head's 10x multiplier lives in the optimizer's
param groups (``train/optim.py``), not here.  Each schedule maps a step to
a Python float, computed in f32 as the JAX package does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def poly_schedule(base_lr: float, max_iter: int, power: float = 0.9) -> Callable[[int], float]:
    def fn(step: int) -> float:
        frac = np.float32(1.0) - np.float32(step) / np.float32(max_iter)
        return float(np.float32(base_lr) * np.power(np.maximum(frac, np.float32(0.0)),
                                                     np.float32(power)))

    return fn


def poly_warmup_schedule(base_lr: float, max_iter: int, warmup: int = 1000,
                         power: float = 1.0) -> Callable[[int], float]:
    def fn(step: int) -> float:
        s = np.float32(step)
        if s <= warmup:
            return float(np.float32(base_lr) * (s / np.float32(warmup)))
        frac = np.maximum(np.float32(1.0) - (s - np.float32(warmup)) / np.float32(max_iter),
                          np.float32(0.0))
        return float(np.float32(base_lr) * np.power(frac, np.float32(power)))

    return fn
