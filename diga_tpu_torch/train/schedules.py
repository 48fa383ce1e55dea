"""LR schedules: poly decay, DiGA's warm-up-then-poly, and mmcv's linear
warm-up over poly (DAFormer's).

``poly_schedule`` and ``poly_warmup_schedule`` are the counterparts of
``diga_tpu/train/schedules.py`` (:14-30), reference util/utils.py:25-48.
The head's 10x multiplier lives in the optimizer's param groups
(``train/optim.py``), not here.  Each schedule maps a step to
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


def poly_linear_warmup_schedule(base_lr: float, max_iter: int, warmup: int, ratio: float,
                                power: float = 1.0) -> Callable[[int], float]:
    """mmcv's ``PolyLrUpdaterHook`` with ``warmup='linear'`` (DAFormer's
    ``poly10warm``): the poly decay of every step, times 1 - (1 - k /
    warmup)(1 - ratio) while k < warmup.  The factor is computed as ratio
    + (k / warmup)(1 - ratio), the same number without the cancellation
    of 1 - (1 - 1e-6) in f32."""
    poly = poly_schedule(base_lr, max_iter, power)

    def fn(step: int) -> float:
        if step >= warmup:
            return poly(step)
        r = np.float32(ratio)
        factor = r + (np.float32(step) / np.float32(warmup)) * (np.float32(1.0) - r)
        return float(np.float32(poly(step)) * factor)

    return fn
