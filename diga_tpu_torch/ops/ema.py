"""EMA teacher update over the model parameters.

Counterpart of ``diga_tpu/ops/ema.py`` (:18-31), reference
util/utils.py:93-116: alpha ramps as min(1 - 1/(step+1), cap), cap 0.999,
in both the warm-up and the self-training stage.  The update covers the
module's **parameters only** (the frozen BN affine included, as the
reference's ``.parameters()`` loop does); BN running statistics are
buffers and move only through the teacher's own train-mode forward.
"""

from __future__ import annotations

import numpy as np
import torch


def ema_alpha(step: int, cap: float = 0.999) -> float:
    """min(1 - 1/(step + 1), cap), computed in f32 as the JAX package does."""
    a = np.float32(1.0) - np.float32(1.0) / (np.float32(step) + np.float32(1.0))
    return float(min(a, np.float32(cap)))


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, alpha: float) -> None:
    """teacher <- alpha·teacher + (1 - alpha)·student, in place, in f32."""
    t_params = list(teacher.parameters())
    s_params = list(student.parameters())
    if len(t_params) != len(s_params):
        raise ValueError("ema_update: teacher and student have different parameter lists")
    torch._foreach_mul_(t_params, alpha)
    torch._foreach_add_(t_params, s_params, alpha=float(np.float32(1.0) - np.float32(alpha)))
