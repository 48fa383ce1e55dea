"""Per-channel (Σx, Σx²) with f32 accumulation.

Counterpart of ``diga_tpu/ops/stats.py::sums_and_squares`` (:29-40), with
the same arithmetic: the square is taken in the input dtype and both sums
accumulate in f32.  A caller that wants the square in f32 (the GroupNorm
kernel's arithmetic) passes an f32 tensor.  The JAX form's ``mask``
serves its space-to-batch padding, which the port does not have.
"""

from __future__ import annotations

import torch


def sums_and_squares(x: torch.Tensor, dims: tuple[int, ...]):
    """(Σx, Σx²) over ``dims`` with f32 accumulation."""
    s = torch.sum(x, dim=dims, dtype=torch.float32)
    s2 = torch.sum(x * x, dim=dims, dtype=torch.float32)
    return s, s2
