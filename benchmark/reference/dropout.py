"""Channel dropout (Dropout2d) whose mask comes from an explicit generator.

The benchmark seeds the program's dropout generators and the reference's
with the same number, and both draw one (B, C, 1, 1) uniform tensor per
train-mode forward, so both sides drop the same channels.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class ChannelDropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))
