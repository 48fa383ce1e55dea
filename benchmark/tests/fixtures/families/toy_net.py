"""``model: toy_net``, a test fixture: a family that the harness has never
seen, found by name like any other (``test_bench_adding.py``).

A strided conv + BN stem, one residual conv + BN block under stochastic
depth, a 1x1 head.  Two random draws a train-mode forward, both from the
generator that ``set_generator`` hands it, in this order: the block's
stochastic depth (one uniform a sample), then the head's channel dropout
(one uniform a sample and channel).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ToyNet(nn.Module):
    def __init__(self, num_classes: int, width: int, drop_path: float, dropout: float):
        super().__init__()
        self.stem = nn.Conv2d(3, width, 3, stride=2, padding=1, bias=False)
        self.stem_bn = nn.BatchNorm2d(width)
        self.block = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.block_bn = nn.BatchNorm2d(width)
        self.head = nn.Conv2d(width, num_classes, 1)
        self.drop_path, self.dropout = drop_path, dropout
        self.generator: torch.Generator | None = None

    def set_generator(self, generator: torch.Generator | None) -> None:
        self.generator = generator

    def _draw(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=device)

    def _trunk(self, x: torch.Tensor):
        shallow = F.relu(self.stem_bn(self.stem(x)))
        return shallow, self.block_bn(self.block(shallow))

    def forward(self, x: torch.Tensor):
        shallow, y = self._trunk(x)
        if self.training:
            keep = 1.0 - self.drop_path
            y = y * (self._draw((y.shape[0], 1, 1, 1), y.device) < keep) / keep
        deep = F.relu(shallow + y)
        feat = deep
        if self.training:
            keep = 1.0 - self.dropout
            feat = feat * (self._draw((*feat.shape[:2], 1, 1), feat.device) < keep) / keep
        return shallow, deep, self.head(feat), deep

    def stats_forward(self, x: torch.Tensor) -> None:
        self._trunk(x)

    @staticmethod
    def head_param(name: str) -> bool:
        return name.startswith("head.")


def build(config: dict) -> ToyNet:
    return ToyNet(config["num_classes"], config["width"], config["drop_path"],
                  config["dropout"])


def weight_rule(key: str, shape: tuple):
    """The residual branch's BN scale small, as a ResNet's last BN of a block."""
    if key == "block_bn.weight":
        return "uniform", 0.1, 0.3
    return None
