"""DeepLabV2 on a dilated ResNet, the plain reference of the benchmark.

A frozen copy written from the published description (DeepLab v2,
arXiv:1606.00915; DiGA's ``model/seg_model_noaux.py`` head
``Classifier_Module2``), in plain ``torch.nn`` and NCHW, with no kernel of
the program under test.  Module names follow the reference state_dict, so
the benchmark's seeded weights load into this model and into the
program's model by the same keys.

  * ``layer0``: conv 7x7/2 + BN + ReLU + max pool 3x3/2 (ceil mode)
  * ``layer1..4``: bottlenecks, the stride on the first 1x1 conv; layer3
    and layer4 dilated 2 and 4 (output stride 8)
  * ``final``: five branches (1x1 and 3x3 at dilations 6, 12, 18, 24), each
    conv + GroupNorm(32) + ReLU, concatenated; squeeze-excitation; a 3x3
    conv + GroupNorm; channel dropout; a 1x1 classifier without bias
  * the BN affine is frozen (no gradient); BN normalizes with batch
    statistics in train mode and updates its running statistics
  * ``forward`` returns (shallow, deep, logits, feat); ``backbone_forward``
    runs layer0..layer4 only, every BN a train-mode forward updates
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dropout import ChannelDropout


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation, dilation=dilation, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False), _bn(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + residual)


def _stage(inplanes: int, planes: int, blocks: int, stride: int = 1,
           dilation: int = 1) -> nn.Sequential:
    ds = stride != 1 or inplanes != planes * 4 or dilation in (2, 4)
    layers = [Bottleneck(inplanes, planes, stride, dilation, downsample=ds)]
    layers += [Bottleneck(planes * 4, planes, 1, dilation) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class SEBlock(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.se = nn.Sequential(nn.Linear(channels, channels // reduction), nn.ReLU(),
                                nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.se(x.mean(dim=(2, 3)))[:, :, None, None]


class ASPPHead(nn.Module):
    def __init__(self, inplanes: int, num_classes: int, width: int = 256, groups: int = 32,
                 dilations: Sequence[int] = (6, 12, 18, 24), droprate: float = 0.1):
        super().__init__()
        branches = [nn.Conv2d(inplanes, width, 1)]
        branches += [nn.Conv2d(inplanes, width, 3, padding=d, dilation=d) for d in dilations]
        self.conv2d_list = nn.ModuleList(
            nn.Sequential(conv, nn.GroupNorm(groups, width), nn.ReLU()) for conv in branches)
        cat = width * len(branches)
        self.bottleneck = nn.Sequential(SEBlock(cat), nn.Conv2d(cat, width, 3, padding=1),
                                        nn.GroupNorm(groups, width))
        self.head = nn.Sequential(ChannelDropout(droprate),
                                  nn.Conv2d(width, num_classes, 1, bias=False))

    def forward(self, x: torch.Tensor):
        out = self.bottleneck(torch.cat([branch(x) for branch in self.conv2d_list], dim=1))
        feat = self.head[0](out)
        return feat, self.head[1](feat)


class DeepLabV2(nn.Module):
    def __init__(self, num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                 aspp_width: int = 256, gn_groups: int = 32,
                 aspp_dilations: Sequence[int] = (6, 12, 18, 24), droprate: float = 0.1):
        super().__init__()
        self.layer0 = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), _bn(64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1, ceil_mode=True))
        self.layer1 = _stage(64, 64, layers[0])
        self.layer2 = _stage(256, 128, layers[1], stride=2)
        self.layer3 = _stage(512, 256, layers[2], dilation=2)
        self.layer4 = _stage(1024, 512, layers[3], dilation=4)
        self.final = ASPPHead(2048, num_classes, aspp_width, gn_groups, aspp_dilations, droprate)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.requires_grad_(False)
                m.bias.requires_grad_(False)

    @property
    def channel_dropout(self) -> ChannelDropout:
        return self.final.head[0]

    def set_generator(self, generator: torch.Generator | None) -> None:
        """The channel dropout's: the one draw of a train-mode forward."""
        self.channel_dropout.generator = generator

    def backbone_forward(self, x: torch.Tensor):
        shallow = self.layer2(self.layer1(self.layer0(x)))
        return shallow, self.layer4(self.layer3(shallow))

    def forward(self, x: torch.Tensor):
        shallow, deep = self.backbone_forward(x)
        feat, logits = self.final(deep)
        return shallow, deep, logits, feat

    def stats_forward(self, x: torch.Tensor) -> None:
        """The target-stats forward: every BN statistic of a train-mode forward."""
        self.backbone_forward(x)

    @staticmethod
    def head_param(name: str) -> bool:
        """The ASPP head's parameters take the head's LR multiplier."""
        return name.startswith("final.")
