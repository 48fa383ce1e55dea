"""HRNet + OCR, the plain reference of the benchmark.

A frozen copy written from the published descriptions (HRNet,
arXiv:1908.07919; OCR, arXiv:1909.11065; DiGA's semi-supervised
``model_hr.py``), in plain ``torch.nn`` and NCHW, with no kernel of the
program under test.  Module names follow the reference state_dict
(``hrnet.*``, ``ocrnet.*``), so the benchmark's seeded weights load here
and into the program's model by the same keys.

  * stem: two 3x3/2 conv + BN + ReLU; stage 1: four bottlenecks
  * stages 2-4: BasicBlock branches and exchange units; a lower-resolution
    input passes a 1x1 conv + BN and a bilinear (align_corners) upsample,
    a higher-resolution one a chain of 3x3/2 conv + BN
  * the four branches upsampled to 1/4 scale and concatenated
  * OCR: soft object regions (the aux logits), region representations (a
    softmax over pixels), pixel-region attention scaled by key_channels **
    -0.5, the augmented representation, channel dropout, the classifier
  * every BN is trainable; the two OCR convs before a BN carry a constant
    bias buffer (the reference's default conv bias, a constant here)
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dropout import ChannelDropout


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BufferBiasConv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        del self.bias
        self.register_buffer("bias", torch.zeros(cout))


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, relu: bool = True,
             conv: nn.Conv2d | None = None) -> nn.Sequential:
    if conv is None:
        conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    layers = [conv, _bn(cout)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = None
        if inplanes != planes * 4:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, bias=False),
                                            _bn(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + residual)


def _upsample(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class HRModule(nn.Module):
    def __init__(self, channels: Sequence[int], num_blocks: int):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, c) for _ in range(num_blocks)]) for c in channels)
        n = len(channels)
        self.fuse_layers = nn.ModuleList()
        for i in range(n):
            row = nn.ModuleList()
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(channels[j], channels[i], 1, relu=False))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j], 3,
                                 stride=2, relu=k != i - j - 1)
                        for k in range(i - j)]))
            self.fuse_layers.append(row)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = ys[i]
            for j, layer in enumerate(row):
                if j > i:
                    acc = acc + _upsample(layer(ys[j]), ys[i].shape[-2:])
                elif j < i:
                    acc = acc + layer(ys[j])
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    def __init__(self, arch: dict):
        super().__init__()
        stem = arch["stem_channels"]
        self.conv1 = nn.Conv2d(3, stem, 3, stride=2, padding=1, bias=False)
        self.bn1 = _bn(stem)
        self.conv2 = nn.Conv2d(stem, stem, 3, stride=2, padding=1, bias=False)
        self.bn2 = _bn(stem)
        planes = arch["stage1_channels"]
        self.stage1 = nn.Sequential(*[Bottleneck(stem if b == 0 else planes * 4, planes)
                                      for b in range(arch["stage1_blocks"])])
        prev = [planes * 4]
        self.num_stages = len(arch["stages"])
        for si, (num_modules, num_blocks, channels) in enumerate(arch["stages"], start=2):
            trans = nn.ModuleList()
            for i, ch in enumerate(channels):
                if i < len(prev):
                    trans.append(_conv_bn(prev[i], ch, 3) if prev[i] != ch else None)
                else:
                    chain, cin = [], prev[-1]
                    for j in range(i + 1 - len(prev)):
                        cout = ch if j == i - len(prev) else prev[-1]
                        chain.append(_conv_bn(cin, cout, 3, stride=2))
                        cin = cout
                    trans.append(nn.Sequential(*chain))
            setattr(self, f"transition_stage_{si - 1}_{si}", trans)
            setattr(self, f"stage{si}", nn.ModuleList(
                HRModule(channels, num_blocks) for _ in range(num_modules)))
            prev = list(channels)
        self.out_channels = sum(prev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.stage1(x)]
        for si in range(2, 2 + self.num_stages):
            trans = getattr(self, f"transition_stage_{si - 1}_{si}")
            xs = [(xs[i] if layer is None else layer(xs[i])) if i < len(xs) else layer(xs[-1])
                  for i, layer in enumerate(trans)]
            for module in getattr(self, f"stage{si}"):
                xs = module(xs)
        return torch.cat([xs[0]] + [_upsample(v, xs[0].shape[-2:]) for v in xs[1:]], dim=1)


class OCRHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, mid_channels: int, key_channels: int,
                 droprate: float = 0.05):
        super().__init__()
        self.key_channels = key_channels
        self.pixel_representations = _conv_bn(
            in_channels, mid_channels, 3, conv=BufferBiasConv2d(in_channels, mid_channels, 3))
        self.soft_object_regions = nn.Sequential(
            *_conv_bn(in_channels, in_channels, 1,
                      conv=BufferBiasConv2d(in_channels, in_channels, 1)),
            nn.Conv2d(in_channels, num_classes, 1, bias=True))

        def double_conv1x1():
            return nn.Sequential(*_conv_bn(mid_channels, key_channels, 1),
                                 *_conv_bn(key_channels, key_channels, 1))

        self.pixel_region_relations = nn.ModuleDict(
            {"pixel_rep": double_conv1x1(), "obj_reg_rep": double_conv1x1()})
        self.value = _conv_bn(mid_channels, key_channels, 1)
        self.ocr_up = _conv_bn(key_channels, mid_channels, 1)
        self.augmented_rep = _conv_bn(2 * mid_channels, mid_channels, 1)
        self.dropout = ChannelDropout(droprate)
        self.segmentation_classes = nn.Sequential(
            nn.Conv2d(mid_channels, num_classes, 1, bias=True))

    def context(self, feats: torch.Tensor):
        aux = self.soft_object_regions(feats)
        pix = self.pixel_representations(feats)
        b, c, h, w = pix.shape
        k, kc = aux.shape[1], self.key_channels
        probs = torch.softmax(aux.reshape(b, k, h * w), dim=-1)
        region = torch.bmm(probs, pix.reshape(b, c, h * w).transpose(1, 2))  # (B, K, C)
        region = region.transpose(1, 2)[..., None]  # (B, C, K, 1)
        query = self.pixel_region_relations["pixel_rep"](pix)
        key = self.pixel_region_relations["obj_reg_rep"](region)
        value = self.value(region)
        sim = torch.bmm(query.reshape(b, kc, h * w).transpose(1, 2),
                        key.reshape(b, kc, k)) * (kc ** -0.5)
        ocr = torch.bmm(torch.softmax(sim, dim=-1), value.reshape(b, kc, k).transpose(1, 2))
        ocr = ocr.transpose(1, 2).reshape(b, kc, h, w)
        return aux, self.augmented_rep(torch.cat([self.ocr_up(ocr), pix], dim=1))

    def forward(self, feats: torch.Tensor):
        aux, aug = self.context(feats)
        aug = self.dropout(aug)
        return aux, self.segmentation_classes(aug), aug


class HRNetOCR(nn.Module):
    """(feats, aux, logits, aug), in the four slots of ``DeepLabV2``'s outputs."""

    def __init__(self, num_classes: int, arch: dict, droprate: float = 0.05):
        super().__init__()
        self.hrnet = HRNet(arch)
        self.ocrnet = OCRHead(self.hrnet.out_channels, num_classes, arch["ocr_mid_channels"],
                              arch["ocr_key_channels"], droprate)

    @property
    def channel_dropout(self) -> ChannelDropout:
        return self.ocrnet.dropout

    def set_generator(self, generator: torch.Generator | None) -> None:
        """The channel dropout's: the one draw of a train-mode forward."""
        self.channel_dropout.generator = generator

    def forward(self, x: torch.Tensor):
        feats = self.hrnet(x)
        aux, logits, aug = self.ocrnet(feats)
        return feats, aux, logits, aug

    def stats_forward(self, x: torch.Tensor) -> None:
        """The target-stats forward: every BN, through ``augmented_rep``'s."""
        self.ocrnet.context(self.hrnet(x))

    @staticmethod
    def head_param(name: str) -> bool:
        return False
