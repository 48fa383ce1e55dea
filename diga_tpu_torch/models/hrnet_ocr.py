"""HRNet-W48 backbone + OCR head (torch.nn, channels_last) for the
semi-supervised Cityscapes benchmark.

Counterpart of ``diga_tpu/models/hrnet_ocr.py`` (:41-463), with the module
names of the reference state_dict (semi-supervised_segmentation
model_hr.py SegModel: ``hrnet.*`` + ``ocrnet.*``, the keys
``diga_tpu/models/convert_hrnet.py::hrnet_ocr_to_torch`` emits), so a
reference ``.pth`` loads with ``strict=True``.  Modules are registered in
that converter's order, so ``state_dict()`` lists the backbone's tensors
in it: the ImageNet hrnetv2 init pairs them by position
(``models/convert.py::hrnet_imagenet_state_dict``).

  * stride-4 stem: two 3x3/2 conv + BN + ReLU (``hrnet.conv1/bn1/conv2/bn2``)
  * stage 1: Bottlenecks (``hrnet.stage1.{b}``); stages 2-4: BasicBlock
    branches and exchange units (``hrnet.stage{s}.{m}.branches`` and
    ``.fuse_layers``): a lower-resolution input passes a 1x1 conv + BN and
    a bilinear ``align_corners=True`` upsample in the compute dtype, a
    higher-resolution one a chain of 3x3/2 conv + BN, ReLU on all but the
    last; transitions ``hrnet.transition_stage_{s}_{s+1}``
  * the four branches upsampled to 1/4 scale and concatenated (720
    channels for W48)
  * the OCR head (``ocrnet.*``): soft object regions (the aux logits), the
    region representations (a softmax over the pixel axis), pixel-region
    attention scaled by key_channels ** -0.5, the 512-channel augmented
    representation, channel dropout (0.05) and the classifier.  The region
    softmax, the region representations, the attention and its value
    product run in f32 and are cast back to the compute dtype, as in JAX.
    The ``key`` and ``value`` ConvBNs run on the (B, K) region
    representations as a (B, C, K, 1) image: in train mode their BN
    statistics pool over B·K positions.

Unlike DeepLab, every BN is trainable (``nn.BatchNorm2d``: eps 1e-5,
momentum 0.1 == flax 0.9, unbiased running variance).  The JAX package's
``remat``, ``remat_policy``, ``pad_to`` (``hrnet_pad``) and ``FastConv``
exist for TPU memory and layouts and are not ported (``train/build.py``
refuses them by name).

``forward`` returns (feats, aux, logits, aug) in ``DeepLabV2``'s four
slots; ``bn_stats_forward`` runs everything that updates a BN statistic
(up to and including ``augmented_rep``'s BN, no dropout draw), the
target-stats forward of the warm-up step.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import MEMORY_FORMAT
from .resnet_deeplab import ChannelDropout

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; flax 0.9

# the reference's config_default.yaml (W48) and config_lite (W32):
# stages 2-4 as (num_modules, num_blocks per branch, branch channels)
W48 = {
    "stem_channels": 64,
    "stage1_blocks": 4,
    "stage1_channels": 64,
    "stages": [
        (1, 4, (48, 96)),
        (4, 4, (48, 96, 192)),
        (3, 4, (48, 96, 192, 384)),
    ],
    "ocr_mid_channels": 512,
    "ocr_key_channels": 256,
}
W32 = {
    "stem_channels": 64,
    "stage1_blocks": 4,
    "stage1_channels": 64,
    "stages": [
        (1, 4, (32, 64)),
        (4, 4, (32, 64, 128)),
        (3, 4, (32, 64, 128, 256)),
    ],
    "ocr_mid_channels": 512,
    "ocr_key_channels": 256,
}
ARCHS = {"w48": W48, "w32": W32}


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, relu: bool = True,
             conv: nn.Conv2d | None = None) -> nn.Sequential:
    """conv (no bias) + BN (+ ReLU): keys ``.0`` and ``.1``."""
    if conv is None:
        conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    layers = [conv, _bn(cout)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


class BufferBiasConv2d(nn.Conv2d):
    """A conv whose bias is a constant buffer, not a parameter.

    The reference leaves the default bias on the two OCR convs before a BN
    (ocrnet_module.py:120-122,178-180); the JAX model has none and folds a
    loaded one into the BN's running mean (``convert_hrnet.py:56-61``).  A
    train-mode BN removes it and an eval-mode BN sees it against running
    statistics that tracked it, so as a constant it changes nothing the
    JAX model computes, and the reference keys still load strictly."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        del self.bias
        self.register_buffer("bias", torch.zeros(cout))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual unit (hrnet_module.py:228-262)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False), _bn(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        y += residual
        return self.relu(y)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 residual unit, expansion 4 (hrnet_module.py:265-306)."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if inplanes != planes * 4:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, bias=False),
                                            _bn(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        y += residual
        return self.relu(y)


def _upsample(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear, ``align_corners=True``, in x's dtype (backbone-internal, as
    the JAX model runs it in the compute dtype)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class HRModule(nn.Module):
    """One exchange module: per-branch BasicBlocks, then every branch fused
    into every other (hrnet_module.py:40-226)."""

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
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    v = ys[j]
                elif j > i:
                    v = _upsample(layer(ys[j]), ys[i].shape[-2:])
                else:
                    v = layer(ys[j])
                acc = v if acc is None else acc + v
            fused.append(torch.relu(acc))
        return fused


class HRNet(nn.Module):
    """The 4-stage HRNet; ``forward`` returns the branches' concat at 1/4 scale."""

    def __init__(self, arch: dict = W48):
        super().__init__()
        stem = arch["stem_channels"]
        self.conv1 = nn.Conv2d(3, stem, 3, stride=2, padding=1, bias=False)
        self.bn1 = _bn(stem)
        self.conv2 = nn.Conv2d(stem, stem, 3, stride=2, padding=1, bias=False)
        self.bn2 = _bn(stem)
        self.relu = nn.ReLU(inplace=True)
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
                else:  # a new branch: 3x3/2 chain from the lowest resolution
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
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        xs = [self.stage1(x)]
        for si in range(2, 2 + self.num_stages):
            trans = getattr(self, f"transition_stage_{si - 1}_{si}")
            xs = [(xs[i] if layer is None else layer(xs[i])) if i < len(xs) else layer(xs[-1])
                  for i, layer in enumerate(trans)]
            for module in getattr(self, f"stage{si}"):
                xs = module(xs)
        hw = xs[0].shape[-2:]
        return torch.cat([xs[0]] + [_upsample(v, hw) for v in xs[1:]], dim=1)


class OCRHead(nn.Module):
    """Object-contextual representations (ocrnet_module.py:103-252)."""

    def __init__(self, in_channels: int, num_classes: int, mid_channels: int = 512,
                 key_channels: int = 256, droprate: float = 0.05):
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

    def context(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(aux logits, the augmented representation before its dropout)."""
        aux = self.soft_object_regions(feats)
        pix = self.pixel_representations(feats)
        b, c, h, w = pix.shape
        k, kc = aux.shape[1], self.key_channels
        with torch.autocast(pix.device.type, enabled=False):
            # soft regions: a softmax over the pixel axis, region
            # representations as probability-weighted pixel sums (:408-412)
            probs = torch.softmax(aux.float().reshape(b, k, h * w), dim=-1)
            region = torch.bmm(probs, pix.float().reshape(b, c, h * w).transpose(1, 2))
        region = region.to(pix.dtype).transpose(1, 2)[..., None]  # (B, C, K, 1)
        query = self.pixel_region_relations["pixel_rep"](pix)
        key = self.pixel_region_relations["obj_reg_rep"](region)
        value = self.value(region)
        with torch.autocast(pix.device.type, enabled=False):
            sim = torch.bmm(query.float().reshape(b, kc, h * w).transpose(1, 2),
                            key.float().reshape(b, kc, k)) * (kc ** -0.5)
            attn = torch.softmax(sim, dim=-1)  # over the K regions
            ocr = torch.bmm(attn, value.float().reshape(b, kc, k).transpose(1, 2))
        ocr = ocr.to(pix.dtype).reshape(b, h, w, kc).permute(0, 3, 1, 2)
        aug = self.augmented_rep(torch.cat([self.ocr_up(ocr), pix], dim=1))
        return aux, aug

    def forward(self, feats: torch.Tensor):
        """(aux logits, logits, augmented representation after the dropout)."""
        aux, aug = self.context(feats)
        aug = self.dropout(aug)
        return aux, self.segmentation_classes(aug), aug


class HRNetOCR(nn.Module):
    """SegModel composition (model_hr.py:18-33) returning (feats, aux,
    logits, aug).  ``arch`` is the topology dict itself (``W48``, ``W32``
    or a tiny one in tests)."""

    def __init__(self, num_classes: int = 19, arch: dict = W48, droprate: float = 0.05):
        super().__init__()
        self.hrnet = HRNet(arch)
        self.ocrnet = OCRHead(self.hrnet.out_channels, num_classes, arch["ocr_mid_channels"],
                              arch["ocr_key_channels"], droprate)
        self.to(memory_format=MEMORY_FORMAT)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.hrnet.conv1.weight.dtype

    @property
    def channel_dropout(self) -> ChannelDropout:
        return self.ocrnet.dropout

    def set_compute_dtype(self, dtype: torch.dtype) -> "HRNetOCR":
        """Cast the convs to ``dtype``; BNs keep f32 parameters."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)
        return self

    def bn_stats_forward(self, x: torch.Tensor) -> None:
        """Every BN of a train-mode forward, through ``augmented_rep``'s; no
        dropout draw and no classifier (JAX's full forward there feeds
        nothing, ``diga_tpu/train/steps.py:169-175``)."""
        self.ocrnet.context(self.hrnet(x.to(self.compute_dtype)))

    def forward(self, x: torch.Tensor):
        """``x``: NCHW image batch (channels_last); outputs in the compute dtype."""
        feats = self.hrnet(x.to(self.compute_dtype))
        aux, logits, aug = self.ocrnet(feats)
        return feats, aux, logits, aug
