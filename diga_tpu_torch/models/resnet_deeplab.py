"""DeepLabV2 with a dilated ResNet-101 backbone (torch.nn, channels_last).

Counterpart of ``diga_tpu/models/resnet_deeplab.py::DeepLabV2`` (:299-410),
with the module names of the reference state_dict (model/model_noaux.py
SegModel over model/seg_model_noaux.py, the keys
``diga_tpu/models/convert.py::segmodel_to_torch`` emits), so a reference
``.pth`` loads with ``strict=True``:

  * ``layer0`` = conv 7x7/2 + BN + ReLU + ceil-mode max pool 3x3/2
    (torch's ``ceil_mode=True`` is the JAX ``max_pool_ceil`` rule, :69-92)
  * ``layer1..4`` bottlenecks with the stride on the 1x1 conv; layer3 and
    layer4 dilated 2 and 4 (output stride 8).  The JAX package's
    space-to-batch and ``FastConv3x3`` are TPU layout work; the eval model
    there runs the dilated form too (``train/build.py:257-258``)
  * BN: ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1 == flax 0.9)
  * ``final`` = the ASPP head Classifier_Module2: 1x1 + d6/12/18/24
    branches, each conv + GroupNorm(32) + ReLU; concat -> SE -> 3x3 conv
    + GroupNorm; channel dropout (0.1) + 1x1 classifier without bias
  * ``forward`` returns (shallow, deep, logits, feat); ``backbone`` runs
    layer0..layer4 only, and is ``bn_stats_forward``: the ASPP head has no
    BN, so the backbone is every BN statistic a train-mode forward updates

Training (reference seg_model_noaux.py:62-76,223-225): the BN affine is
frozen (``requires_grad=False``, left out of the optimizer) while BN keeps
normalizing with batch statistics in train mode and updating its running
statistics (``nn.BatchNorm2d`` stores the unbiased running variance, as
the JAX ``BatchNorm2D`` does).  The head's channel dropout draws its mask
from an explicit ``torch.Generator`` (``ChannelDropout.generator``).

Tensors are NCHW in ``torch.channels_last`` memory format.  Compute dtype:
``set_compute_dtype`` casts convs and linears in place, for a frozen eval
model (the JAX model casts its f32 params to the compute dtype at use);
norms keep f32 parameters, as the JAX model keeps its GroupNorm affine and
BN statistics in f32.  A trained model keeps f32 parameters and computes
in bf16 under ``torch.autocast`` (``train/build.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .. import MEMORY_FORMAT
from ..ops.group_norm import group_norm, group_norm_plain
from ..parallel import dist

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; flax 0.9


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class Bottleneck(nn.Module):
    """ResNet bottleneck, stride on the 1x1 (reference :60-79)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation, dilation=dilation, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                _bn(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        y += residual
        return self.relu(y)


def _stage(inplanes: int, planes: int, blocks: int, stride: int = 1,
           dilation: int = 1) -> nn.Sequential:
    # the first block has a downsample iff stride != 1, a channel change,
    # or dilation 2/4 (reference :246-261)
    ds = stride != 1 or inplanes != planes * 4 or dilation in (2, 4)
    layers = [Bottleneck(inplanes, planes, stride, dilation, downsample=ds)]
    layers += [Bottleneck(planes * 4, planes, 1, dilation) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class FusedGroupNorm(nn.Module):
    """GroupNorm with f32 statistics and x-dtype arithmetic (NCHW in/out).

    Counterpart of the JAX ``FusedGroupNorm`` (:185-234), on the NHWC view
    of the channels_last activation.  Where no gradient is needed (eval,
    the EMA teacher's forward) the work is ``ops.group_norm``, the CUDA
    kernel B2a/B2b on the card.  Under autograd (the student's forward) it
    is the differentiable PyTorch form of the same formula, the
    counterpart of the XLA form the JAX training step keeps
    (``diga_tpu/train/build.py:259-263``); B2 has no backward kernel.
    """

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1)
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or self.weight.requires_grad or self.bias.requires_grad)
        norm = group_norm_plain if needs_grad else group_norm
        return norm(xh, self.weight, self.bias, self.num_groups, self.eps).permute(0, 3, 1, 2)


class ChannelDropout(nn.Module):
    """Dropout2d: zero whole channels with probability ``p`` in train mode,
    scale the kept ones by 1/(1-p) (the JAX ``nn.Dropout`` with
    ``broadcast_dims=(1, 2)``).  The mask comes from ``self.generator``
    (the default generator where it is None).  Under a process group the
    (B, C, 1, 1) mask is drawn at the global batch's shape and the rank
    keeps its rows (``parallel.dist.draw_local``, laid out by the step's
    ``batch_segments``), as one process over the global batch draws it."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = dist.draw_local(lambda n: torch.rand((n, x.shape[1], 1, 1), generator=self.generator,
                                                 device=x.device), x.shape[0])
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class SEBlock(nn.Module):
    """Squeeze-excitation over channels (reference :122-137); mean in f32."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.se = nn.Sequential(
            nn.Linear(channels, channels // reduction), nn.ReLU(inplace=True),
            nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.mean(x, dim=(2, 3), dtype=torch.float32)
        s = self.se(s.to(x.dtype))
        return x * s[:, :, None, None]


class ASPPHead(nn.Module):
    """Classifier_Module2 (reference :140-214); returns (feat_256, logits)."""

    def __init__(self, inplanes: int, num_classes: int,
                 dilations: Sequence[int] = (6, 12, 18, 24), droprate: float = 0.1):
        super().__init__()
        branches = [nn.Conv2d(inplanes, 256, 1, bias=True)]
        branches += [nn.Conv2d(inplanes, 256, 3, padding=d, dilation=d, bias=True)
                     for d in dilations]
        self.conv2d_list = nn.ModuleList(
            nn.Sequential(conv, FusedGroupNorm(256), nn.ReLU(inplace=True)) for conv in branches)
        cat = 256 * len(branches)
        self.bottleneck = nn.Sequential(
            SEBlock(cat), nn.Conv2d(cat, 256, 3, padding=1, bias=True), FusedGroupNorm(256))
        self.head = nn.Sequential(ChannelDropout(droprate),
                                  nn.Conv2d(256, num_classes, 1, bias=False))

    def forward(self, x: torch.Tensor):
        out = torch.cat([branch(x) for branch in self.conv2d_list], dim=1)
        out = self.bottleneck(out)
        feat = self.head[0](out)
        return feat, self.head[1](feat)


class DeepLabV2(nn.Module):
    """ResNet-101 DeepLabV2 returning (shallow, deep, logits, feat)."""

    def __init__(self, num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                 droprate: float = 0.1):
        super().__init__()
        self.layer0 = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), _bn(64),
            nn.ReLU(inplace=True), nn.MaxPool2d(3, stride=2, padding=1, ceil_mode=True))
        self.layer1 = _stage(64, 64, layers[0])
        self.layer2 = _stage(256, 128, layers[1], stride=2)
        self.layer3 = _stage(512, 256, layers[2], dilation=2)
        self.layer4 = _stage(1024, 512, layers[3], dilation=4)
        self.final = ASPPHead(2048, num_classes, droprate=droprate)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):  # frozen affine
                m.weight.requires_grad_(False)
                m.bias.requires_grad_(False)
        self.to(memory_format=MEMORY_FORMAT)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.layer0[0].weight.dtype

    @property
    def channel_dropout(self) -> ChannelDropout:
        return self.final.head[0]

    def set_compute_dtype(self, dtype: torch.dtype) -> "DeepLabV2":
        """Cast convs and linears to ``dtype``; norms keep f32 parameters."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(dtype)
        return self

    def backbone(self, x: torch.Tensor):
        """(shallow, deep): layer0..layer4 without the head."""
        x = self.layer0(x.to(self.compute_dtype))
        shallow = self.layer2(self.layer1(x))
        return shallow, self.layer4(self.layer3(shallow))

    def bn_stats_forward(self, x: torch.Tensor) -> None:
        self.backbone(x)

    def forward(self, x: torch.Tensor):
        """``x``: NCHW image batch (channels_last); outputs in the compute dtype."""
        shallow, deep = self.backbone(x)
        feat, logits = self.final(deep)
        return shallow, deep, logits, feat
