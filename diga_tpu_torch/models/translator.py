"""Image domain translator: encoder, decoder and PatchGAN discriminator
(torch.nn, NCHW channels_last).

Counterpart of ``diga_tpu/models/translator.py`` (:25-246), reference
model/model_noaux.py:80-147 over model_util.py Conv2dBlock/ResBlock:
  * ``ImgEncoder``: 7x7 conv (reflect pad, InstanceNorm, ReLU) -> two 4x4/2
    downsamples -> 4 residual blocks; 256 channels at 1/4 resolution
  * ``ImgDecoder``: 4 residual blocks -> two [nearest 2x upsample + 5x5
    reflect conv + IN + ReLU] -> 7x7 conv + tanh.  ``subpixel_up`` runs each
    up-block as the subpixel rewrite of the same function
    (``ops/subpixel.py``); both forms hold the same parameters under the
    same keys
  * ``Discriminator``: 3 scales (``AvgPool2d(3, 2, padding=1,
    count_include_pad=False)`` between them) of 4 zero-padded, bias-free
    4x4/2 convs with LeakyReLU 0.2 and a 1x1 score head

Module names follow the reference keys (``model.0.conv.weight``,
``model.3.model.{r}.model.{j}.conv.weight``, ``cnns.{s}.{j}.conv.weight``,
``cnns.{s}.{n_layer}.weight``; ``diga_tpu/models/convert_translator.py``),
so the reference ``.pth`` files load with ``strict=True``.  The modules
train (the translator stage, ``train/steps_translator.py``) and run frozen
in the warm-up and self-training steps.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import MEMORY_FORMAT
from ..ops.stats import sums_and_squares
from ..ops.subpixel import nearest_up2_conv5x5
from ..utils.profiling import span as scope


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) of NCHW ``x``: f32 statistics off the
    input (biased variance, E[x²] − mean²), normalization in x's dtype."""
    n = float(x.shape[2] * x.shape[3])
    s, s2 = sums_and_squares(x, (2, 3))
    mu = (s / n)[:, :, None, None]
    var = torch.clamp((s2 / n)[:, :, None, None] - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (x - mu.to(x.dtype)) * inv.to(x.dtype)


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return F.relu(x)
    if activation == "lrelu":
        return F.leaky_relu(x, 0.2)
    if activation == "tanh":
        return torch.tanh(x)
    return x


class Conv2dBlock(nn.Module):
    """pad -> conv -> (IN) -> activation (reference model_util.py:121-174);
    ``pad_type`` 'reflect' or 'zero', ``activation`` 'relu', 'lrelu',
    'tanh' or 'none'."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
                 norm: str = "in", activation: str = "relu", pad_type: str = "reflect",
                 use_bias: bool = True):
        super().__init__()
        self.padding = padding
        self.pad_mode = "reflect" if pad_type == "reflect" else "constant"
        self.norm = norm
        self.activation = activation
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding:
            p = self.padding
            x = F.pad(x, (p, p, p, p), mode=self.pad_mode)
        x = self.conv(x)
        if self.norm == "in":
            x = instance_norm(x)
        return _activate(x, self.activation)


class SubpixelUpBlock(nn.Module):
    """Nearest 2x upsample + 5x5 reflect conv + IN + ReLU in the subpixel
    form (``diga_tpu/models/translator.py:136-169``): the parameters of
    ``Conv2dBlock(in_ch, out_ch, 5, 1, 2)``, under the same ``conv`` name."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 5, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(instance_norm(nearest_up2_conv5x5(x, self.conv.weight, self.conv.bias)))


class ResBlock(nn.Module):
    """Two 3x3 IN conv blocks + skip (reference model_util.py:48-61)."""

    def __init__(self, dim: int):
        super().__init__()
        self.model = nn.Sequential(Conv2dBlock(dim, dim, 3, 1, 1, "in", "relu"),
                                   Conv2dBlock(dim, dim, 3, 1, 1, "in", "none"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.model(x)


class ResBlocks(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.model = nn.Sequential(*[ResBlock(dim) for _ in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class ImgEncoder(nn.Module):
    """reference model_noaux.py:80-96; NCHW image in, NCHW features out."""

    def __init__(self, dim: int = 64, n_downsample: int = 2, n_res: int = 4):
        super().__init__()
        layers = [Conv2dBlock(3, dim, 7, 1, 3)]
        for _ in range(n_downsample):
            layers.append(Conv2dBlock(dim, 2 * dim, 4, 2, 1))
            dim *= 2
        layers.append(ResBlocks(n_res, dim))
        self.model = nn.Sequential(*layers)
        self.to(memory_format=MEMORY_FORMAT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class ImgDecoder(nn.Module):
    """reference model_noaux.py:100-117; NCHW features in, NCHW image out.

    Layout ``[ResBlocks, (upsample, up-conv) x n_upsample, out conv]``: the
    parameter-free upsample keeps its slot ``model.{1+2i}`` in both forms
    (``nn.Identity`` in the subpixel form, whose up-conv does the upsample),
    so the up-convs stay ``model.{2+2i}.conv.*``."""

    def __init__(self, dim: int = 256, out_ch: int = 3, n_upsample: int = 2, n_res: int = 4,
                 subpixel_up: bool = False):
        super().__init__()
        layers: list[nn.Module] = [ResBlocks(n_res, dim)]
        for _ in range(n_upsample):
            if subpixel_up:
                layers += [nn.Identity(), SubpixelUpBlock(dim, dim // 2)]
            else:
                layers += [nn.Upsample(scale_factor=2, mode="nearest"),
                           Conv2dBlock(dim, dim // 2, 5, 1, 2)]
            dim //= 2
        layers.append(Conv2dBlock(dim, out_ch, 7, 1, 3, norm="none", activation="tanh"))
        self.model = nn.Sequential(*layers)
        self.to(memory_format=MEMORY_FORMAT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``AvgPool2d(3, stride=2, padding=[1, 1],
    count_include_pad=False)`` between discriminator scales."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


class Discriminator(nn.Module):
    """Multi-scale PatchGAN with the LSGAN objective (reference
    model_noaux.py:119-147); NCHW image in, one NCHW score map per scale
    out.  ``cnns.{s}`` = [Conv2dBlock x n_layer, 1x1 conv]; RGB in."""

    def __init__(self, dim: int = 64, n_layer: int = 4, num_scales: int = 3):
        super().__init__()
        self.num_scales, self.n_layer = num_scales, n_layer
        self.cnns = nn.ModuleList()
        for _ in range(num_scales):
            d = dim
            layers = [Conv2dBlock(3, d, 4, 2, 1, norm="none", activation="lrelu",
                                  pad_type="zero", use_bias=False)]
            for _ in range(n_layer - 1):
                layers.append(Conv2dBlock(d, 2 * d, 4, 2, 1, norm="none", activation="lrelu",
                                          pad_type="zero", use_bias=False))
                d *= 2
            layers.append(nn.Conv2d(d, 1, 1))
            self.cnns.append(nn.Sequential(*layers))
        self.to(memory_format=MEMORY_FORMAT)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outputs = []
        for s, cnn in enumerate(self.cnns):
            hw = list(x.shape[2:])
            for _ in range(self.n_layer):  # 4x4/2 convs, pad 1: JAX's VALID size, 0 if empty
                hw = [max((n + 2 - 4) // 2 + 1, 0) for n in hw]
            if 0 in hw:
                raise ValueError(
                    f"Discriminator scale {s} output is empty {(x.shape[0], 1, *hw)}: the "
                    f"input crop is too small for num_scales={self.num_scales}/"
                    f"n_layer={self.n_layer} (the LSGAN mean over an empty map is nan). Use "
                    "a larger crop or shrink the discriminator.")
            outputs.append(cnn(x))
            x = avg_pool_3x3s2(x)
        return outputs


def translate(frozen: nn.ModuleDict, img: torch.Tensor) -> torch.Tensor:
    """dec_s2t(enc_s(img)) of an NHWC image batch, as NHWC (the JAX
    package's ``translator_apply``, ``diga_tpu/train/build.py:111-124``);
    each module runs in a profiler scope named after its class."""
    enc, dec = frozen["enc_s"], frozen["dec_s2t"]
    with scope(type(enc).__name__):
        z = enc(img.permute(0, 3, 1, 2))
    with scope(type(dec).__name__):
        return dec(z).permute(0, 2, 3, 1)
