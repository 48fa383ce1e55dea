"""Image translator encoder/decoder (torch.nn, NCHW channels_last), forward only.

Counterpart of ``diga_tpu/models/translator.py`` (:25-197), reference
model/model_noaux.py:80-117 over model_util.py Conv2dBlock/ResBlock:
  * ``ImgEncoder``: 7x7 conv (reflect pad, InstanceNorm, ReLU) -> two 4x4/2
    downsamples -> 4 residual blocks; 256 channels at 1/4 resolution
  * ``ImgDecoder``: 4 residual blocks -> two [nearest 2x upsample + 5x5
    reflect conv + IN + ReLU] -> 7x7 conv + tanh

Module names follow the reference keys (``model.0.conv.weight``,
``model.3.model.{r}.model.{j}.conv.weight``, ...;
``diga_tpu/models/convert_translator.py:1-14``), so ``enc_s.pth`` and
``dec_s2t.pth`` load with ``strict=True``.  The warm-up step keeps the
translator frozen.  The decoder's up-blocks are the plain nearest-2x
upsample then the 5x5 conv; the JAX package's default subpixel form is the
same function (``diga_tpu/ops/subpixel.py``), a rewrite not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import MEMORY_FORMAT
from ..ops.stats import sums_and_squares


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) of NCHW ``x``: f32 statistics off the
    input (biased variance, E[x²] − mean²), normalization in x's dtype."""
    n = float(x.shape[2] * x.shape[3])
    s, s2 = sums_and_squares(x, (2, 3))
    mu = (s / n)[:, :, None, None]
    var = torch.clamp((s2 / n)[:, :, None, None] - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (x - mu.to(x.dtype)) * inv.to(x.dtype)


class Conv2dBlock(nn.Module):
    """reflect pad -> conv -> (IN) -> activation (reference model_util.py:121-174)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
                 norm: str = "in", activation: str = "relu"):
        super().__init__()
        self.padding = padding
        self.norm = norm
        self.activation = activation
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding:
            p = self.padding
            x = F.pad(x, (p, p, p, p), mode="reflect")
        x = self.conv(x)
        if self.norm == "in":
            x = instance_norm(x)
        if self.activation == "relu":
            x = F.relu(x)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return x


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
    """reference model_noaux.py:100-117; NCHW features in, NCHW image out."""

    def __init__(self, dim: int = 256, out_ch: int = 3, n_upsample: int = 2, n_res: int = 4):
        super().__init__()
        layers: list[nn.Module] = [ResBlocks(n_res, dim)]
        for _ in range(n_upsample):
            layers += [nn.Upsample(scale_factor=2, mode="nearest"),
                       Conv2dBlock(dim, dim // 2, 5, 1, 2)]
            dim //= 2
        layers.append(Conv2dBlock(dim, out_ch, 7, 1, 3, norm="none", activation="tanh"))
        self.model = nn.Sequential(*layers)
        self.to(memory_format=MEMORY_FORMAT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def translate(frozen: nn.ModuleDict, img: torch.Tensor) -> torch.Tensor:
    """dec_s2t(enc_s(img)) of an NHWC image batch, as NHWC (the JAX
    package's ``translator_apply``, ``diga_tpu/train/build.py:111-124``)."""
    z = frozen["enc_s"](img.permute(0, 3, 1, 2))
    return frozen["dec_s2t"](z).permute(0, 2, 3, 1)
