"""The frozen image translator (encoder + decoder), the plain reference.

A frozen copy written from DiGA's ``model/model_noaux.py`` (ImgEncoder,
ImgDecoder over ``model_util.py`` Conv2dBlock/ResBlock), in plain
``torch.nn`` and NCHW.  The decoder's up-blocks are the published form, a
nearest 2x upsample and a 5x5 reflect-padded conv, not the program's
subpixel rewrite of it; the keys are the same.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2dBlock(nn.Module):
    """pad -> conv -> (InstanceNorm) -> activation."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
                 norm: bool = True, activation: str = "relu"):
        super().__init__()
        self.padding, self.norm, self.activation = padding, norm, activation
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.padding
        if p:
            x = F.pad(x, (p, p, p, p), mode="reflect")
        x = self.conv(x)
        if self.norm:
            x = F.instance_norm(x, eps=1e-5)
        if self.activation == "relu":
            return F.relu(x)
        if self.activation == "tanh":
            return torch.tanh(x)
        return x


class ResBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.model = nn.Sequential(Conv2dBlock(dim, dim, 3, 1, 1),
                                   Conv2dBlock(dim, dim, 3, 1, 1, activation="none"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.model(x)


class ResBlocks(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.model = nn.Sequential(*[ResBlock(dim) for _ in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class ImgEncoder(nn.Module):
    def __init__(self, dim: int = 64, n_downsample: int = 2, n_res: int = 4):
        super().__init__()
        layers = [Conv2dBlock(3, dim, 7, 1, 3)]
        for _ in range(n_downsample):
            layers.append(Conv2dBlock(dim, 2 * dim, 4, 2, 1))
            dim *= 2
        layers.append(ResBlocks(n_res, dim))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class ImgDecoder(nn.Module):
    def __init__(self, dim: int = 256, out_ch: int = 3, n_upsample: int = 2, n_res: int = 4):
        super().__init__()
        layers: list[nn.Module] = [ResBlocks(n_res, dim)]
        for _ in range(n_upsample):
            layers += [nn.Upsample(scale_factor=2, mode="nearest"),
                       Conv2dBlock(dim, dim // 2, 5, 1, 2)]
            dim //= 2
        layers.append(Conv2dBlock(dim, out_ch, 7, 1, 3, norm=False, activation="tanh"))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class Translator(nn.Module):
    """enc_s -> dec_s2t on an NCHW image batch."""

    def __init__(self, enc_dim: int = 64, dec_dim: int = 256, n_downsample: int = 2,
                 n_res: int = 4):
        super().__init__()
        self.enc_s = ImgEncoder(enc_dim, n_downsample, n_res)
        self.dec_s2t = ImgDecoder(dec_dim, 3, n_downsample, n_res)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dec_s2t(self.enc_s(x))
