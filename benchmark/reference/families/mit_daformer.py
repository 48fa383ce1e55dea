"""``model: mit_daformer``: SegFormer's MiT backbone with DAFormer's fusion head.

SegFormer, arXiv:2105.15203 (``mix_transformer.py``); DAFormer,
arXiv:2111.14887 (``daformer_head.py``, ``daformer_sepaspp_mitb5``), with
mmseg's parameter names (``backbone.*``, ``decode_head.*``), which the
optimizer's rules read.  Plain PyTorch in f32 and NCHW; attention written
out as a matmul, a softmax and a matmul; it runs under
``lowp.precision_scope``, which turns TF32 off.

Keys of the configuration file: ``num_classes``; ``mit``: ``embed_dims``,
``num_heads``, ``depths``, ``sr_ratios``, ``mlp_ratio``,
``drop_path_rate``, ``layer_norm_eps`` (the blocks' and the stages' ends)
and ``embed_norm_eps`` (the patch embeddings' and the key/value
reductions'); ``head``: ``channels``, ``aspp_dilations``, ``dropout``.

The model, as published:
  * stage i: an overlapping patch embedding (7x7/4 for the first, 3x3/2
    after; conv with bias, LayerNorm), ``depths[i]`` pre-norm blocks on
    the (B, N, C) tokens, a LayerNorm;
  * block: x += dp(attn(norm1(x))); x += dp(mlp(norm2(x))).  attn: q =
    Wq x; keys and values from Wkv of the tokens, or where ``sr`` > 1 of
    a stride-sr sr x sr conv of the map and a LayerNorm; softmax(q k^T /
    sqrt(d)) v; Wo.  mlp: fc1 (C -> 4C), depthwise 3x3 conv with bias,
    GELU (erf), fc2;
  * stochastic depth dp at rate linspace(0, drop_path_rate, 52)[j] for
    block j;
  * head: a linear embedding of each stage to ``channels``, the deeper
    three resized bilinearly (align_corners False) to stage 1's grid,
    concatenated; the depthwise-separable ASPP (1x1 conv + BN + ReLU;
    per other dilation a depthwise 3x3 + BN + ReLU, a 1x1 conv + BN +
    ReLU); concatenated; a 3x3 conv + BN + ReLU; Dropout2d; a 1x1
    classifier.  Convs before a BN have no bias.

Departures, the same on the program's side: stochastic depth keeps a
sample where a uniform draw u < 1 - rate (timm's floor(1 - rate + u)
keeps it where u >= rate: the same law, another draw); every draw of a
train-mode forward comes from the one generator ``set_generator`` hands
it, in this order: each block of rate above 0 in depth order, one (B, 1,
1) uniform for the attention branch then one for the Mix-FFN branch;
then the head's Dropout2d, one (B, C, 1, 1) uniform.  ``stats_forward``
draws the blocks' and not the head's (it stops at the ASPP bottleneck,
the last BN).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..dropout import ChannelDropout


def _tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def _image(x: torch.Tensor, hw) -> torch.Tensor:
    b, _, c = x.shape
    return x.transpose(1, 2).reshape(b, c, *hw)


def _drop_path(y: torch.Tensor, rate: float, generator, training: bool) -> torch.Tensor:
    if not training or rate == 0.0:
        return y
    keep = 1.0 - rate
    u = torch.rand((y.shape[0], 1, 1), generator=generator, device=y.device)
    return torch.where(u < keep, y / keep, torch.zeros_like(y))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, k: int, stride: int, eps: float):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, k, stride=stride, padding=k // 2)
        self.norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(_tokens(x)), tuple(x.shape[2:])


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, eps: float):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.scale = (dim // num_heads) ** -0.5
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x, hw):
        b, n, c = x.shape
        h = self.num_heads
        q = self.q(x).reshape(b, n, h, c // h).permute(0, 2, 1, 3)
        m = self.norm(_tokens(self.sr(_image(x, hw)))) if self.sr_ratio > 1 else x
        kv = self.kv(m).reshape(b, -1, 2, h, c // h).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * self.scale, dim=-1)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(o)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, hw):
        return _tokens(self.dwconv(_image(x, hw)))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, hw):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), hw)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, sr_ratio, drop_path, eps, embed_eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, sr_ratio, embed_eps)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.drop_path = drop_path

    def forward(self, x, hw, generator):
        x = x + _drop_path(self.attn(self.norm1(x), hw), self.drop_path, generator, self.training)
        return x + _drop_path(self.mlp(self.norm2(x), hw), self.drop_path, generator,
                              self.training)


class MixVisionTransformer(nn.Module):
    def __init__(self, mit: dict):
        super().__init__()
        dims, depths = mit["embed_dims"], mit["depths"]
        eps, embed_eps = mit["layer_norm_eps"], mit["embed_norm_eps"]
        rates = torch.linspace(0, mit["drop_path_rate"], sum(depths), device="cpu").tolist()
        cur = 0
        for i in range(len(dims)):
            k, stride = (7, 4) if i == 0 else (3, 2)
            cin = 3 if i == 0 else dims[i - 1]
            setattr(self, f"patch_embed{i + 1}",
                    OverlapPatchEmbed(cin, dims[i], k, stride, embed_eps))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(dims[i], mit["num_heads"][i], mit["mlp_ratio"], mit["sr_ratios"][i],
                      rates[cur + j], eps, embed_eps) for j in range(depths[i])))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(dims[i], eps=eps))
            cur += depths[i]
        self.num_stages = len(dims)

    def forward(self, x, generator):
        outs = []
        for i in range(1, self.num_stages + 1):
            x, hw = getattr(self, f"patch_embed{i}")(x)
            for blk in getattr(self, f"block{i}"):
                x = blk(x, hw, generator)
            x = _image(getattr(self, f"norm{i}")(x), hw)
            outs.append(x)
        return outs


class ConvModule(nn.Sequential):
    def __init__(self, cin, cout, k, dilation=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=dilation * (k // 2), dilation=dilation,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)
        self.activate = nn.ReLU()


class DepthwiseSeparableConvModule(nn.Sequential):
    def __init__(self, cin, cout, dilation):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, 3, dilation=dilation, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)


class ASPPWrapper(nn.Module):
    def __init__(self, cin, channels, dilations):
        super().__init__()
        self.aspp_modules = nn.ModuleList(
            ConvModule(cin, channels, 1) if d == 1
            else DepthwiseSeparableConvModule(cin, channels, d) for d in dilations)
        self.bottleneck = ConvModule(len(dilations) * channels, channels, 3)

    def forward(self, x):
        return self.bottleneck(torch.cat([m(x) for m in self.aspp_modules], dim=1))


class MLP(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = nn.Linear(cin, cout)

    def forward(self, x):
        return _image(self.proj(_tokens(x)), tuple(x.shape[2:]))


class DAFormerHead(nn.Module):
    def __init__(self, in_dims, head: dict, num_classes: int):
        super().__init__()
        c = head["channels"]
        self.embed_layers = nn.ModuleDict({str(i): MLP(d, c) for i, d in enumerate(in_dims)})
        self.fuse_layer = ASPPWrapper(len(in_dims) * c, c, head["aspp_dilations"])
        self.dropout = ChannelDropout(head["dropout"])
        self.conv_seg = nn.Conv2d(c, num_classes, 1)

    def fuse(self, feats):
        size = tuple(feats[0].shape[2:])
        out = []
        for i, f in enumerate(feats):
            e = self.embed_layers[str(i)](f)
            if tuple(e.shape[2:]) != size:
                e = F.interpolate(e, size=size, mode="bilinear", align_corners=False)
            out.append(e)
        return self.fuse_layer(torch.cat(out, dim=1))


class MiTDAFormer(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.backbone = MixVisionTransformer(config["mit"])
        self.decode_head = DAFormerHead(config["mit"]["embed_dims"], config["head"],
                                        config["num_classes"])
        self.generator: torch.Generator | None = None

    def set_generator(self, generator: torch.Generator | None) -> None:
        self.generator = generator
        self.decode_head.dropout.generator = generator

    @staticmethod
    def head_param(name: str) -> bool:
        return name.startswith("decode_head.")

    def forward(self, x):
        feats = self.backbone(x, self.generator)
        feat = self.decode_head.dropout(self.decode_head.fuse(feats))
        return feats[0], feats[-1], self.decode_head.conv_seg(feat), feat

    def stats_forward(self, x) -> None:
        self.decode_head.fuse(self.backbone(x, self.generator))


def build(config: dict) -> MiTDAFormer:
    return MiTDAFormer(config)
