"""SegFormer's Mix Transformer (MiT) backbone with DAFormer's context-aware
fusion head (torch.nn, token-major blocks, channels_last maps).

SegFormer, arXiv:2105.15203 (``mix_transformer.py``, ``mit_b5``); DAFormer,
arXiv:2111.14887 (``daformer_head.py``, config ``daformer_sepaspp_mitb5``).
Modules carry mmseg's names (``backbone.*``, ``decode_head.*``, mmcv's
``ConvModule`` ``conv``/``bn``), so the optimizer's rules
(``train/optim.py::adamw_grouped``: the head's LR x10, no decay on the
backbone's norms) read the published parameter names:

  * four stages; stage i embeds its input with an overlapping patch
    embedding (7x7/4, then 3x3/2; conv + LayerNorm, ``patch_embed{i}``),
    runs ``depths[i]`` pre-norm blocks (``block{i}.{j}``) on the
    (B, H*W, C) tokens and ends in a LayerNorm (``norm{i}``);
  * block: ``x += dp(attn(norm1(x)))``, ``x += dp(mlp(norm2(x)))``.
    Attention: q = Wq x; where the stage's ``sr`` > 1 the keys and values
    come from a stride-sr sr x sr conv of the map, a LayerNorm and Wkv;
    ``softmax(q k^T / sqrt(d)) v`` by ``F.scaled_dot_product_attention``,
    then Wo.  Mix-FFN: fc1 (C -> 4C), a depthwise 3x3 conv with bias,
    GELU, fc2;
  * stochastic depth ``dp`` at rate ``linspace(0, drop_path_rate,
    sum(depths))[j]`` for block j: a block of rate 0 draws nothing;
  * LayerNorm eps 1e-6 in the blocks and at the stages' ends, PyTorch's
    1e-5 in the patch embeddings and the key/value reductions, as
    published;
  * the head: each stage's map embedded to ``channels`` by a linear layer
    (``embed_layers.{i}.proj``), the deeper three resized bilinearly
    (align_corners False) to stage 1's grid, concatenated in stage order;
    the depthwise-separable ASPP without image pool (``fuse_layer``):
    dilation 1 a 1x1 conv + BN + ReLU, each other dilation a depthwise
    3x3 + BN + ReLU then a 1x1 conv + BN + ReLU; concatenated, a 3x3
    conv + BN + ReLU (``bottleneck``); channel dropout (0.1) and a 1x1
    classifier (``conv_seg``).  Convs before a BN have no bias.

Random draws.  Every draw of a train-mode forward comes from one
generator, the head dropout's (``ChannelDropout.generator``, set by the
train state as for the other models), in this order: for each block in
depth order with a rate above 0, one (B, 1, 1) uniform for the attention
branch, then one for the Mix-FFN branch (keep where u < 1 - rate, the
kept rows scaled by 1 / (1 - rate)); then the head dropout's (B, C, 1, 1)
uniform.  ``bn_stats_forward`` draws the blocks' and not the head's.

Attention runs on the card's fused kernels only (flash or memory
efficient): where neither takes the call PyTorch raises rather than fall
back to the math path, which would hold the (B, h, N, M) scores.  The CPU
runs the math path.

``forward`` returns (stage 1 map, stage 4 map, logits, the classifier's
input after the dropout) in ``DeepLabV2``'s four slots; logits at 1/4 of
the input.  ``bn_stats_forward`` runs everything that updates a BN
statistic: the backbone (its draws included) and the head through its
bottleneck, with no dropout draw and no classifier.  Spans: one
``patch_embed`` per stage, one ``mit_attn`` and one ``mix_ffn`` per block,
one ``daformer_head``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from .. import MEMORY_FORMAT
from ..parallel import dist
from ..utils.profiling import span
from .resnet_deeplab import ChannelDropout

LN_EPS = 1e-6

# SegFormer's mit_b5 with DAFormer's head (daformer_sepaspp_mitb5)
B5 = {
    "embed_dims": (64, 128, 320, 512),
    "num_heads": (1, 2, 5, 8),
    "depths": (3, 6, 40, 3),
    "sr_ratios": (8, 4, 2, 1),
    "mlp_ratio": 4,
    "drop_path_rate": 0.1,
    "head_channels": 256,
    "aspp_dilations": (1, 6, 12, 18),
}
ARCHS = {"b5": B5}


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C): a view of a channels_last map."""
    return x.flatten(2).transpose(1, 2)


def _image(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W): a channels_last view of contiguous tokens."""
    b, _, c = x.shape
    return x.transpose(1, 2).reshape(b, c, *hw)


def _attention_backends(x: torch.Tensor):
    if x.is_cuda:
        return sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION])
    return sdpa_kernel([SDPBackend.MATH])


def _drop_path(y: torch.Tensor, rate: float, generator, training: bool) -> torch.Tensor:
    """Stochastic depth: each sample's branch kept with probability 1 - rate."""
    if not training or rate == 0.0:
        return y
    keep = 1.0 - rate
    u = dist.draw_local(lambda n: torch.rand((n, 1, 1), generator=generator, device=y.device),
                        y.shape[0])
    return torch.where(u < keep, y / keep, torch.zeros_like(y))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, k: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, k, stride=stride, padding=k // 2)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        return self.norm(_tokens(x)), tuple(x.shape[2:])


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        q = self.q(x).view(b, n, h, c // h).transpose(1, 2)
        m = self.norm(_tokens(self.sr(_image(x, hw)))) if self.sr_ratio > 1 else x
        k, v = self.kv(m).view(b, -1, 2, h, c // h).permute(2, 0, 3, 1, 4)
        with _attention_backends(x):
            o = F.scaled_dot_product_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        return _tokens(self.dwconv(_image(x, hw)))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), hw)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, sr_ratio: int,
                 drop_path: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MixFFN(dim, dim * mlp_ratio)
        self.drop_path = drop_path

    def forward(self, x: torch.Tensor, hw: tuple[int, int], generator) -> torch.Tensor:
        with span("mit_attn"):
            x = x + _drop_path(self.attn(self.norm1(x), hw), self.drop_path, generator,
                               self.training)
        with span("mix_ffn"):
            return x + _drop_path(self.mlp(self.norm2(x), hw), self.drop_path, generator,
                                  self.training)


class MixVisionTransformer(nn.Module):
    def __init__(self, arch: dict):
        super().__init__()
        dims, depths = arch["embed_dims"], arch["depths"]
        rates = torch.linspace(0, arch["drop_path_rate"], sum(depths), device="cpu").tolist()
        cur = 0
        for i, (dim, heads, depth, sr) in enumerate(zip(dims, arch["num_heads"], depths,
                                                         arch["sr_ratios"]), start=1):
            k, stride = (7, 4) if i == 1 else (3, 2)
            self.add_module(f"patch_embed{i}",
                            OverlapPatchEmbed(3 if i == 1 else dims[i - 2], dim, k, stride))
            self.add_module(f"block{i}", nn.ModuleList(
                Block(dim, heads, arch["mlp_ratio"], sr, rates[cur + j]) for j in range(depth)))
            self.add_module(f"norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
            cur += depth
        self.num_stages = len(dims)

    def forward(self, x: torch.Tensor, generator) -> list[torch.Tensor]:
        """The four stages' maps, (B, C_i, H_i, W_i) channels_last."""
        outs = []
        for i in range(1, self.num_stages + 1):
            with span("patch_embed"):
                x, hw = getattr(self, f"patch_embed{i}")(x)
            for blk in getattr(self, f"block{i}"):
                x = blk(x, hw, generator)
            x = _image(getattr(self, f"norm{i}")(x), hw)
            outs.append(x)
        return outs


class ConvModule(nn.Sequential):
    """mmcv's ConvModule with BN and ReLU: ``conv`` (no bias), ``bn``."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=dilation * (k // 2), dilation=dilation,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)
        self.activate = nn.ReLU(inplace=True)


class DepthwiseSeparableConvModule(nn.Sequential):
    def __init__(self, cin: int, cout: int, dilation: int):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, 3, dilation=dilation, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)


class SepASPP(nn.Module):
    """DAFormer's ``ASPPWrapper`` with ``sep=True``, ``pool=False``."""

    def __init__(self, cin: int, channels: int, dilations):
        super().__init__()
        self.aspp_modules = nn.ModuleList(
            ConvModule(cin, channels, 1) if d == 1
            else DepthwiseSeparableConvModule(cin, channels, d) for d in dilations)
        self.bottleneck = ConvModule(len(dilations) * channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bottleneck(torch.cat([m(x) for m in self.aspp_modules], dim=1))


class MLPEmbed(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _image(self.proj(_tokens(x)), tuple(x.shape[2:]))


class DAFormerHead(nn.Module):
    def __init__(self, in_dims, channels: int, num_classes: int, dilations, droprate: float):
        super().__init__()
        self.embed_layers = nn.ModuleDict(
            {str(i): MLPEmbed(c, channels) for i, c in enumerate(in_dims)})
        self.fuse_layer = SepASPP(len(in_dims) * channels, channels, dilations)
        self.dropout = ChannelDropout(droprate)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def fuse(self, feats: list[torch.Tensor]) -> torch.Tensor:
        size = tuple(feats[0].shape[2:])
        embedded = []
        for i, f in enumerate(feats):
            e = self.embed_layers[str(i)](f)
            if tuple(e.shape[2:]) != size:
                e = F.interpolate(e, size=size, mode="bilinear", align_corners=False)
            embedded.append(e)
        return self.fuse_layer(torch.cat(embedded, dim=1))

    def forward(self, feats: list[torch.Tensor]):
        feat = self.dropout(self.fuse(feats))
        return self.conv_seg(feat), feat


class MiTDAFormer(nn.Module):
    """The MiT backbone and DAFormer head returning (stage 1 map, stage 4
    map, logits, feat).  ``arch``: ``B5`` or a dict of its keys (a tiny one
    in tests)."""

    def __init__(self, num_classes: int = 19, arch: dict = B5, droprate: float = 0.1):
        super().__init__()
        self.backbone = MixVisionTransformer(arch)
        self.decode_head = DAFormerHead(arch["embed_dims"], arch["head_channels"], num_classes,
                                        arch["aspp_dilations"], droprate)
        self.to(memory_format=MEMORY_FORMAT)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.backbone.patch_embed1.proj.weight.dtype

    @property
    def channel_dropout(self) -> ChannelDropout:
        """The holder of the model's one generator (module docstring)."""
        return self.decode_head.dropout

    def set_compute_dtype(self, dtype: torch.dtype) -> "MiTDAFormer":
        """Cast convs and linears to ``dtype``; norms keep f32 parameters."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(dtype)
        return self

    def bn_stats_forward(self, x: torch.Tensor) -> None:
        feats = self.backbone(x.to(self.compute_dtype), self.channel_dropout.generator)
        with span("daformer_head"):
            self.decode_head.fuse(feats)

    def forward(self, x: torch.Tensor):
        """``x``: NCHW image batch (channels_last); outputs in the compute dtype."""
        feats = self.backbone(x.to(self.compute_dtype), self.channel_dropout.generator)
        with span("daformer_head"):
            logits, feat = self.decode_head(feats)
        return feats[0], feats[-1], logits, feat

