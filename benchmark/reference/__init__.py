"""The benchmark's plain reference: frozen copies of the architectures and
of the step and evaluation, in plain PyTorch.  Nothing here imports JAX,
the JAX package or the program under test."""

from __future__ import annotations

import torch.nn as nn

from .deeplab import DeepLabV2
from .hrnet_ocr import HRNetOCR
from .translator import Translator


def build_model(config: dict) -> nn.Module:
    """The configuration file's segmentation model, f32, on the CPU."""
    kind = config["model"]
    if kind == "deeplabv2":
        return DeepLabV2(config["num_classes"], tuple(config["layers"]), config["aspp_width"],
                         config["gn_groups"], tuple(config["aspp_dilations"]),
                         config["dropout"])
    if kind == "hrnet_ocr":
        arch = dict(config["hrnet"])
        arch["stages"] = [(m, b, tuple(c)) for m, b, c in arch["stages"]]
        return HRNetOCR(config["num_classes"], arch, config["dropout"])
    raise ValueError(f"model {kind!r}: expected 'deeplabv2' or 'hrnet_ocr'")


def build_translator(config: dict) -> nn.Module | None:
    t = config.get("translator")
    if t is None:
        return None
    return Translator(t["enc_dim"], t["dec_dim"], t["n_downsample"], t["n_res"])
