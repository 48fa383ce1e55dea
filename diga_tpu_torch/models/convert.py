"""Weights across the two packages, in the reference state_dict layout.

``state_dict_from_jax`` is the port's own copy of the
``diga_tpu/models/convert.py::segmodel_to_torch`` mapping (:114-154): it
turns the JAX package's DeepLabV2 parameters and batch statistics, as
nested dicts of numpy arrays, into a state_dict with the reference keys,
which ``DeepLabV2.load_state_dict(..., strict=True)`` takes.  The BN
``num_batches_tracked`` counters are not part of the reference layout;
``nn.BatchNorm2d`` fills them in when a state_dict without them loads.

Layout rules:
  conv   flax kernel (kh, kw, I, O) -> torch (O, I, kh, kw)
  linear flax kernel (I, O)         -> torch (O, I)
  BN     scale/bias (params), mean/var (batch_stats) ->
         weight/bias/running_mean/running_var
  GN     scale/bias -> weight/bias
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def state_dict_from_jax(params: dict, batch_stats: dict,
                        layers=(3, 4, 23, 3)) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}

    def put_conv(key, node):
        sd[key + ".weight"] = _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in node:
            sd[key + ".bias"] = _tensor(node["bias"])

    def put_linear(key, node):
        sd[key + ".weight"] = _tensor(np.asarray(node["kernel"]).transpose(1, 0))
        sd[key + ".bias"] = _tensor(node["bias"])

    def put_bn(key, pnode, snode):
        sd[key + ".weight"] = _tensor(pnode["frozen_bn"]["scale"])
        sd[key + ".bias"] = _tensor(pnode["frozen_bn"]["bias"])
        sd[key + ".running_mean"] = _tensor(snode["frozen_bn"]["mean"])
        sd[key + ".running_var"] = _tensor(snode["frozen_bn"]["var"])

    def put_gn(key, node):
        sd[key + ".weight"] = _tensor(node["scale"])
        sd[key + ".bias"] = _tensor(node["bias"])

    put_conv("layer0.0", params["conv1"])
    put_bn("layer0.1", params["bn1"], batch_stats["bn1"])
    for li, n_blocks in enumerate(layers, start=1):
        for bi in range(n_blocks):
            p = params[f"layer{li}"][f"block{bi}"]
            s = batch_stats[f"layer{li}"][f"block{bi}"]
            for ci in (1, 2, 3):
                put_conv(f"layer{li}.{bi}.conv{ci}", p[f"conv{ci}"])
                put_bn(f"layer{li}.{bi}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
            if "downsample_conv" in p:
                put_conv(f"layer{li}.{bi}.downsample.0", p["downsample_conv"])
                put_bn(f"layer{li}.{bi}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    h = params["head"]
    for j in range(5):
        put_conv(f"final.conv2d_list.{j}.0", h[f"branch{j}_conv"])
        put_gn(f"final.conv2d_list.{j}.1", h[f"branch{j}_gn"])
    put_linear("final.bottleneck.0.se.0", h["se"]["fc1"])
    put_linear("final.bottleneck.0.se.2", h["se"]["fc2"])
    put_conv("final.bottleneck.1", h["bottleneck_conv"])
    put_gn("final.bottleneck.2", h["bottleneck_gn"])
    put_conv("final.head.1", h["classifier"])
    return sd


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` as a flat dict of CPU tensors.

    Counterpart of ``diga_tpu/models/convert.py::load_torch_state_dict``
    (:42-52): unwraps a saved module and a ``{"state_dict": ...}`` wrapper
    (SimCLRv2/ProDA-style checkpoints, reference seg_model_noaux.py:339).
    """
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v) for k, v in sd.items()}
