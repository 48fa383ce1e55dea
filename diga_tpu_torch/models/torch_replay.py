"""Functional replay of the reference DeepLabV2 forward, the parity oracle.

The port's own copy of ``diga_tpu/models/torch_replay.py::
segmodel_forward_torch`` (:16-81), for ``cli/parity_check.py``: it
evaluates the reference architecture's math directly from a reference
``student.pth`` state_dict with ``torch.nn.functional`` ops (``F.conv2d``,
``F.batch_norm``, ``F.group_norm``, contiguous NCHW), so it shares no
module, layout or kernel with the port's ``DeepLabV2``.  Architecture:
seg_model_noaux.py (Bottleneck :57, ResNetMulti :216, Classifier_Module2
:140, SEBlock :122) composed as model_noaux.py SegModel :10-46.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def segmodel_forward_torch(sd: dict, x_nchw: torch.Tensor, layers=(3, 4, 23, 3),
                           num_classes: int = 19, training: bool = False):
    """(logits, feat), NCHW, of the reference SegModel on ``x_nchw``.

    ``training=True`` replays the reference's train-mode BN: normalize with
    batch statistics and update the ``running_*`` tensors of ``sd`` in
    place with momentum 0.1 (``sd`` values must then be tensors).
    ``num_classes`` is read from the classifier's weight; the argument
    keeps the reference signature.
    """

    def t(key):
        v = sd[key]
        return v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))

    def conv(key, v, stride=1, pad=0, dil=1, bias=False):
        b = t(key + ".bias") if bias and key + ".bias" in sd else None
        return F.conv2d(v, t(key + ".weight"), b, stride=stride, padding=pad, dilation=dil)

    def bn(key, v):
        return F.batch_norm(v, t(key + ".running_mean"), t(key + ".running_var"),
                            t(key + ".weight"), t(key + ".bias"),
                            training=training, momentum=0.1, eps=1e-5)

    def gn(key, v, groups=32):
        return F.group_norm(v, groups, t(key + ".weight"), t(key + ".bias"), eps=1e-5)

    def bottleneck(prefix, v, stride, dil):
        res = v
        y = F.relu(bn(prefix + ".bn1", conv(prefix + ".conv1", v, stride=stride)))
        y = F.relu(bn(prefix + ".bn2", conv(prefix + ".conv2", y, pad=dil, dil=dil)))
        y = bn(prefix + ".bn3", conv(prefix + ".conv3", y))
        if prefix + ".downsample.0.weight" in sd:
            res = bn(prefix + ".downsample.1", conv(prefix + ".downsample.0", v, stride=stride))
        return F.relu(y + res)

    v = F.relu(bn("layer0.1", conv("layer0.0", x_nchw, stride=2, pad=3)))
    v = F.max_pool2d(v, 3, 2, 1, ceil_mode=True)
    stage_cfg = [(1, 1), (2, 1), (1, 2), (1, 4)]  # (stride, dilation) per stage
    for li, n_blocks in enumerate(layers, start=1):
        stride, dil = stage_cfg[li - 1]
        for b in range(n_blocks):
            v = bottleneck(f"layer{li}.{b}", v, stride if b == 0 else 1, dil)

    # ASPP head (Classifier_Module2)
    branches = [F.relu(gn("final.conv2d_list.0.1", conv("final.conv2d_list.0.0", v, bias=True)))]
    for j, d in enumerate((6, 12, 18, 24), start=1):
        branches.append(F.relu(gn(f"final.conv2d_list.{j}.1",
                                  conv(f"final.conv2d_list.{j}.0", v, pad=d, dil=d, bias=True))))
    out = torch.cat(branches, dim=1)
    # SE block
    s = out.mean(dim=(2, 3))
    s = F.relu(F.linear(s, t("final.bottleneck.0.se.0.weight"), t("final.bottleneck.0.se.0.bias")))
    s = torch.sigmoid(F.linear(s, t("final.bottleneck.0.se.2.weight"),
                               t("final.bottleneck.0.se.2.bias")))
    out = out * s[:, :, None, None]
    out = gn("final.bottleneck.2", conv("final.bottleneck.1", out, pad=1, bias=True))
    feat = out  # dropout inactive at eval
    logits = conv("final.head.1", feat)
    return logits, feat
