"""VGG19 feature taps for the translator's perceptual loss (torch.nn, NCHW).

Counterpart of ``diga_tpu/models/vgg.py`` (:20-80), reference
util/loss.py:173-203: the five taps after relu1_1, relu2_1, relu3_1,
relu4_1 and relu5_1 of torchvision's ``vgg19().features``, whose module
indices this ``features`` keeps, so a torchvision VGG19 state_dict's
``features.N.*`` keys load with ``strict=True`` (``load_torchvision``).
The layers after relu5_1 hold parameters the taps never read; they are
kept so the torchvision keys load whole.

No weights ship with the repository and nothing is downloaded: the
translator CLI runs the perceptual term only with ``--vgg_weights``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import MEMORY_FORMAT

# torchvision vgg19 "E" plan: conv widths, "P" = 2x2 max pool
_PLAN = (64, 64, "P", 128, 128, "P", 256, 256, 256, 256, "P",
         512, 512, 512, 512, "P", 512, 512, 512, 512, "P")
_TAPS = (1, 6, 11, 20, 29)  # features indices of relu1_1, 2_1, 3_1, 4_1, 5_1


class VGG19Features(nn.Module):
    """``forward(x)`` -> the five relu taps (NCHW)."""

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        c = 3
        for item in _PLAN:
            if item == "P":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c, item, 3, padding=1), nn.ReLU()]
                c = item
        self.features = nn.Sequential(*layers)
        self.to(memory_format=MEMORY_FORMAT)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features[:_TAPS[-1] + 1]):
            x = layer(x)
            if i in _TAPS:
                taps.append(x)
        return taps

    def load_torchvision(self, sd: dict) -> "VGG19Features":
        """Load the ``features.N.*`` entries of a torchvision vgg19 state_dict."""
        self.load_state_dict({k: v for k, v in sd.items() if k.startswith("features.")},
                             strict=True)
        return self


def vgg_perceptual_loss(vgg: VGG19Features, x: torch.Tensor, y: torch.Tensor,
                        weights=(1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0),
                        max_w: int = 1024) -> torch.Tensor:
    """Weighted L1 over the five taps of NCHW ``x`` against the detached
    target ``y``, f32 (util/loss.py:17-25); both halved by a 2x2 average
    pool while the width is over ``max_w`` (util/loss.py:15,19-20)."""
    while x.shape[3] > max_w:
        x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    fx = vgg(x)
    with torch.no_grad():
        fy = vgg(y)
    loss = 0.0
    for w, a, b in zip(weights, fx, fy):
        loss = loss + w * torch.mean(torch.abs(a.to(torch.float32) - b.to(torch.float32)))
    return loss
