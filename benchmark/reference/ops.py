"""The step's tensor operations in plain PyTorch, f32, NHWC at the surface.

Frozen copies written from DiGA's training scripts
(``train_DiGA_gta2city_warm_up.py``, ``util/loss.py``) and the published
augmentation stack: the photometric view (colour jitter, grayscale,
gaussian blur, sharpness, applied in unit BGR and blended at ``beta``),
the CrDoMix composite from a class selection, the masked cross entropy,
the symmetric distillation, and the align-corners bilinear resize.  The
draws (per-image factors and gates, class selections) are inputs: the
benchmark makes them and hands the same to the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IGNORE = 255
IMG_MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)
_GRAY_W_BGR = (0.114, 0.587, 0.299)


def resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear, align_corners, of NHWC ``x`` in f32."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc, minc = rgb.amax(-1), rgb.amin(-1)
    rangec = maxc - minc
    s = torch.where(maxc > 0, rangec / maxc.clamp(min=1e-8), torch.zeros_like(maxc))
    safe = rangec.clamp(min=1e-8)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rangec == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    sector = torch.remainder(i, 6.0)
    choices = {"r": (v, q, p, p, t, v), "g": (t, v, v, q, p, p), "b": (p, p, t, v, v, q)}
    out = []
    for c in "rgb":
        val = choices[c][5]
        for j in range(4, -1, -1):
            val = torch.where(sector == j, choices[c][j], val)
        out.append(val)
    return torch.stack(out, dim=-1)


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """3x3 gaussian blur of NHWC ``x``, reflect padding, depthwise."""
    ax = torch.arange(3, dtype=torch.float64) - 1.0
    k = torch.exp(-0.5 * (ax / sigma) ** 2)
    k2 = torch.outer(k / k.sum(), k / k.sum()).to(x.dtype).to(x.device)
    c = x.shape[-1]
    xn = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xn, k2[None, None].expand(c, 1, 3, 3), groups=c).permute(0, 2, 3, 1)


def photometric_view(x_norm: torch.Tensor, draws: dict, beta: float,
                     with_sharpness: bool) -> torch.Tensor:
    """beta * norm(aug(unit(x))) + (1 - beta) * x: the chain in unit BGR."""
    mean = torch.tensor(IMG_MEAN_BGR, dtype=torch.float32, device=x_norm.device) / 255.0
    gray_w = torch.tensor(_GRAY_W_BGR, dtype=torch.float32, device=x_norm.device)
    x = torch.clamp(x_norm * 128.0 / 255.0 + mean, 0.0, 1.0)

    xj = torch.clamp(x * _per_image(draws["brightness"]), 0.0, 1.0)
    mean_gray = (xj * gray_w).sum(-1, keepdim=True).mean(dim=(1, 2), keepdim=True)
    xj = torch.clamp((xj - mean_gray) * _per_image(draws["contrast"]) + mean_gray, 0.0, 1.0)
    gray = (xj * gray_w).sum(-1, keepdim=True)
    xj = torch.clamp(gray + (xj - gray) * _per_image(draws["saturation"]), 0.0, 1.0)
    hsv = _rgb_to_hsv(xj.flip(-1))
    hue = torch.remainder(hsv[..., 0] + draws["hue"].reshape(-1, 1, 1), 1.0)
    xj = _hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1)).flip(-1)
    x = torch.where(_per_image(draws["jitter"]), xj, x)

    gray3 = (x * gray_w).sum(-1, keepdim=True).expand_as(x)
    x = torch.where(_per_image(draws["gray"]), gray3, x)
    x = torch.where(_per_image(draws["blur"]), _blur(x, 2.0), x)
    if with_sharpness:
        smooth = torch.clamp(_blur(x, 1.0), 0.0, 1.0)
        sharp = x + (smooth - x) * _per_image(draws["sharp_factor"])
        x = torch.where(_per_image(draws["sharp"]), sharp, x)
    return beta * ((x - mean) * (255.0 / 128.0)) + (1.0 - beta) * x_norm


def class_mask(labels: torch.Tensor, selected: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) f32: 1 where the pixel's class (ignore = slot C) is selected."""
    ids = torch.where(labels == IGNORE, num_classes, labels.long())
    return torch.gather(selected, 1, ids.reshape(ids.shape[0], -1)).reshape(labels.shape)


def crdomix(translated: torch.Tensor, view: torch.Tensor, labels: torch.Tensor,
            selected: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The translated image outside the selected classes, the view inside."""
    m = class_mask(labels, selected, num_classes)[..., None]
    return translated * (1.0 - m) + view * m


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The NLL of the valid pixels summed over all pixels' count (util/loss.py:48-62)."""
    valid = labels != IGNORE
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / labels.numel()


def distillation(teacher: torch.Tensor, student: torch.Tensor, scale: float) -> torch.Tensor:
    """Teacher clean -> student aug, plus ``scale`` x teacher aug -> student clean."""
    q = torch.softmax(teacher.detach().float(), dim=-1)
    logp = torch.log_softmax(student.float(), dim=-1)
    b = teacher.shape[0] // 2
    return (-(q[:b] * logp[b:]).sum(-1).mean()
            + scale * -(q[b:] * logp[:b]).sum(-1).mean())


def poly_lr(base_lr: float, max_iter: int, power: float, step: int) -> float:
    return base_lr * math.pow(max(1.0 - step / max_iter, 0.0), power)


def ema_alpha(step: int, cap: float) -> float:
    return min(1.0 - 1.0 / (step + 1), cap)
