"""On-device photometric augmentation, the ``diga`` chain.

Counterpart of ``diga_tpu/ops/photometric.py`` (:36-168, :258-285).  The
reference builds kornia Sequential(ColorJitter(b=.4, c=.4, s=.2, h=.1,
p=.5), RandomGrayscale(p=.3), RandomGaussianBlur(3x3, sigma=2, p=.8),
RandomSharpness(.5, p=.3)) and blends ``beta*norm(aug(x)) + (1-beta)*x``
(train_DiGA_gta2city_warm_up.py:105-111,233).  The ``diga`` variant, the
JAX package's default, de-normalizes to unit BGR, augments there and
re-normalizes (its documented deviation).  The ``kornia`` variant
(:171-255) is not ported yet.

Draws are split from their application: ``draw(generator, b)`` returns the
per-image factors and gates from an explicit ``torch.Generator``, and
``photometric_chain`` / ``diga_photometric`` apply them, so a test can
inject the JAX package's draws.  Images are NHWC, as at the JAX package's functions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..data.normalize import IMG_MEAN_BGR

_GRAY_W_BGR = (0.114, 0.587, 0.299)  # luma weights in BGR channel order


def _mean(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(IMG_MEAN_BGR / 255.0, dtype=x.dtype, device=x.device)


def _gray_w(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_GRAY_W_BGR, dtype=x.dtype, device=x.device)


def to_unit(x_norm: torch.Tensor) -> torch.Tensor:
    """model space (BGR, (x - mean)/128) -> unit BGR [~0, 1]."""
    return (x_norm * 128.0 / 255.0) + _mean(x_norm)


def to_model(x_unit: torch.Tensor) -> torch.Tensor:
    return (x_unit - _mean(x_unit)) * (255.0 / 128.0)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.amax(rgb, dim=-1)
    minc = torch.amin(rgb, dim=-1)
    v = maxc
    rangec = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, rangec / torch.clamp(maxc, min=1e-8), zero)
    safe_range = torch.clamp(rangec, min=1e-8)
    rc = (maxc - r) / safe_range
    gc = (maxc - g) / safe_range
    bc = (maxc - b) / safe_range
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(rangec == 0, zero, h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for j in range(4, -1, -1):
            out = torch.where(i == j, vals[j], out)
        return out

    r = select(v, q, p, p, t, v)
    g = select(t, v, v, q, p, p)
    b = select(p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


def _gauss_kernel(ksize: int, sigma: float) -> np.ndarray:
    ax = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _gauss_kernel_2d(ksize: int, sigma: float) -> np.ndarray:
    k = _gauss_kernel(ksize, sigma)
    return np.outer(k, k)


def gaussian_blur(x: torch.Tensor, ksize: int = 3, sigma: float = 2.0) -> torch.Tensor:
    """Depthwise gaussian blur of NHWC ``x`` with reflect padding."""
    c = x.shape[-1]
    k2 = torch.from_numpy(_gauss_kernel_2d(ksize, sigma)).to(device=x.device, dtype=x.dtype)
    weight = k2[None, None].expand(c, 1, ksize, ksize)
    pad = ksize // 2
    xn = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(xn, weight, groups=c).permute(0, 2, 3, 1)


def draw(generator: torch.Generator, b: int, p_jitter: float = 0.5) -> dict[str, torch.Tensor]:
    """Per-image gates (bool) and factors (f32) of one ``photometric_chain``,
    each of shape (b,), drawn from ``generator`` on its device: ColorJitter
    (b=.4, c=.4, s=.2, h=.1, p=``p_jitter``), RandomGrayscale(p=.3),
    RandomGaussianBlur(p=.8), RandomSharpness(.5, p=.3)."""

    def uniform(lo, hi):
        return torch.rand(b, generator=generator, device=generator.device) * (hi - lo) + lo

    def gate(p):
        return torch.rand(b, generator=generator, device=generator.device) < p

    return {
        "jitter": gate(p_jitter),
        "brightness": uniform(0.6, 1.4),
        "contrast": uniform(0.6, 1.4),
        "saturation": uniform(0.8, 1.2),
        "hue": uniform(-0.1, 0.1),
        "gray": gate(0.3),
        "blur": gate(0.8),
        "sharp": gate(0.3),
        "sharp_factor": uniform(0.0, 0.5),
    }


def photometric_chain(x: torch.Tensor, draws: dict[str, torch.Tensor], *,
                      with_sharpness: bool = True) -> torch.Tensor:
    """Apply the DiGA photometric stack to a unit-range BGR NHWC batch."""

    def per_image(v):
        return v.to(x.device).reshape(-1, 1, 1, 1)

    gray_w = _gray_w(x)
    # --- color jitter (fixed order) ---
    xj = torch.clamp(x * per_image(draws["brightness"]), 0.0, 1.0)
    mean_gray = torch.mean(torch.sum(xj * gray_w, dim=-1, keepdim=True), dim=(1, 2), keepdim=True)
    xj = torch.clamp((xj - mean_gray) * per_image(draws["contrast"]) + mean_gray, 0.0, 1.0)
    gray = torch.sum(xj * gray_w, dim=-1, keepdim=True)
    xj = torch.clamp(gray + (xj - gray) * per_image(draws["saturation"]), 0.0, 1.0)
    hsv = rgb_to_hsv(torch.flip(xj, dims=(-1,)))
    hue = torch.remainder(hsv[..., 0] + per_image(draws["hue"])[..., 0], 1.0)
    hsv = torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1)
    xj = torch.flip(hsv_to_rgb(hsv), dims=(-1,))
    x = torch.where(per_image(draws["jitter"]), xj, x)

    # --- random grayscale ---
    gray3 = torch.sum(x * gray_w, dim=-1, keepdim=True) * torch.ones_like(x)
    x = torch.where(per_image(draws["gray"]), gray3, x)

    # --- gaussian blur ---
    x = torch.where(per_image(draws["blur"]), gaussian_blur(x, 3, 2.0), x)

    # --- "sharpness" (kornia-0.5.8: blend toward the 3x3-smoothed image) ---
    if with_sharpness:
        smooth = torch.clamp(gaussian_blur(x, 3, 1.0), 0.0, 1.0)
        sharp = x + (smooth - x) * per_image(draws["sharp_factor"])
        x = torch.where(per_image(draws["sharp"]), sharp, x)
    return x


def diga_photometric(x_norm: torch.Tensor, draws: dict[str, torch.Tensor], beta: float, *,
                     with_sharpness: bool = True) -> torch.Tensor:
    """beta·to_model(chain(to_unit(x))) + (1 - beta)·x, in f32
    (reference warm_up.py:233; beta 0.4 warm-up, 0.3 self-training)."""
    x32 = x_norm.to(torch.float32)
    unit = torch.clamp(to_unit(x32), 0.0, 1.0)
    aug = photometric_chain(unit, draws, with_sharpness=with_sharpness)
    return beta * to_model(aug) + (1.0 - beta) * x32
