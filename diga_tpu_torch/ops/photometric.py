"""On-device photometric augmentation, the ``diga`` and ``kornia`` chains.

Counterpart of ``diga_tpu/ops/photometric.py`` (:36-285).  The
reference builds kornia Sequential(ColorJitter(b=.4, c=.4, s=.2, h=.1,
p=.5), RandomGrayscale(p=.3), RandomGaussianBlur(3x3, sigma=2, p=.8),
RandomSharpness(.5, p=.3)) and blends ``beta*norm(aug(x)) + (1-beta)*x``
(train_DiGA_gta2city_warm_up.py:105-111,233).  The ``diga`` variant, the
JAX package's default, de-normalizes to unit BGR, augments there and
re-normalizes (its documented deviation).  The ``kornia`` variant, which
``--parity`` selects, applies the reconstructed kornia-0.5.8 chain to the
normalized tensor itself, as the reference does, and keeps the trailing
``2x - 1`` of the reference's ``norm``.

Draws are split from their application: ``draw(generator, b)`` and
``draw_kornia(generator, b)`` return the per-image factors and gates from
an explicit ``torch.Generator``, and ``photometric_chain`` /
``kornia_photometric_chain`` / ``diga_photometric`` apply them, so a test
can inject the JAX package's draws.  Images are NHWC, as at the JAX
package's functions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..data.normalize import IMG_MEAN_BGR

_GRAY_W_BGR = (0.114, 0.587, 0.299)  # luma weights in BGR channel order
# kornia's RGB luma weights, applied by the kornia chain to the channels as
# given (BGR: the reference never flips)
_GRAY_W_AS_GIVEN = (0.299, 0.587, 0.114)
# kornia-0.5.8 RandomSharpness's degenerate kernel
_SHARP_KERNEL = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))


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


def draw_kornia(generator: torch.Generator, b: int,
                p_jitter: float = 0.5) -> dict[str, torch.Tensor]:
    """The draws of one ``kornia_photometric_chain`` from ``generator`` on its
    device: ``order``, one permutation of the four jitters (brightness,
    contrast, saturation, hue) shared by the batch, as kornia samples one
    ``randperm(4)`` per forward; and per image (shape (b,)) the brightness
    offset U(-.4, .4) (additive), the contrast, saturation and hue factors
    U(.6, 1.4), U(.8, 1.2), U(-.1, .1), the gates of ColorJitter
    (p=``p_jitter``), RandomGrayscale (p=.3), RandomGaussianBlur (p=.8) and
    RandomSharpness (p=.3), and the sharpness factor U(0, .5)."""
    dev = generator.device

    def uniform(lo, hi):
        return torch.rand(b, generator=generator, device=dev) * (hi - lo) + lo

    def gate(p):
        return torch.rand(b, generator=generator, device=dev) < p

    return {
        "order": torch.randperm(4, generator=generator, device=dev),
        "brightness": uniform(-0.4, 0.4),
        "contrast": uniform(0.6, 1.4),
        "saturation": uniform(0.8, 1.2),
        "hue": uniform(-0.1, 0.1),
        "jitter": gate(p_jitter),
        "gray": gate(0.3),
        "blur": gate(0.8),
        "sharp": gate(0.3),
        "sharp_factor": uniform(0.0, 0.5),
    }


def _with_channel(hsv: torch.Tensor, i: int, value: torch.Tensor) -> torch.Tensor:
    parts = list(hsv.unbind(-1))
    parts[i] = value
    return torch.stack(parts, dim=-1)


def kornia_photometric_chain(x: torch.Tensor, draws: dict[str, torch.Tensor], *,
                             with_sharpness: bool = True) -> torch.Tensor:
    """The reconstructed kornia-0.5.8 chain on the NHWC tensor as given (the
    reference feeds the normalized BGR batch, range about [-2, 1.2], to
    kornia ops that assume unit RGB): the four jitters in ``draws['order']``
    (brightness additive then clamped to [0, 1], contrast multiplicative
    then clamped, saturation and hue through HSV on the channels as given,
    not clamped), grayscale with RGB weights on the as-given channels, the
    3x3 sigma-2 blur with reflect padding (not clamped), and the sharpness
    blend toward the ``[[1,1,1],[1,5,1],[1,1,1]]/13`` conv (zero padding)
    clamped to [0, 1], interior pixels only, the blend not clamped."""

    def per_image(v):
        return v.to(x.device).reshape(-1, 1, 1, 1)

    def brightness(v):
        return torch.clamp(v + per_image(draws["brightness"]), 0.0, 1.0)

    def contrast(v):
        return torch.clamp(v * per_image(draws["contrast"]), 0.0, 1.0)

    def saturation(v):
        hsv = rgb_to_hsv(v)
        scaled = hsv[..., 1] * per_image(draws["saturation"])[..., 0]
        return hsv_to_rgb(_with_channel(hsv, 1, scaled))

    def hue(v):
        hsv = rgb_to_hsv(v)
        shifted = torch.remainder(hsv[..., 0] + per_image(draws["hue"])[..., 0], 1.0)
        return hsv_to_rgb(_with_channel(hsv, 0, shifted))

    jitters = (brightness, contrast, saturation, hue)
    xj = x
    for i in draws["order"].tolist():
        xj = jitters[i](xj)
    x = torch.where(per_image(draws["jitter"]), xj, x)

    w = torch.tensor(_GRAY_W_AS_GIVEN, dtype=x.dtype, device=x.device)
    gray3 = torch.sum(x * w, dim=-1, keepdim=True) * torch.ones_like(x)
    x = torch.where(per_image(draws["gray"]), gray3, x)

    x = torch.where(per_image(draws["blur"]), gaussian_blur(x, 3, 2.0), x)

    if with_sharpness:
        c = x.shape[-1]
        k = torch.tensor(_SHARP_KERNEL, dtype=x.dtype, device=x.device) / 13.0
        degenerate = F.conv2d(x.permute(0, 3, 1, 2), k[None, None].expand(c, 1, 3, 3),
                              padding=1, groups=c).permute(0, 2, 3, 1)
        degenerate = torch.clamp(degenerate, 0.0, 1.0)
        sharp = x + per_image(draws["sharp_factor"]) * (degenerate - x)
        interior = torch.zeros(x.shape[1:3], dtype=torch.bool, device=x.device)
        interior[1:-1, 1:-1] = True
        sharp = torch.where(interior[None, :, :, None], sharp, x)
        x = torch.where(per_image(draws["sharp"]), sharp, x)
    return x


def diga_photometric(x_norm: torch.Tensor, draws: dict[str, torch.Tensor], beta: float, *,
                     variant: str = "diga", with_sharpness: bool = True) -> torch.Tensor:
    """The photometric view blended at strength ``beta``, in f32 (reference
    warm_up.py:233; beta 0.4 warm-up, 0.3 self-training): ``variant='diga'``
    is beta·to_model(chain(to_unit(x))) + (1 - beta)·x with ``draw``'s
    draws; ``variant='kornia'`` is beta·(2·kornia_chain(x) - 1) + (1 - beta)·x
    with ``draw_kornia``'s."""
    x32 = x_norm.to(torch.float32)
    if variant == "kornia":
        aug = kornia_photometric_chain(x32, draws, with_sharpness=with_sharpness)
        return beta * (2.0 * aug - 1.0) + (1.0 - beta) * x32
    unit = torch.clamp(to_unit(x32), 0.0, 1.0)
    aug = photometric_chain(unit, draws, with_sharpness=with_sharpness)
    return beta * to_model(aug) + (1.0 - beta) * x32
