"""Auxiliary tensor utilities (reference util/utils.py misc).

Counterpart of ``diga_tpu/ops/extras.py``: clamped one-hot labels,
FDA-style Fourier amplitude exchange, adaptive instance normalization,
CutMix boxes and block masks.  No train path calls them; they round out
the reference's utility surface.  Images and features are NHWC, as at
every public function of the port.  The random ones take their draws
injected (the box centre, the coarse uniforms) or draw them from a
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from .resize import resize_nearest

IGNORE = 255


def label_one_hot(labels: torch.Tensor, num_classes: int = 19) -> torch.Tensor:
    """(B, H, W) labels -> (B, H, W, C) one-hot clamped to [1e-4, 1]; an
    ignored (255) or out-of-range pixel is all 1e-4 (util/utils.py:118-123)."""
    classes = torch.arange(num_classes, device=labels.device)
    oh = (labels.to(torch.int64)[..., None] == classes).to(torch.float32)
    return torch.clamp(oh, 1e-4, 1.0)


def fourier_exchange(src: torch.Tensor, trg: torch.Tensor, L: float = 0.01) -> torch.Tensor:
    """FDA: the low-frequency FFT amplitude corners of ``src`` swapped for
    ``trg``'s; NHWC images, src content in trg style (util/utils.py:213-253).
    The window is ``b = floor(min(h, w) · L)`` (in f32, as the JAX package
    computes it) at each of the four corners; at ``b == 0`` the amplitude
    stays as it is."""
    x = src.to(torch.float32).permute(0, 3, 1, 2)
    y = trg.to(torch.float32).permute(0, 3, 1, 2)
    fx = torch.fft.fftn(x, dim=(-2, -1))
    fy = torch.fft.fftn(y, dim=(-2, -1))
    amp_x, pha_x = torch.abs(fx), torch.angle(fx)
    amp_y = torch.abs(fy)
    h, w = x.shape[-2:]
    b = int(np.floor(np.float32(min(h, w) * L)))
    if b > 0:
        mask = torch.zeros((h, w), dtype=torch.bool, device=src.device)
        mask[:b, :b] = True
        mask[:b, w - b:] = True
        mask[h - b:, :b] = True
        mask[h - b:, w - b:] = True
        amp_x = torch.where(mask, amp_y, amp_x)
    out = torch.fft.ifftn(amp_x * torch.exp(1j * pha_x), dim=(-2, -1)).real
    return out.permute(0, 2, 3, 1).to(src.dtype)


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image, per-channel spatial mean and std of NHWC features, the
    variance biased (util/utils.py:195-203)."""
    mean = torch.mean(feat, dim=(1, 2), keepdim=True)
    var = torch.var(feat, dim=(1, 2), keepdim=True, correction=0)
    return mean, torch.sqrt(var + eps)


def adaptive_instance_normalization(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """AdaIN: the content features re-styled with the style's statistics
    (util/utils.py:184-193)."""
    c_mean, c_std = calc_mean_std(content)
    s_mean, s_std = calc_mean_std(style)
    return (content - c_mean) / c_std * s_std + s_mean


def rand_bbox(hw: tuple[int, int], lam: float = 0.5, *, center: tuple[int, int] | None = None,
              generator: torch.Generator | None = None,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """(H, W) float 0/1 CutMix box mask with side ratio sqrt(1 - lam)
    (util/utils.py:166-182).  ``center`` = (cx, cy) is the injected draw;
    else cx in [0, W) and cy in [0, H) are drawn from ``generator``.  The
    cut sizes truncate ``h · sqrt(1 - lam)`` computed in f32, as JAX does."""
    h, w = hw
    cut_rat = np.sqrt(np.float32(1.0 - lam))
    cut_h = int(np.float32(h) * cut_rat)
    cut_w = int(np.float32(w) * cut_rat)
    if center is None:
        cx = int(torch.randint(0, w, (), generator=generator))
        cy = int(torch.randint(0, h, (), generator=generator))
    else:
        cx, cy = (int(v) for v in center)
    x1, x2 = np.clip([cx - cut_w // 2, cx + cut_w // 2], 0, w)
    y1, y2 = np.clip([cy - cut_h // 2, cy + cut_h // 2], 0, h)
    mask = torch.zeros((h, w), dtype=torch.float32, device=device)
    mask[int(y1):int(y2), int(x1):int(x2)] = 1.0
    return mask


def block_grid(shape_bhw: tuple[int, int, int], block: int = 64) -> tuple[int, int, int]:
    """The coarse grid (B, round(H / block), round(W / block)), at least 1 a
    side; Python's round, half to even, as the JAX package's."""
    b, h, w = shape_bhw
    return b, max(1, round(h / block)), max(1, round(w / block))


def generate_block_mask(shape_bhw: tuple[int, int, int], block: int = 64, ratio: float = 0.5,
                        *, uniform: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """(B, H, W) float 0/1 block mask: a coarse grid kept where its uniform
    draw exceeds ``ratio``, nearest-upsampled to (H, W)
    (util/utils.py:74-81).  ``uniform`` (``block_grid``'s shape) is the
    injected draw; else it is drawn from ``generator``."""
    _, h, w = shape_bhw
    grid = block_grid(shape_bhw, block)
    if uniform is None:
        uniform = torch.rand(grid, generator=generator).to(device)
    elif tuple(uniform.shape) != grid:
        raise ValueError(f"uniform draws of shape {tuple(uniform.shape)}, expected {grid}")
    coarse = (uniform > ratio).to(torch.float32)
    return resize_nearest(coarse, (h, w))
