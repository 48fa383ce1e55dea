"""Nearest-2x upsample + 5x5 reflect conv in its subpixel (phase) form.

Counterpart of ``diga_tpu/ops/subpixel.py`` (:62-106).  The translator
decoder's up-blocks compute ``conv5x5(reflect_pad2(nearest_up2(x)))``
(reference model_util.py Conv2dBlock after ``Upsample(scale_factor=2)``).
Fine pixel (2i+a, 2j+b) of a nearest upsample is coarse pixel (i, j), so
each output phase (a, b) of the 5x5 fine conv is a 3x3 conv over the
coarse grid with phase-summed taps:

    a=0: fine taps {0,1} {2,3} {4} -> coarse offsets -1, 0, +1
    a=1: fine taps {0} {1,2} {3,4} -> coarse offsets -1, 0, +1

All four phases run as one 3x3 conv with 4·Co output channels and a
depth-to-space (``F.pixel_shuffle``): 9 MACs per fine pixel and input
channel instead of 25, and the upsampled tensor never exists.  The
identity holds where every tap lands inside the coarse grid; the fine
grid's 2-pixel reflect border maps onto other coarse rows, so the outer 2
fine rows and columns are recomputed from thin strips of the plain path
(3 coarse rows or columns each) and stitched over the phase output.
Inputs with ``2h < 6`` or ``2w < 6`` take the plain form, as in JAX.

Tensors are NCHW; ``w5`` is a ``nn.Conv2d`` weight (Co, C, 5, 5).  The
bias goes into each conv (JAX adds it after the stitch), so under
autocast the output keeps the conv's dtype, as ``nn.Conv2d``'s does.  The
convs are ``F.conv2d``: JAX computes them as XLA convolutions, outside
any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# fine taps summed into each coarse tap, by output phase (subpixel.py:38)
_GROUPS = {0: ((0, 1), (2, 3), (4,)), 1: ((0,), (1, 2), (3, 4))}


def _phase_kernels(w5: torch.Tensor) -> torch.Tensor:
    """(Co, C, 5, 5) -> (4·Co, C, 3, 3), channel co·4 + 2a + b, the order
    ``F.pixel_shuffle`` reads."""
    phases = []
    for a in (0, 1):
        for b in (0, 1):
            rows = [torch.stack([sum(w5[:, :, u, v] for u in _GROUPS[a][r] for v in _GROUPS[b][s])
                                 for s in range(3)], dim=-1)
                    for r in range(3)]
            phases.append(torch.stack(rows, dim=-2))  # (Co, C, 3, 3)
    co = w5.shape[0]
    return torch.stack(phases, dim=1).reshape(4 * co, *phases[0].shape[1:])


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _fine_conv(x_fine: torch.Tensor, w5: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    return F.conv2d(F.pad(x_fine, (2, 2, 2, 2), mode="reflect"), w5, bias)


def nearest_up2_conv5x5_reference(x: torch.Tensor, w5: torch.Tensor,
                                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain path: nearest 2x upsample, reflect pad 2, 5x5 conv."""
    return _fine_conv(_up2(x), w5, bias)


def nearest_up2_conv5x5(x: torch.Tensor, w5: torch.Tensor,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """The subpixel path; the same function as the reference form."""
    h, w = x.shape[2], x.shape[3]
    if 2 * h < 6 or 2 * w < 6:
        return nearest_up2_conv5x5_reference(x, w5, bias)
    bias4 = None if bias is None else bias.repeat_interleave(4)
    y = F.pixel_shuffle(F.conv2d(x, _phase_kernels(w5), bias4, padding=1), 2)
    # border strips on the fine grid: each carries 6 fine rows (columns);
    # its outer 2 outputs never read the strip's inner, false edge
    top = _fine_conv(_up2(x[:, :, :3]), w5, bias)[:, :, :2]
    bot = _fine_conv(_up2(x[:, :, h - 3:]), w5, bias)[:, :, -2:]
    y = torch.cat([top, y[:, :, 2:-2], bot], dim=2)
    left = _fine_conv(_up2(x[:, :, :, :3]), w5, bias)[:, :, :, :2]
    right = _fine_conv(_up2(x[:, :, :, w - 3:]), w5, bias)[:, :, :, -2:]
    return torch.cat([left, y[:, :, :, 2:-2], right], dim=3)
