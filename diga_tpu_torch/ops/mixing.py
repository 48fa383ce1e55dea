"""Cross-domain mixture (CrDoMix) and DACS CutMix: class selection and pixel
masks, fixed-shape.

Counterpart of ``diga_tpu/ops/mixing.py`` (:23-99).  The reference builds
the mask with a Python loop and ``torch.unique``/``random.sample`` per
image (train_DiGA_gta2city_warm_up.py:239-261), a host sync every step;
here, as in the JAX package, the same distribution comes from fixed-shape
tensor ops on the device:

  * per-image class presence is a (B, C+1) mask (slot C = ignore)
  * "sample half of the present classes" = the top floor(n/2) of i.i.d.
    uniform scores over the present classes, drawn from an explicit
    ``torch.Generator``
  * the ignore slot is always selected (reference :249-250)

``crdomix`` and ``dacs_crossmix`` take the selection as an argument, so a
test can inject the JAX package's draw.
"""

from __future__ import annotations

import torch

from ..parallel import dist

IGNORE = 255


def _ids(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return torch.where(labels == IGNORE, num_classes, labels).to(torch.int64)


def class_presence(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, C+1) f32 presence mask; slot C is the ignore class."""
    b = labels.shape[0]
    present = torch.zeros((b, num_classes + 1), dtype=torch.float32, device=labels.device)
    present.scatter_(1, _ids(labels, num_classes).reshape(b, -1), 1.0)
    return present


def sample_half_classes(labels: torch.Tensor, generator: torch.Generator,
                        num_classes: int) -> torch.Tensor:
    """(B, C+1) 0/1 f32 selection of floor(n/2) of the n present classes
    (ignore counted), plus the ignore slot."""
    present = class_presence(labels, num_classes)
    k = torch.floor(present.sum(dim=-1, keepdim=True) / 2.0)
    # under a process group: drawn for the global batch, this rank's rows kept
    scores = dist.draw_local(lambda n: torch.rand((n, present.shape[1]), generator=generator,
                                                  device=labels.device), present.shape[0])
    scores = torch.where(present > 0, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True).to(torch.float32)
    selected = (ranks < k) & (present > 0)
    selected[:, num_classes] = True
    return selected.to(torch.float32)


def selection_to_pixel_mask(labels: torch.Tensor, selected: torch.Tensor,
                            num_classes: int) -> torch.Tensor:
    """(B, H, W) mask: 1 where the pixel's class was selected."""
    b = labels.shape[0]
    ids = _ids(labels, num_classes).reshape(b, -1)
    return torch.gather(selected, 1, ids).reshape(labels.shape)


def crdomix(translated: torch.Tensor, source_aug: torch.Tensor, source_labels: torch.Tensor,
            selected: torch.Tensor, num_classes: int) -> torch.Tensor:
    """NHWC composite: the translated image where the mask is 0, the
    source view where it is 1 (reference: warm_up.py:239-261)."""
    mask = selection_to_pixel_mask(source_labels, selected, num_classes)[..., None]
    return translated * (1.0 - mask) + source_aug * mask


def dacs_crossmix(target_img: torch.Tensor, source_img: torch.Tensor,
                  source_labels: torch.Tensor, target_pseudo: torch.Tensor,
                  selected: torch.Tensor, num_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """DACS class-paste of source pixels and labels into the target: (NHWC
    image, int32 label) with the source where the mask is 1, the target
    image and its pseudo-label elsewhere (reference self_training.py:306-325)."""
    mask = selection_to_pixel_mask(source_labels, selected, num_classes)
    mixed = target_img * (1.0 - mask[..., None]) + source_img * mask[..., None]
    label = torch.where(mask > 0, source_labels, target_pseudo).to(torch.int32)
    return mixed, label
