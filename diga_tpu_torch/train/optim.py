"""torch-SGD with DiGA's parameter groups.

Counterpart of ``diga_tpu/train/optim.py::sgd_grouped`` (:21-56),
reference train_DiGA_gta2city_warm_up.py:156, seg_model_noaux.py:281-321,
util/utils.py:36-48:
  * the backbone at 1x the scheduled LR, ``final.*`` (the ASPP head) at
    ``head_mult`` x;
  * the backbone BN affine left out entirely (``requires_grad=False``), so
    it gets neither decay nor updates;
  * HRNet+OCR has no ``final.*``: every parameter, BN affine included and
    decayed, is in the 1x group, as ``head_param_mask`` labels only a
    top-level ``head`` (``diga_tpu/models/resnet_deeplab.py:413-435``);
  * weight decay added to the gradient before the momentum buffer, which
    is what ``torch.optim.SGD`` does.
The LR of a step is ``schedule(step)`` with the step taken before its
increment (``set_lr``), as the optax form indexes it.

``adam_translator`` is the translator stage's optimizer, one per module
(``diga_tpu/cli/train_domain_translator.py:78-84``, reference
train_domain_translator.py:149-170): Adam(0.5, 0.999), eps 1e-8, no
weight decay, its LR set to ``poly(lr, steps)(i)`` before update i, as
``optax.adam(poly_schedule(...))`` counts once per update.
"""

from __future__ import annotations

import torch


def param_groups(model: torch.nn.Module, head_mult: float = 10.0) -> list[dict]:
    backbone, head = [], []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        (head if name.startswith("final.") else backbone).append(p)
    return [{"params": backbone, "lr_mult": 1.0}, {"params": head, "lr_mult": head_mult}]


def sgd_grouped(model: torch.nn.Module, base_lr: float, momentum: float = 0.9,
                weight_decay: float = 5e-4, head_mult: float = 10.0) -> torch.optim.SGD:
    groups = param_groups(model, head_mult)
    for g in groups:
        g["lr"] = base_lr * g["lr_mult"]
    return torch.optim.SGD(groups, lr=base_lr, momentum=momentum, weight_decay=weight_decay)


def adam_translator(module: torch.nn.Module, base_lr: float) -> torch.optim.Adam:
    return torch.optim.Adam([{"params": list(module.parameters()), "lr_mult": 1.0}],
                            lr=base_lr, betas=(0.5, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Scheduled LR into every group, times the group's multiplier."""
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_mult"]
