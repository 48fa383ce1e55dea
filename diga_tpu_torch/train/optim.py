"""The segmentation models' optimizers, with their parameter groups, and the
translator's.

``make_optimizer`` builds the one the preset names (``train.optimizer``):
``sgd_grouped`` (DiGA's, for ``DeepLabV2`` and ``HRNetOCR``) or
``adamw_grouped`` (DAFormer's, for ``MiTDAFormer``).

``sgd_grouped``: counterpart of ``diga_tpu/train/optim.py::sgd_grouped`` (:21-56),
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

``adamw_grouped``: ``torch.optim.AdamW`` with mmseg's ``paramwise_cfg``
as DAFormer sets it (custom keys ``head``: lr x ``head_mult``; ``norm`` and
``pos_block``: weight decay x0; a parameter takes the first key found in
its name, longest key first): the decode head at ``head_mult`` x the LR
and decayed (its BN is ``bn`` under mmcv's ``ConvModule``), the backbone's
LayerNorms undecayed, every other parameter at 1x and decayed.

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


# mmseg's custom keys in the order it tries them: (key, lr_mult is the head's, decay_mult)
_DAFORMER_KEYS = (("pos_block", False, 0.0), ("head", True, 1.0), ("norm", False, 0.0))


def adamw_grouped(model: torch.nn.Module, base_lr: float, weight_decay: float = 0.01,
                  betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                  head_mult: float = 10.0) -> torch.optim.AdamW:
    groups: dict[tuple[float, float], list] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        lr_mult, decay_mult = 1.0, 1.0
        for key, head, decay in _DAFORMER_KEYS:
            if key in name:
                lr_mult, decay_mult = (head_mult if head else 1.0), decay
                break
        groups.setdefault((lr_mult, decay_mult), []).append(p)
    return torch.optim.AdamW(
        [{"params": ps, "lr_mult": lr_mult, "lr": base_lr * lr_mult,
          "weight_decay": weight_decay * decay_mult}
         for (lr_mult, decay_mult), ps in groups.items()],
        lr=base_lr, betas=betas, eps=eps, weight_decay=weight_decay)


def make_optimizer(model: torch.nn.Module, train) -> torch.optim.Optimizer:
    """The optimizer ``train`` (a preset's ``TrainConfig``) names."""
    if train.optimizer == "sgd":
        return sgd_grouped(model, train.learning_rate, train.momentum, train.weight_decay,
                           train.head_lr_mult)
    if train.optimizer == "adamw":
        return adamw_grouped(model, train.learning_rate, train.weight_decay,
                             tuple(train.adam_betas), train.adam_eps, train.head_lr_mult)
    raise ValueError(f"optimizer {train.optimizer!r}: expected 'sgd' or 'adamw'")


def adam_translator(module: torch.nn.Module, base_lr: float) -> torch.optim.Adam:
    return torch.optim.Adam([{"params": list(module.parameters()), "lr_mult": 1.0}],
                            lr=base_lr, betas=(0.5, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Scheduled LR into every group, times the group's multiplier."""
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_mult"]
