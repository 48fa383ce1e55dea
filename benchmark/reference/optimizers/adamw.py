"""``optimizer: adamw``: AdamW under mmcv's linear warm-up and poly decay, as
DAFormer trains (arXiv:2111.14887; arXiv:1711.05101 for AdamW).

The LR of step k is mmcv's ``PolyLrUpdaterHook`` with a linear warm-up:
learning_rate x (1 - k / num_steps) ** power, times 1 - (1 - k /
warmup_iters) x (1 - warmup_ratio) while k < warmup_iters.  The head's
leaves take ``head_lr_mult`` x it (the model's ``head_param``).

Weight decay follows mmseg's ``paramwise_cfg`` custom keys (``head``:
lr x10; ``norm`` and ``pos_block``: decay x0), of which a parameter takes
the first whose key lies in its name, the keys in mmcv's order (longest
first, then alphabetical): so a backbone LayerNorm is not decayed and the
head's BN (``bn`` in mmcv's ``ConvModule``) is.

The update of a leaf, as ``torch.optim.AdamW`` makes it: p *= 1 - lr x
decay; m = beta1 m + (1 - beta1) g; v = beta2 v + (1 - beta2) g^2; p -=
lr / (1 - beta1^(k+1)) x m / (sqrt(v / (1 - beta2^(k+1))) + eps).  The
first update is the first moment after step 1 (``exp_avg``).
"""

from __future__ import annotations

import torch

PRESET_KEYS = {
    "optimizer": lambda cfg: cfg.train.optimizer,
    "learning_rate": lambda cfg: cfg.train.learning_rate,
    "beta1": lambda cfg: cfg.train.adam_betas[0],
    "beta2": lambda cfg: cfg.train.adam_betas[1],
    "eps": lambda cfg: cfg.train.adam_eps,
    "weight_decay": lambda cfg: cfg.train.weight_decay,
    "warmup_iters": lambda cfg: cfg.train.lr_warmup,
    "warmup_ratio": lambda cfg: cfg.train.lr_warmup_ratio,
    "power": lambda cfg: cfg.train.power,
    "num_steps": lambda cfg: cfg.train.num_steps,
}
PROGRAM_SPANS = ("adamw",)
# mmseg's paramwise_cfg for DAFormer: key -> decay multiplier
CUSTOM_DECAY = {"pos_block": 0.0, "head": 1.0, "norm": 0.0}


def lr(recipe: dict, k: int) -> float:
    regular = recipe["learning_rate"] * (1.0 - k / recipe["num_steps"]) ** recipe["power"]
    if k >= recipe["warmup_iters"]:
        return regular
    return regular * (1.0 - (1.0 - k / recipe["warmup_iters"]) * (1.0 - recipe["warmup_ratio"]))


def decay_mult(name: str) -> float:
    for key in sorted(sorted(CUSTOM_DECAY), key=len, reverse=True):
        if key in name:
            return CUSTOM_DECAY[key]
    return 1.0


def update(name: str, p: torch.Tensor, state: dict, k: int, leaf_lr: float,
           recipe: dict) -> None:
    b1, b2 = recipe["beta1"], recipe["beta2"]
    if k == 0:
        state["m"], state["v"] = torch.zeros_like(p), torch.zeros_like(p)
    p.mul_(1.0 - leaf_lr * recipe["weight_decay"] * decay_mult(name))
    state["m"].mul_(b1).add_(p.grad, alpha=1.0 - b1)
    state["v"].mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
    denom = (state["v"] / (1.0 - b2 ** (k + 1))).sqrt_().add_(recipe["eps"])
    p.addcdiv_(state["m"], denom, value=-leaf_lr / (1.0 - b1 ** (k + 1)))


def first_update(state: dict) -> torch.Tensor:
    return state["m"]


def program_first_update(opt_state: dict) -> torch.Tensor | None:
    return opt_state.get("exp_avg")
