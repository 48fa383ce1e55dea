"""``optimizer: sgd``: SGD with momentum under the poly schedule, as DiGA trains.

The update of a leaf: d = grad + weight_decay x p; the buffer is d at
step 0 and momentum x buffer + d after; p -= lr x buffer.  The LR of step
k is learning_rate x (1 - k / num_steps) ** power, and the head's leaves
take ``head_lr_mult`` x it.  This is ``torch.optim.SGD`` with weight decay
and momentum, whose ``momentum_buffer`` after step 1 is the first update.
"""

from __future__ import annotations

import torch

from ..ops import poly_lr

PRESET_KEYS = {
    "momentum": lambda cfg: cfg.train.momentum,
    "weight_decay": lambda cfg: cfg.train.weight_decay,
}
# the port's span, and the JAX twin's optax transforms, of the update
PROGRAM_SPANS = ("sgd", "add_decayed", "trace_update", "apply_updates", "scale_by", "masked",
                 "/update/")


def lr(recipe: dict, k: int) -> float:
    return poly_lr(recipe["learning_rate"], recipe["num_steps"], recipe["power"], k)


def update(name: str, p: torch.Tensor, state: dict, k: int, leaf_lr: float,
           recipe: dict) -> None:
    d = p.grad + recipe["weight_decay"] * p
    if k == 0:
        state["buffer"] = d.clone()
    else:
        state["buffer"].mul_(recipe["momentum"]).add_(d)
    p.add_(state["buffer"], alpha=-leaf_lr)


def first_update(state: dict) -> torch.Tensor:
    return state["buffer"]


def program_first_update(opt_state: dict) -> torch.Tensor | None:
    return opt_state.get("momentum_buffer")
