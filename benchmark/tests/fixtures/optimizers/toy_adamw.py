"""``optimizer: toy_adamw``, a test fixture: an optimizer that the harness
has never seen, found by name like any other (``test_bench_adding.py``).

AdamW (arXiv:1711.05101), weight decay decoupled and 0 on the BN leaves,
under the poly schedule; the first update is the first moment after step
1, which ``torch.optim.AdamW`` keeps as ``exp_avg``.
"""

from __future__ import annotations

import torch

PRESET_KEYS = {"weight_decay": lambda cfg: cfg.train.weight_decay,
               "beta1": lambda cfg: cfg.train.momentum}
PROGRAM_SPANS = ("adamw",)


def lr(recipe: dict, k: int) -> float:
    return recipe["learning_rate"] * (1.0 - k / recipe["num_steps"]) ** recipe["power"]


def update(name: str, p: torch.Tensor, state: dict, k: int, leaf_lr: float,
           recipe: dict) -> None:
    b1, b2 = recipe["beta1"], recipe["beta2"]
    if k == 0:
        state["m"], state["v"] = torch.zeros_like(p), torch.zeros_like(p)
    state["m"].mul_(b1).add_(p.grad, alpha=1.0 - b1)
    state["v"].mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
    decay = 0.0 if "_bn." in name else recipe["weight_decay"]
    p.mul_(1.0 - leaf_lr * decay)
    denom = (state["v"] / (1.0 - b2 ** (k + 1))).sqrt_().add_(recipe["eps"])
    p.addcdiv_(state["m"], denom, value=-leaf_lr / (1.0 - b1 ** (k + 1)))


def first_update(state: dict) -> torch.Tensor:
    return state["m"]


def program_first_update(opt_state: dict) -> torch.Tensor | None:
    return opt_state.get("exp_avg")
