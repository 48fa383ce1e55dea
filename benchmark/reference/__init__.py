"""The benchmark's plain reference: frozen copies of the architectures and
of the step and evaluation, in plain PyTorch.  Nothing here imports JAX,
the JAX package or the program under test.

A configuration's ``model`` names its family, the module
``reference/families/<model>.py``; a traffic file's ``recipe.optimizer``
names its optimizer, the module ``reference/optimizers/<optimizer>.py``.
Both are found by name, so a new family or optimizer is a new file.

A family module defines ``build(config) -> nn.Module``, a model with the
``SegModel`` interface below, and may define ``weight_rule(key, shape)``
for the benchmark's seeded weights (``harness/weights.py``): ``(draw, a,
b)`` for the leaves it has a rule for, None for the rest.

An optimizer module defines:
  * ``lr(recipe, k)``: the scheduled LR of step k (before the head's
    multiplier);
  * ``update(name, p, state, k, leaf_lr, recipe)``: the reference's
    update of the leaf ``name`` at step k, in place, from ``p.grad``;
    ``state`` is the leaf's own dict, empty before step 0; ``leaf_lr`` is
    ``lr(recipe, k)`` times the leaf's multiplier;
  * ``first_update(state)``: the leaf's first update as the optimizer
    gets it, read from ``state`` after step 0;
  * ``program_first_update(opt_state)``: the same read from the program's
    ``torch.optim`` state of the leaf after step 1 (None where it has none);
  * ``PRESET_KEYS``: recipe key -> a function reading that key's value
    from the program's preset (its config object), which the harness
    holds to the traffic file's recipe before a run;
  * ``PROGRAM_SPANS``: the program's span names that the trace charges to
    ``optimizer_ema``.
"""

from __future__ import annotations

import importlib
import re
from types import ModuleType
from typing import Protocol

import torch
import torch.nn as nn

from .translator import Translator

_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


class SegModel(Protocol):
    """What the step, the eval, the FLOP counter and the seeded weights read
    from a family's model (``build(config)``), f32 and in NCHW."""

    def forward(self, x: torch.Tensor) -> tuple:
        """(shallow, aux_or_deep, logits, feat): index 1 holds the aux
        logits where the recipe's ``aux_weight`` > 0; ``logits`` at the
        model's output stride, upsampled by the step and the eval."""

    def stats_forward(self, x: torch.Tensor) -> None:
        """The target-stats forward: every BN statistic that a train-mode
        forward updates, and no gradient taken."""

    def head_param(self, name: str) -> bool:
        """Whether the trainable parameter ``name`` takes the recipe's
        ``head_lr_mult``."""

    def set_generator(self, generator: torch.Generator | None) -> None:
        """The generator of every random draw of a train-mode forward
        (channel dropout, stochastic depth), in an order the family states;
        the program's dropout generator is seeded alike."""


def _find(package: str, name, what: str) -> ModuleType:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"{what} {name!r}: expected a module name")
    try:
        return importlib.import_module(f"{__name__}.{package}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{package}.{name}":
            raise
        raise ValueError(f"{what} {name!r}: no module benchmark/reference/{package}/{name}.py") \
            from None


def family(config: dict) -> ModuleType:
    """The configuration's family module."""
    return _find("families", config.get("model"), "model")


def optimizer(recipe: dict) -> ModuleType:
    """The recipe's optimizer module; a recipe that names none is refused."""
    if "optimizer" not in recipe:
        raise ValueError("the traffic file's recipe names no optimizer")
    return _find("optimizers", recipe["optimizer"], "optimizer")


def build_model(config: dict) -> nn.Module:
    """The configuration file's segmentation model, f32, on the CPU."""
    return family(config).build(config)


def weight_rule(config: dict):
    """The family's seeded-weights rule, or None."""
    return getattr(family(config), "weight_rule", None)


def build_translator(config: dict) -> nn.Module | None:
    t = config.get("translator")
    if t is None:
        return None
    return Translator(t["enc_dim"], t["dec_dim"], t["n_downsample"], t["n_res"])
