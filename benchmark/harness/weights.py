"""Seeded random weights, made on the device in a few large calls.

One normal and one uniform draw of a ``torch.Generator`` on the device
cover every leaf; each leaf is then its slice, scaled: convolution and
linear weights He-scaled (std sqrt(2 / fan_in)), biases and BN running
means N(0, 0.1), BN running variances U(0.5, 1.5), the last BN scale of
each residual branch U(0.1, 0.3) so that activations stay bounded through
the residual chains, other norm scales U(0.8, 1.2).  The rule is that of
``chip_smoke.py::seeded_state_dict``; a family module's ``weight_rule``
(``benchmark/reference/__init__.py``) comes before it for the leaves it
names.  Leaves are made in f32, the type the parameters are kept in.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _rule(key: str, shape: tuple) -> tuple[str, float, float]:
    """(draw, a, b): the leaf is ``a * normal`` or ``a + (b - a) * uniform``."""
    if len(shape) >= 2:
        return "normal", math.sqrt(2.0 / math.prod(shape[1:])), 0.0
    if key.endswith(("running_mean", ".bias")):
        return "normal", 0.1, 0.0
    if key.endswith("running_var"):
        return "uniform", 0.5, 1.5
    if ".bn3." in key or (".branches." in key and ".bn2." in key):
        return "uniform", 0.1, 0.3
    return "uniform", 0.8, 1.2


def seeded_state(shapes: dict[str, tuple], seed: int, device,
                 rule: Callable[[str, tuple], tuple | None] | None = None
                 ) -> dict[str, torch.Tensor]:
    """A state dict for ``shapes`` (key -> shape, in state_dict order);
    ``rule(key, shape)``, where given and not None, before ``_rule``."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    plan = {k: (rule and rule(k, tuple(s))) or _rule(k, tuple(s)) for k, s in shapes.items()
            if not k.endswith("num_batches_tracked")}
    out = {}
    for draw in ("normal", "uniform"):
        keys = [k for k, p in plan.items() if p[0] == draw]
        if not keys:
            continue
        sizes = [math.prod(shapes[k]) for k in keys]
        n = sum(sizes)
        counts = torch.tensor(sizes, device=device)
        a = torch.tensor([plan[k][1] for k in keys], device=device).repeat_interleave(counts, output_size=n)
        if draw == "normal":
            flat = torch.randn(n, generator=gen, device=device) * a
        else:
            b = torch.tensor([plan[k][2] for k in keys], device=device).repeat_interleave(counts, output_size=n)
            flat = a + (b - a) * torch.rand(n, generator=gen, device=device)
        for k, part in zip(keys, flat.split(sizes)):
            out[k] = part.view(shapes[k])
    for k, s in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
    return {k: out[k] for k in shapes}


def shapes_of(module: torch.nn.Module) -> dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def load_exact(module: torch.nn.Module, state: dict[str, torch.Tensor], what: str) -> None:
    """Copy ``state`` into ``module``: the same keys and shapes, or raise."""
    mine = shapes_of(module)
    if mine != {k: tuple(v.shape) for k, v in state.items()}:
        missing = sorted(set(state) - set(mine))[:5]
        extra = sorted(set(mine) - set(state))[:5]
        shape = sorted(k for k in set(mine) & set(state) if mine[k] != tuple(state[k].shape))[:5]
        raise ValueError(f"{what} does not match the configuration: missing {missing}, "
                         f"unexpected {extra}, other shapes {shape}")
    module.load_state_dict(state, strict=True)
