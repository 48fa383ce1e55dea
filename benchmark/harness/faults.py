"""Faults planted under the timed path, to show that the comparison fails them.

Train: ``frozen`` (a step that returns its state unchanged: the
optimizer's update never lands), ``HalfBatch`` (half of every batch left out, the
means taken over the rest).  Eval: ``altered`` (a quarter of the image's
answers changed where they are produced: the class logits of its top rows
rolled by one), ``stale`` (the confusion counts never updated).
"""

from __future__ import annotations

import types

import torch


def frozen(state) -> None:
    state.optimizer.step = types.MethodType(lambda self, closure=None: None, state.optimizer)


class HalfBatch:
    """``Inputs`` with the first half of each batch's rows and draws."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.recipe = inputs.recipe

    def batch(self, i: int) -> dict:
        return {k: v[: max(1, v.shape[0] // 2)] for k, v in self.inputs.batch(i).items()}

    def kwargs(self, i: int) -> dict:
        def half(v):
            if isinstance(v, dict):
                return {k: half(x) for k, x in v.items()}
            return v[: max(1, v.shape[0] // 2)]

        return {k: half(v) for k, v in self.inputs.kwargs(i).items()}


def altered(evaluator) -> None:
    apply_fn = evaluator.apply_fn

    def wrong(img: torch.Tensor) -> torch.Tensor:
        logits = apply_fn(img).clone()
        rows = max(1, logits.shape[1] // 4)
        logits[:, :rows] = torch.roll(logits[:, :rows], 1, dims=-1)
        return logits

    evaluator.apply_fn = wrong


def stale(evaluator) -> None:
    evaluator.score.update = lambda label, pred: None
