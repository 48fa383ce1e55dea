"""The work a step or an image needs, counted by the benchmark itself.

FLOPs are counted on the reference's frozen architectures
(``benchmark/reference``), never on the program's modules, by running them
on the ``meta`` device at the cell's real shapes under
``torch.utils.flop_counter.FlopCounterMode``: every convolution, linear
layer and matrix product (OCR's attention products included) at 2 FLOPs a
multiply-accumulate, exactly and with no computation.  Norms, activations
and resizes are not counted.  A backward pass counts twice its forward;
recomputation is not counted.

The kernels' least times copy ``chip_smoke.py``'s arithmetic: each input
byte read once and each output byte written once at the peak HBM rate, or
the f32 operations at the f32 rate, whichever is longer.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

from ..reference import build_model, build_translator
from .peaks import Peaks


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _meta(module_fn) -> nn.Module:
    with torch.device("meta"):
        return module_fn()


def _image(b: int, hw) -> torch.Tensor:
    return torch.empty((b, 3, *hw), device="meta")


def model_forward_flops(config: dict, b: int, hw) -> int:
    model = _meta(lambda: build_model(config)).eval()
    return _flops(lambda: model(_image(b, hw)))


def stats_forward_flops(config: dict, b: int, hw) -> int:
    model = _meta(lambda: build_model(config)).eval()
    return _flops(lambda: model.stats_forward(_image(b, hw)))


def translator_flops(config: dict, b: int, hw) -> int:
    tr = _meta(lambda: build_translator(config))
    return _flops(lambda: tr(_image(b, hw)))


def train_step_flops(config: dict, traffic: dict) -> int:
    """Teacher forward and student forward + backward on [source; view],
    the target-stats forward, and the translator forward."""
    r, hw = traffic["recipe"], traffic["crop_hw"]
    b = traffic["source_batch"]
    fwd = model_forward_flops(config, 2 * b, hw)
    total = fwd + 3 * fwd
    if r["tgt_stats_forward"]:
        total += stats_forward_flops(config, traffic["target_batch"], hw)
    if r["translator"]:
        total += translator_flops(config, b, hw)
    return total


def eval_image_flops(config: dict, traffic: dict) -> int:
    return (model_forward_flops(config, 1, traffic["out_hw"])
            + model_forward_flops(config, 1, traffic["ds_hw"]))


def group_norm_inputs(config: dict, b: int, hw) -> list[tuple]:
    """The NHWC shape of every GroupNorm's input in one forward."""
    model = _meta(lambda: build_model(config)).eval()
    shapes = []
    hooks = [m.register_forward_hook(lambda m, i, o: shapes.append(
        (i[0].shape[0], i[0].shape[2], i[0].shape[3], i[0].shape[1])))
        for m in model.modules() if isinstance(m, nn.GroupNorm)]
    model(_image(b, hw))
    for h in hooks:
        h.remove()
    return shapes


def least_s(n_bytes: float, n_f32_ops: float, peaks: Peaks) -> float:
    return max(n_bytes / peaks.hbm_bytes_per_s, n_f32_ops / peaks.f32_flops_per_s)


def distill_least_s(shape, elem: int, peaks: Peaks) -> float:
    """B1a (reads both logit stacks) + B1b (reads both, writes the gradient)."""
    numel = math.prod(shape)
    xb = numel * elem
    return (least_s(2 * xb + 4, 16 * numel, peaks) + least_s(3 * xb + 4, 16 * numel, peaks))


def group_norm_least_s(shape, elem: int, peaks: Peaks) -> float:
    """B2a + B2b: x read once, y written once, the affine read."""
    numel, c = math.prod(shape), shape[-1]
    return least_s(2 * numel * elem + 2 * c * 4, 5 * numel, peaks)
