"""The one generator of the benchmark's inputs, driven by a traffic file.

Train mixes (``"kind": "train"``): a pool of ``pool_batches`` distinct
batches made on the device from the seed (``s_img`` and ``t_img``: NHWC
f32 normal images at ``image_std``; ``s_lbl``: uint8 labels constant over
``label_block`` x ``label_block`` blocks, classes uniform in [0, K)), and
``pool_draws`` per-step draw sets (a multiple of the pool): the
photometric chain's per-image factors and gates, and, where the step
mixes with a translator, the CrDoMix class selection of the draw's batch
(half the present classes, the ignore slot always).  Step i reads batch
``i % pool_batches`` and draws ``i % pool_draws``.  The generator is the
copy of ``diga_tpu_torch/utils/synth.py`` extended with the draws
(``ops/photometric.py::draw``, ``ops/mixing.py::sample_half_classes``).

Eval mixes (``"kind": "eval"``): a pool of ``pool_images`` host images,
batch 1, NHWC f32, with int32 labels (255 over a share ``ignore_share``
of the blocks), as ``eval/evaluator.py::iter_val`` hands them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

IGNORE = 255


def _blocky_labels(gen: torch.Generator, n: int, hw, block: int, num_classes: int,
                   ignore_share: float, device) -> torch.Tensor:
    gh, gw = math.ceil(hw[0] / block), math.ceil(hw[1] / block)
    grid = torch.randint(0, num_classes, (n, gh, gw), generator=gen, device=device)
    if ignore_share > 0:
        drop = torch.rand((n, gh, gw), generator=gen, device=device) < ignore_share
        grid = torch.where(drop, torch.full_like(grid, IGNORE), grid)
    full = grid.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)
    return full[:, :hw[0], :hw[1]].to(torch.uint8)


def train_pool(traffic: dict, num_classes: int, seed: int, device) -> list[dict]:
    gen = torch.Generator(device).manual_seed(seed)
    hw, std = traffic["crop_hw"], traffic["image_std"]
    bs, bt = traffic["source_batch"], traffic["target_batch"]
    pool = []
    for _ in range(traffic["pool_batches"]):
        batch = {"s_img": torch.randn((bs, *hw, 3), generator=gen, device=device) * std,
                 "s_lbl": _blocky_labels(gen, bs, hw, traffic["label_block"], num_classes,
                                         0.0, device)}
        if bt:
            batch["t_img"] = torch.randn((bt, *hw, 3), generator=gen, device=device) * std
        pool.append(batch)
    return pool


def photometric_draws(gen: torch.Generator, b: int, p_jitter: float, device) -> dict:
    def uniform(lo, hi):
        return torch.rand(b, generator=gen, device=device) * (hi - lo) + lo

    def gate(p):
        return torch.rand(b, generator=gen, device=device) < p

    return {"jitter": gate(p_jitter), "brightness": uniform(0.6, 1.4),
            "contrast": uniform(0.6, 1.4), "saturation": uniform(0.8, 1.2),
            "hue": uniform(-0.1, 0.1), "gray": gate(0.3), "blur": gate(0.8),
            "sharp": gate(0.3), "sharp_factor": uniform(0.0, 0.5)}


def half_classes(gen: torch.Generator, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, K+1) f32: floor(n/2) of the n present classes (ignore counted),
    chosen by uniform scores, and the ignore slot."""
    b = labels.shape[0]
    ids = torch.where(labels == IGNORE, num_classes, labels.long()).reshape(b, -1)
    present = torch.zeros((b, num_classes + 1), device=labels.device).scatter_(1, ids, 1.0)
    k = torch.floor(present.sum(-1, keepdim=True) / 2)
    scores = torch.rand(present.shape, generator=gen, device=labels.device)
    scores = torch.where(present > 0, scores, torch.full_like(scores, -math.inf))
    ranks = torch.argsort(torch.argsort(-scores, dim=-1, stable=True), dim=-1, stable=True)
    selected = (ranks < k) & (present > 0)
    selected[:, num_classes] = True
    return selected.float()


def train_draws(traffic: dict, recipe: dict, pool: list[dict], seed: int, device) -> list[dict]:
    n = traffic["pool_draws"]
    if n % len(pool):
        raise ValueError(f"pool_draws {n} must be a multiple of pool_batches {len(pool)}")
    gen = torch.Generator(device).manual_seed(seed)
    draws = []
    for j in range(n):
        labels = pool[j % len(pool)]["s_lbl"]
        d = {"photometric": photometric_draws(gen, labels.shape[0], recipe["p_jitter"], device)}
        if recipe["translator"]:
            d["selection"] = half_classes(gen, labels, recipe["num_classes"])
        draws.append(d)
    return draws


def eval_pool(traffic: dict, num_classes: int, seed: int, device) -> list[dict]:
    """Host images and labels, made on ``device`` and copied to the host."""
    gen = torch.Generator(device).manual_seed(seed)
    hw = traffic["out_hw"]
    pool = []
    for _ in range(traffic["pool_images"]):
        img = torch.randn((1, *hw, 3), generator=gen, device=device) * traffic["image_std"]
        lbl = _blocky_labels(gen, 1, hw, traffic["label_block"], num_classes,
                             traffic["ignore_share"], device)
        pool.append({"image": img.cpu().numpy(), "label": lbl.cpu().numpy().astype(np.int32)})
    return pool
