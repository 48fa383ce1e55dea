"""An eval cell: the two-scale evaluation driven image by image, then checked.

Set-up builds the frozen eval model and the port's ``TwoScaleEvaluator``
(``build_eval``, as ``evaluate_val`` runs them), loads the benchmark's
seeded weights, makes the pool of host images, and scores
``warmup_images`` of them (cuDNN tunes both scales); the confusion counts
are then reset.  The window hands the pool's host images to ``update`` in
turn, batch 1, closed loop, for ``seconds``; an image's latency runs from
the call until its prediction is on the device and synchronised.  Each
prediction is kept (uint8, after its latency is taken).  After the window
the peak memory is read, the program is freed, and the reference counts
the kept predictions' confusion against the labels and recomputes the
merged logits of a seeded sample of the window's images.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference
from ..reference.evaluate import confusion, logit_gap, two_scale_logits
from . import counts, program, traffic as traffic_mod
from .device import free, peak_bytes, sync
from .seeds import streams
from .weights import load_exact, seeded_state, shapes_of


def inputs(config: dict, traffic: dict, seed: int, device) -> tuple[dict, list, dict]:
    sd = streams(seed)
    with torch.device("meta"):
        shapes = shapes_of(reference.build_model(config))
    weights = seeded_state(shapes, sd["weights"], device, reference.weight_rule(config))
    pool = traffic_mod.eval_pool(traffic, config["num_classes"], sd["data"], device)
    return weights, pool, sd


def reference_model(config: dict, weights: dict, device) -> torch.nn.Module:
    with torch.device("meta"):
        model = reference.build_model(config)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def gaps(model, traffic: dict, pool: list, images: list[int], preds: list[torch.Tensor],
         device, precision: str = "f32") -> list[float]:
    """The widest logit gap of each (pool image, prediction) pair."""
    out = []
    for idx, pred in zip(images, preds):
        image = torch.from_numpy(pool[idx]["image"]).to(device)
        merged = two_scale_logits(model, image, traffic["out_hw"], traffic["ds_hw"], precision,
                                  traffic["rgb_input"])
        out.append(float(logit_gap(merged, pred.to(device)).max()))
    return out


def kernel_sites(config: dict, traffic: dict) -> dict:
    return {"gn": (counts.group_norm_inputs(config, 1, traffic["out_hw"])
                   + counts.group_norm_inputs(config, 1, traffic["ds_hw"]))}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    from .metrics import Context, elem_bytes, read_all
    from .peaks import for_device
    from .trace import Scopes, run_traced

    tr = cell.traffic
    evaluator, model = program.build_eval(cell.config, tr, device)
    weights, pool, sd = inputs(cell.config, tr, seed, device)
    load_exact(model, weights, "the program's eval model")
    n_pool = len(pool)
    for i in range(tr["warmup_images"]):
        evaluator.update(pool[i % n_pool]["image"], pool[i % n_pool]["label"])
    sync(device)
    evaluator.score.reset()
    setup_s = time.perf_counter() - t0

    latencies, kept, order = [], [], []
    i = 0
    start = time.perf_counter()
    while True:
        item = pool[i % n_pool]
        t_in = time.perf_counter()
        pred = evaluator.update(item["image"], item["label"])
        sync(device)
        latencies.append(time.perf_counter() - t_in)
        kept.append(pred.to(torch.uint8))
        order.append(i % n_pool)
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - start
    conf = evaluator.score.confusion.clone()
    n = len(latencies)
    imgs_per_s = n / window_s
    out = {"attempted": n, "window_s": window_s,
           "end_to_end": {"eval_imgs_per_s": imgs_per_s,
                          "eval_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
                          "setup_s": setup_s}}
    if trace:
        def unit(j):
            item = pool[(i + j) % n_pool]
            evaluator.update(item["image"], item["label"])
            sync(device)

        t = run_traced(unit, tr["trace_images"], device, Scopes.of(cell.config))
        ctx = Context(trace=t, units_per_s=imgs_per_s,
                      unit_flops=counts.eval_image_flops(cell.config, tr),
                      peaks=for_device(torch.cuda.get_device_name(device)),
                      kernel_sites=kernel_sites(cell.config, tr),
                      elem_bytes=elem_bytes(cell.config))
        out["per_layer"] = read_all(cell.per_layer, ctx)
        out["trace"] = t
    out["memory_peak_bytes"] = peak_bytes(device)
    del evaluator, model
    free(device)

    t_ref = time.perf_counter()
    k = cell.config["num_classes"]
    ref_conf = torch.zeros((k, k), dtype=torch.int64, device=device)
    for idx, pred in zip(order, kept):
        ref_conf += confusion(torch.from_numpy(pool[idx]["label"]).to(device), pred, k)
    rng = np.random.default_rng(sd["sample"])
    sample = sorted(rng.choice(n, size=min(tr["sample_images"], n), replace=False).tolist())
    ref = reference_model(cell.config, weights, device)
    sample_gaps = gaps(ref, tr, pool, [order[s] for s in sample], [kept[s] for s in sample],
                       device)
    out["readings"] = {"logit_gap": max(sample_gaps),
                       "confusion_diff": float((conf - ref_conf).abs().sum())}
    out["reference_s"] = time.perf_counter() - t_ref
    limit = tr["limits"].get("logit_gap")
    out["failed"] = sum(1 for g in sample_gaps if limit is None or not g <= limit)
    return out

