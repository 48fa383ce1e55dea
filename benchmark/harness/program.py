"""The system under test: the port ``diga_tpu_torch``, built as its users build it.

This is the one module of the harness that imports the port.  A cell's
traffic file names the port's preset; the configuration file's
``program_extra`` is laid over the preset's ``extra`` (the model and its
depth).  Before a run the preset's recipe is held against the traffic
file's ``recipe``, which the reference reads, so the two sides cannot
drift apart unseen: the step's keys here, the optimizer's keys and LR
schedule from the recipe's optimizer module (``PRESET_KEYS``, ``lr``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import reference


def experiment(config: dict, traffic: dict):
    from diga_tpu_torch.configs.presets import get_preset

    cfg = get_preset(traffic["preset"])
    return dataclasses.replace(cfg, extra={**cfg.extra, **config.get("program_extra", {})})


def check_recipe(cfg, traffic: dict) -> None:
    """Raise where the preset's step differs from the traffic file's recipe."""
    from diga_tpu_torch.train.build import make_schedule, make_step_config, wants_target

    r, s, t = traffic["recipe"], make_step_config(cfg), cfg.train
    opt = reference.optimizer(r)
    have = {"num_classes": s.num_classes, "crop_hw": list(s.crop_hw), "beta": s.beta,
            "lambda_seg": s.lambda_seg, "lambda_distil": s.lambda_distil,
            "aux_weight": s.aux_weight, "rgb_input": s.rgb_input,
            "with_sharpness": s.with_sharpness, "tgt_stats_forward": s.tgt_stats_forward,
            "p_jitter": s.p_jitter, "head_lr_mult": t.head_lr_mult,
            "translator": cfg.stage != "dg" and not cfg.extra.get("no_translator", False),
            "source_batch": sum(x.batch for x in cfg.data.source_streams),
            "target_batch": (sum(x.batch for x in cfg.data.target_streams)
                             if wants_target(cfg) else 0),
            **{k: read(cfg) for k, read in opt.PRESET_KEYS.items()}}
    want = {**r, "crop_hw": list(r["crop_hw"]), "source_batch": traffic["source_batch"],
            "target_batch": traffic["target_batch"]}
    bad = {k: (v, want.get(k)) for k, v in have.items() if want.get(k) != v}
    if s.photometric != "diga" or s.seg_loss != "ce" or s.fuse_forwards:
        bad["step"] = (f"{s.photometric}/{s.seg_loss}/fuse={s.fuse_forwards}", "diga/ce/False")
    sched = make_schedule(cfg)
    for k in range(4):
        lr = opt.lr(r, k)
        if not math.isclose(sched(k), lr, rel_tol=1e-5):
            bad[f"lr[{k}]"] = (sched(k), lr)
    if bad:
        raise ValueError(f"preset {traffic['preset']!r} differs from the traffic file's "
                         f"recipe (program, file): {bad}")


def build_train(config: dict, traffic: dict, device: torch.device):
    """(state, step): ``build_experiment``'s train state and step."""
    from diga_tpu_torch.train.build import build_experiment

    cfg = experiment(config, traffic)
    check_recipe(cfg, traffic)
    state, step, _ = build_experiment(cfg, device)
    return state, step


def build_eval(config: dict, traffic: dict, device: torch.device):
    """(evaluator, model): ``build_eval``'s frozen model under the port's
    ``TwoScaleEvaluator``, as ``evaluate_val`` runs it."""
    from diga_tpu_torch.eval.evaluator import TwoScaleEvaluator
    from diga_tpu_torch.train.build import build_eval

    cfg = experiment(config, traffic)
    if [list(cfg.eval.out_hw), list(cfg.eval.ds_hw)] != [traffic["out_hw"], traffic["ds_hw"]]:
        raise ValueError(f"preset {traffic['preset']!r} evaluates at {cfg.eval.out_hw} and "
                         f"{cfg.eval.ds_hw}, the traffic file at {traffic['out_hw']} and "
                         f"{traffic['ds_hw']}")
    if cfg.extra.get("rgb_input", False) != traffic["rgb_input"]:
        raise ValueError("the preset's rgb_input differs from the traffic file's")
    apply_fn, model = build_eval(cfg, None, device)
    evaluator = TwoScaleEvaluator(apply_fn, cfg.train.num_classes, traffic["out_hw"],
                                  traffic["ds_hw"], device)
    return evaluator, model

