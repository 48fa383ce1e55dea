"""Shared CLI plumbing: argparse base, preset overrides, device.

Counterpart of ``diga_tpu/cli/common.py``, with ``--device`` (default
``cuda``).  ``--n_devices`` and ``--multihost`` belong to the multi-GPU
slice of the port; until then they are refused, not ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ..configs.presets import ExperimentConfig, get_preset


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--preset", type=str, required=True,
                   help="experiment preset name (see diga_tpu_torch.configs.PRESETS)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises when no card is present) or 'cpu' "
                        "(the plain PyTorch path)")
    p.add_argument("--work_dir", type=str, default="./work_dir")
    p.add_argument("--source_root", type=str, default=None)
    p.add_argument("--target_root", type=str, default=None)
    p.add_argument("--source_list", type=str, default=None)
    p.add_argument("--target_img_list", type=str, default=None)
    p.add_argument("--target_lbl_list", type=str, default=None)
    p.add_argument("--val_img_list", type=str, default=None)
    p.add_argument("--val_lbl_list", type=str, default=None)
    p.add_argument("--pseudo_dir", type=str, default=None)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--eval_limit", type=int, default=None,
                   help="evaluate only the first N val images (CI configs)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="not supported yet (multi-GPU slice)")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="not supported yet (multi-GPU slice)")
    p.add_argument("--extra", action="append", default=[], metavar="KEY=VALUE",
                   help="override an ExperimentConfig.extra entry (repeatable); "
                        "values parse as JSON when possible, else raw strings")
    p.add_argument("--parity", action="store_true",
                   help="pin every documented deviation knob to the "
                        "reference-faithful setting: photometric=kornia, "
                        "compute_dtype=float32, no tgt_stats_forward override")
    return p


def refuse_multi_device(p: argparse.ArgumentParser, args) -> None:
    if args.n_devices is not None:
        p.error("--n_devices is not supported by the port yet (multi-GPU slice); "
                "it runs on one device")
    if args.multihost:
        p.error("--multihost is not supported by the port yet (multi-GPU slice)")


def apply_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    data_kw = {}
    for field in ("source_root", "target_root", "source_list", "target_img_list",
                  "target_lbl_list", "val_img_list", "val_lbl_list", "pseudo_dir"):
        v = getattr(args, field, None)
        if v is not None:
            data_kw[field] = v
    train_kw = {}
    if args.num_steps is not None:
        train_kw["num_steps"] = args.num_steps
    if getattr(args, "compute_dtype", None):
        train_kw["compute_dtype"] = args.compute_dtype
    if getattr(args, "seed", None) is not None:
        train_kw["seed"] = args.seed
    cli_extra = {}
    for item in getattr(args, "extra", []) or []:
        key, sep, raw = item.partition("=")
        if not sep:
            raise SystemExit(f"--extra expects KEY=VALUE, got {item!r}")
        try:
            cli_extra[key] = json.loads(raw)
        except json.JSONDecodeError:
            cli_extra[key] = raw
    if getattr(args, "parity", False):
        cli_extra.pop("tgt_stats_forward", None)
        cli_extra["photometric"] = "kornia"
        train_kw["compute_dtype"] = "float32"
    extra = {**cfg.extra, **cli_extra}
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, **data_kw),
        train=dataclasses.replace(cfg.train, **train_kw),
        extra=extra,
    )


def get_config(args) -> ExperimentConfig:
    return apply_overrides(get_preset(args.preset), args)
