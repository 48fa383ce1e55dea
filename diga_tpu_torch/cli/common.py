"""Shared CLI plumbing: argparse base, preset overrides, device, world.

Counterpart of ``diga_tpu/cli/common.py``, with ``--device`` (default
``cuda``).  ``--n_devices N`` runs the CLI as N processes, one per device
of this host (``cuda:0..N-1`` over NCCL, or N gloo processes with
``--device cpu``); ``--multihost`` makes this process one rank of a
torchrun world (``parallel/dist.py``).  Without either flag the CLI is one
process on one device, where the JAX CLIs take every device.  Only the
trainers (``train_seg`` and its wrappers) and ``evaluate_val`` build a
world, as only their JAX counterparts build a mesh; the other CLIs refuse
the flags (``refuse_multi_device``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from .. import resolve_device
from ..configs.presets import ExperimentConfig, get_preset
from ..parallel import dist


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
                   help="run as N processes, one per device of this host (cuda:0..N-1 over "
                        "NCCL; N gloo processes with --device cpu); default: one process on "
                        "one device (the JAX CLIs take every device)")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="this process is one rank of a torchrun world (reads RANK, "
                        "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--extra", action="append", default=[], metavar="KEY=VALUE",
                   help="override an ExperimentConfig.extra entry (repeatable); "
                        "values parse as JSON when possible (True/False in any case as "
                        "booleans), else raw strings")
    p.add_argument("--parity", action="store_true",
                   help="pin every documented deviation knob to the "
                        "reference-faithful setting: photometric=kornia, "
                        "compute_dtype=float32, no tgt_stats_forward override")
    return p


def refuse_multi_device(p: argparse.ArgumentParser, args) -> None:
    """For the CLIs whose JAX counterparts build no mesh: one device only."""
    if args.n_devices is not None:
        p.error("--n_devices: this CLI runs on one device (its JAX counterpart builds no "
                "mesh); the trainers and evaluate_val take it")
    if args.multihost:
        p.error("--multihost: this CLI runs on one device (its JAX counterpart builds no "
                "mesh); the trainers and evaluate_val take it")


def check_world(p: argparse.ArgumentParser, args) -> None:
    """Refuse a world the flags cannot make: ``--multihost`` outside
    torchrun's environment, a ``--n_devices`` other than its world size,
    more ranks than devices."""
    if args.multihost:
        env = dist.torchrun_env()
        if env is None:
            p.error("--multihost reads torchrun's " + ", ".join(dist.TORCHRUN_ENV)
                    + "; start the ranks with torchrun")
        if args.n_devices is not None and args.n_devices != int(env["WORLD_SIZE"]):
            p.error(f"--n_devices {args.n_devices} differs from torchrun's WORLD_SIZE "
                    f"{env['WORLD_SIZE']}")
    elif args.n_devices is not None:
        try:
            dist.check_devices(args.n_devices, torch.device(args.device).type)
        except (RuntimeError, ValueError) as e:
            p.error(str(e))


def run_world(args, fn, *fn_args):
    """``fn(*fn_args)`` in this process with no process group (no flag), or
    on every rank of the world the flags ask for; rank 0's result."""
    if args.n_devices is None and not args.multihost:
        return fn(*fn_args)
    return dist.launch(fn, args.n_devices or 1, torch.device(args.device).type, fn_args,
                       multihost=args.multihost)


def rank_device(args) -> torch.device:
    """The rank's device under a process group, else ``--device`` (which
    raises where a card is asked for and absent)."""
    if dist.active():
        return dist.local_device(torch.device(args.device).type)
    return resolve_device(args.device)


def apply_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    data_kw = {}
    for field in ("source_root", "target_root", "source_list", "target_img_list",
                  "target_lbl_list", "val_img_list", "val_lbl_list", "pseudo_dir"):
        v = getattr(args, field, None)
        if v is not None:
            data_kw[field] = v
    train_kw = {}
    if getattr(args, "num_steps", None) is not None:
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
            # a capitalised boolean is a boolean, never the truthy string "False"
            cli_extra[key] = {"true": True, "false": False}.get(raw.lower(), raw)
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
