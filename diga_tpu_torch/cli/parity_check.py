"""Activation and two-scale-eval parity against the reference math.

Counterpart of ``diga_tpu/cli/parity_check.py`` (:21-111), on one device
(``--device``, default ``cuda``).  It loads a reference-layout
``student.pth`` into the port's ``DeepLabV2`` (strictly, through
``build_eval``: the model ``evaluate_val`` runs, GroupNorm on the kernels
B2a/B2b on the card) and holds it against ``models/torch_replay.py``, a
functional replay of the reference forward from the same state_dict in
f32 on the same device:

  (a) the largest |logits| difference on a seeded 129x225 input;
  (b) with ``--vs_torch_replay``, the two-scale eval (the port's
      ``TwoScaleEvaluator`` against the replay of the reference
      evaluate_val.py:60-89: bilinear align_corners=True down- and
      upsampling, elementwise max merge, argmax, confusion) on the same
      val images: the share of pixels whose argmax differs must be below
      1e-3, or the check exits with a message (``SystemExit``, not an
      ``assert``, so ``python -O`` keeps it);
  (c) otherwise, unless ``--skip_eval``, ``evaluate_val`` on the preset.
TF32 is off on both sides while the check runs.  With a bf16
``--compute_dtype`` the port's side runs in bf16 against the f32 replay,
where random weights may flip more pixels than the gate allows: gate at
``--compute_dtype float32``.  The replay covers DeepLabV2 only, as the
JAX check does: an HRNet+OCR preset is refused.

Usage:
  python -m diga_tpu_torch.cli.parity_check --preset gta2city_warmup \\
      --weight_dir <dir with student.pth> [--eval_limit 50] [--skip_eval] \\
      [--vs_torch_replay --compute_dtype float32] [--device cpu]
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data import cityscapes_dataset
from ..eval.evaluator import TwoScaleEvaluator
from ..models.torch_replay import segmodel_forward_torch
from ..train.build import build_eval
from ..utils.checkpoint import load_role_keyed
from .common import base_parser, get_config, refuse_multi_device

ACTIVATION_HW = (129, 225)  # JAX parity_check's input; GroupNorm at (1, 17, 29, 256)
GATE = 1e-3  # largest share of pixels whose argmax may differ from the replay's


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convolutions and matmuls, restored after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _layers(cfg) -> tuple:
    return tuple(cfg.extra.get("layers", (3, 4, 23, 3)))


def replay_state_dict(weight_dir: str, device: torch.device) -> dict:
    """``<weight_dir>/student.pth`` as f32 tensors on ``device``."""
    sd = load_role_keyed(weight_dir, ["student"])["student"]
    return {k: v.to(device, torch.float32) if v.is_floating_point() else v.to(device)
            for k, v in sd.items()}


def activation_parity(cfg, weight_dir: str, device: torch.device) -> float:
    """Max |logits_port - logits_replay| on a seeded random input."""
    eval_apply, _ = build_eval(cfg, weight_dir, device)
    sd = replay_state_dict(weight_dir, device)
    x = np.random.default_rng(0).normal(size=(1, *ACTIVATION_HW, 3)).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    with torch.inference_mode():
        ours = eval_apply(xt).float()
        ref, _ = segmodel_forward_torch(sd, xt.permute(0, 3, 1, 2).contiguous(),
                                        layers=_layers(cfg), num_classes=cfg.train.num_classes)
    diff = float((ours - ref.permute(0, 2, 3, 1)).abs().max())
    print(f"activation parity: max |logits_port - logits_torch| = {diff:.2e}", flush=True)
    return diff


def eval_confusion_vs_torch(cfg, weight_dir: str, device: torch.device, eval_limit: int = 50):
    """The same weights through (a) the port's two-scale evaluator and (b)
    the replay of the reference eval pipeline, over the same preprocessed
    val images; returns both confusion matrices and the share of pixels
    whose predictions disagree."""
    ncls = cfg.eval.num_classes
    out_hw, ds_hw = tuple(cfg.eval.out_hw), tuple(cfg.eval.ds_hw)
    eval_apply, _ = build_eval(cfg, weight_dir, device)
    ds = cityscapes_dataset(cfg.data.target_root, cfg.data.val_img_list, cfg.data.val_lbl_list,
                            split="val", resize_hw=out_hw)
    ev = TwoScaleEvaluator(eval_apply, num_classes=ncls, out_hw=out_hw, ds_hw=ds_hw,
                           device=device)
    sd = replay_state_dict(weight_dir, device)

    def up(v):
        return F.interpolate(v, out_hw, mode="bilinear", align_corners=True)

    conf_torch = np.zeros((ncls, ncls), np.int64)
    disagree = []
    n = min(eval_limit or len(ds), len(ds))
    for i in range(n):
        s = ds[i]
        img = s["image"][None]
        lbl = s["label"][None].astype(np.int32)
        pred_ours = ev.update(img, lbl).cpu().numpy()
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))).to(device)
            x_ds = F.interpolate(x, ds_hw, mode="bilinear", align_corners=True)
            logits, _ = segmodel_forward_torch(sd, x, layers=_layers(cfg), num_classes=ncls)
            logits_ds, _ = segmodel_forward_torch(sd, x_ds, layers=_layers(cfg),
                                                  num_classes=ncls)
            pred = torch.maximum(up(logits), up(logits_ds)).argmax(1).cpu().numpy()
        disagree.append(float(np.mean(pred_ours != pred)))
        mask = (lbl >= 0) & (lbl < ncls)
        conf_torch += np.bincount(ncls * lbl[mask].astype(np.int64) + pred[mask],
                                  minlength=ncls * ncls).reshape(ncls, ncls)
    conf_ours = ev.score.confusion.cpu().numpy().astype(np.int64)
    share = float(np.mean(disagree))
    print(f"gate-1: {n} images, pixel disagreement vs torch replay = {share:.2e}; confusion "
          f"L1 gap = {np.abs(conf_ours - conf_torch).sum()} / {conf_ours.sum()} pixels "
          f"({cfg.train.compute_dtype} against the f32 replay)", flush=True)
    return conf_ours, conf_torch, share


def main(argv=None):
    p = base_parser("DiGA parity check against the reference math (PyTorch/CUDA port)")
    p.add_argument("--weight_dir", type=str, required=True)
    p.add_argument("--skip_eval", action="store_true",
                   help="only run the activation diff (no dataset needed)")
    p.add_argument("--vs_torch_replay", action="store_true",
                   help="gate-1: compare the full two-scale eval confusion matrix against the "
                        "torch replay on the same images")
    args = p.parse_args(argv)
    refuse_multi_device(p, args)
    cfg = get_config(args)
    if cfg.extra.get("model", "deeplab") != "deeplab":
        p.error(f"preset {cfg.name} is HRNet+OCR: the replay oracle (models/torch_replay.py) "
                "covers DeepLabV2 only, as the JAX parity_check does")
    device = resolve_device(args.device)

    with no_tf32():
        activation_parity(cfg, args.weight_dir, device)
        if args.vs_torch_replay:
            conf_ours, conf_torch, disagree = eval_confusion_vs_torch(
                cfg, args.weight_dir, device, args.eval_limit or 50)
            if not disagree < GATE:
                raise SystemExit(
                    f"gate-1 FAILED: two-scale eval disagrees with the torch replay on "
                    f"{disagree:.2%} of pixels (threshold {GATE:.1%})")
            return conf_ours, conf_torch, disagree
    if args.skip_eval:
        return None

    from .evaluate_val import main as eval_main

    eval_args = ["--preset", args.preset, "--weight_dir", args.weight_dir,
                 "--device", args.device]
    if args.eval_limit:
        eval_args += ["--eval_limit", str(args.eval_limit)]
    for field in ("target_root", "val_img_list", "val_lbl_list", "compute_dtype"):
        v = getattr(args, field)
        if v:
            eval_args += [f"--{field}", v]
    for item in args.extra:
        eval_args += ["--extra", item]
    return eval_main(eval_args)


if __name__ == "__main__":
    main()
