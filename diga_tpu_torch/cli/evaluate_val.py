"""Evaluate a segmentation checkpoint with two-scale max-merge mIoU.

Counterpart of ``diga_tpu/cli/evaluate_val.py`` (the reference
evaluate_val.py and its DG multi-dataset variant,
domain_generalization/evaluate_val.py:71-130), on one device.

Usage:
  python -m diga_tpu_torch.cli.evaluate_val --preset gta2city_warmup \
      --weight_dir ./work_dir/weights --target_root ./data/Cityscapes
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..data import bdd_dataset, cityscapes_dataset, mapillary_dataset
from ..data.label_maps import CLASS_NAMES_16, CLASS_NAMES_19
from ..eval.evaluator import TwoScaleEvaluator
from ..train.build import build_eval
from .common import base_parser, get_config, refuse_multi_device

_DATASETS = {"cityscapes": cityscapes_dataset, "bdd": bdd_dataset,
             "mapillary": mapillary_dataset}


def iter_val(ds, limit=None, batch=1):
    """Fixed-shape batches of ``batch`` images.  The final partial batch is
    padded by repeating the last image with all-ignore (255) labels, which
    contribute nothing to the confusion matrix; ``names`` lists only the
    real entries so prediction dumps skip the padding."""
    n = len(ds) if limit is None else min(limit, len(ds))
    for start in range(0, n, batch):
        samples = [ds[i] for i in range(start, min(start + batch, n))]
        k = len(samples)
        images = [s["image"] for s in samples]
        labels = [s["label"].astype(np.int32) for s in samples]
        while len(images) < batch:
            images.append(images[-1])
            labels.append(np.full_like(labels[-1], 255))
        yield {"image": np.stack(images), "label": np.stack(labels),
               "names": [s["name"] for s in samples], "valid": k}


def main(argv=None):
    p = base_parser("DiGA two-scale evaluation (PyTorch/CUDA port)")
    p.add_argument("--weight_dir", type=str, default=None,
                   help="role-keyed .pth dir (student.pth) to evaluate")
    p.add_argument("--datasets", type=str, default="cityscapes",
                   help="comma list: cityscapes,bdd,mapillary (DG eval)")
    for d in _DATASETS:
        p.add_argument(f"--{d}_root", type=str, default=None)
        p.add_argument(f"--{d}_img_list", type=str, default=None)
        p.add_argument(f"--{d}_lbl_list", type=str, default=None)
    p.add_argument("--dump_preds", type=str, default=None,
                   help="directory to write per-image trainId prediction PNGs; "
                        "one subdir per dataset when evaluating several")
    p.add_argument("--shard", type=str, default="batch", choices=["batch", "spatial"],
                   help="'spatial' (height-sharded eval) belongs to the multi-GPU "
                        "slice and is refused")
    p.add_argument("--eval_batch", type=int, default=1, help="images per eval step")
    args = p.parse_args(argv)
    refuse_multi_device(p, args)
    if args.shard == "spatial":
        p.error("--shard spatial is not supported by the port yet (multi-GPU slice)")
    device = resolve_device(args.device)
    cfg = get_config(args)

    eval_apply, _ = build_eval(cfg, args.weight_dir, device)

    eval_sets = cfg.extra.get("eval_datasets", {
        "cityscapes": {"out_hw": cfg.eval.out_hw, "ds_hw": cfg.eval.ds_hw}
    })
    dataset_names = args.datasets.split(",")
    results = {}
    for name in dataset_names:
        if name not in _DATASETS:
            raise ValueError(f"unknown dataset {name!r}; choose from {sorted(_DATASETS)}")
        spec = eval_sets[name]
        root = getattr(args, f"{name}_root") or cfg.data.target_root
        img_list = getattr(args, f"{name}_img_list") or cfg.data.val_img_list
        lbl_list = getattr(args, f"{name}_lbl_list") or cfg.data.val_lbl_list
        ds = _DATASETS[name](root, img_list, lbl_list, resize_hw=spec["out_hw"])
        ev = TwoScaleEvaluator(eval_apply, num_classes=cfg.eval.num_classes,
                               out_hw=tuple(spec["out_hw"]), ds_hw=tuple(spec["ds_hw"]),
                               device=device)
        dump_dir = None
        if args.dump_preds:
            dump_dir = (args.dump_preds if len(dataset_names) == 1
                        else os.path.join(args.dump_preds, name))
            os.makedirs(dump_dir, exist_ok=True)
        for i, batch in enumerate(iter_val(ds, args.eval_limit, batch=args.eval_batch)):
            pred = ev.update(batch["image"], batch["label"])
            if dump_dir is not None:
                from PIL import Image

                pred_np = pred[:batch["valid"]].to(torch.uint8).cpu().numpy()
                for j, bname in enumerate(batch["names"]):
                    base = os.path.splitext(os.path.basename(bname))[0]
                    Image.fromarray(pred_np[j]).save(os.path.join(dump_dir, base + ".png"))
            if i % 50 == 0:
                print(f"eval: {i} batches processed", flush=True)
        scores, cls_iu = ev.score.get_scores()
        names = CLASS_NAMES_19 if cfg.eval.num_classes == 19 else CLASS_NAMES_16
        for i, cname in enumerate(names):
            print(f"===>{cname}: {cls_iu[i]}")
        for k, v in scores.items():
            print(f"{name} {k}: {v}")
        results[name] = scores
    return results


if __name__ == "__main__":
    main()
