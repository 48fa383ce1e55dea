"""Evaluate a segmentation checkpoint with two-scale max-merge mIoU.

Counterpart of ``diga_tpu/cli/evaluate_val.py`` (the reference
evaluate_val.py and its DG multi-dataset variant,
domain_generalization/evaluate_val.py:71-130).  One process on one device
by default; ``--n_devices N`` (or ``--multihost`` under torchrun) shards
every eval batch of N x ``--eval_batch`` images over the ranks, each
scoring ``--eval_batch`` of them, and sums the confusion matrix over the
ranks: the scores equal one process's exactly.  Each rank writes the
``--dump_preds`` PNGs of its own images.  ``--shard spatial`` (under
``--n_devices N`` or ``--multihost``) splits every image's height over the
ranks instead (``parallel/spatial.py``): every rank reads the image and
keeps its rows, the confusion counts are summed over the ranks, and rank 0
writes each whole ``--dump_preds`` PNG from the rows gathered to it.  As in
JAX it needs a world, ``--eval_batch 1`` and an eval height that divides by
the ranks.

Usage:
  python -m diga_tpu_torch.cli.evaluate_val --preset gta2city_warmup \
      --weight_dir ./work_dir/weights --target_root ./data/Cityscapes [--n_devices 8]
"""

from __future__ import annotations

import os

import torch

from ..data import bdd_dataset, cityscapes_dataset, mapillary_dataset
from ..data.label_maps import CLASS_NAMES_16, CLASS_NAMES_19
from ..eval.evaluator import TwoScaleEvaluator, iter_val
from ..train.build import build_eval
from ..parallel import dist
from ..parallel.spatial_ops import convert_spatial
from .common import base_parser, check_world, get_config, rank_device, run_world

_DATASETS = {"cityscapes": cityscapes_dataset, "bdd": bdd_dataset,
             "mapillary": mapillary_dataset}


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
                   help="'batch': each rank scores its images of every eval batch; "
                        "'spatial' + --n_devices: the image HEIGHT split over the ranks, "
                        "each computing its rows (conv halos exchanged by hand)")
    p.add_argument("--eval_batch", type=int, default=1,
                   help="images per eval step of each process")
    args = p.parse_args(argv)
    check_world(p, args)
    cfg = get_config(args)
    if args.shard == "spatial":
        check_spatial(p, args, cfg)
    return run_world(args, evaluate, cfg, args)


def _eval_sets(cfg) -> dict:
    return cfg.extra.get("eval_datasets", {
        "cityscapes": {"out_hw": cfg.eval.out_hw, "ds_hw": cfg.eval.ds_hw}
    })


def check_spatial(p, args, cfg) -> None:
    """JAX's refusals of a height-sharded eval (``diga_tpu/cli/evaluate_val.py:
    72-78``), the height its ``device_put`` would refuse, and MiT, whose
    attention runs over the whole image and has no sharded form."""
    if cfg.extra.get("model") == "mit_daformer":
        p.error("--shard spatial: MiTDAFormer's attention spans the whole image; it has no "
                "height-sharded form (use --shard batch)")
    if args.n_devices is None and not args.multihost:
        p.error("--shard spatial requires --n_devices or --multihost (no world was formed, "
                "so the evaluator would silently run unsharded)")
    if args.eval_batch != 1:
        p.error("--shard spatial evaluates single-image batches; --eval_batch applies to "
                "--shard batch")
    n = args.n_devices or int(dist.torchrun_env()["WORLD_SIZE"])
    sets = _eval_sets(cfg)
    for name in args.datasets.split(","):
        if name in sets and sets[name]["out_hw"][0] % n:
            p.error(f"--shard spatial: the {name} eval height {sets[name]['out_hw'][0]} does "
                    f"not divide by the {n} ranks")


def evaluate(cfg, args) -> dict:
    """Score every dataset on this rank's share of the images."""
    device = rank_device(args)

    eval_apply, model = build_eval(cfg, args.weight_dir, device)
    spatial = args.shard == "spatial"
    if spatial:
        convert_spatial(model)
    # height-sharded, every rank takes every image; batch-sharded, its own
    rank, world = (0, 1) if spatial else (dist.rank(), dist.world())

    eval_sets = _eval_sets(cfg)
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
                               device=device, shard=args.shard)
        dump_dir = None
        if args.dump_preds:
            dump_dir = (args.dump_preds if len(dataset_names) == 1
                        else os.path.join(args.dump_preds, name))
            os.makedirs(dump_dir, exist_ok=True)
        for i, batch in enumerate(iter_val(ds, args.eval_limit, batch=args.eval_batch,
                                           rank=rank, world=world)):
            pred = ev.update(batch["image"], batch["label"])
            if dump_dir is not None and spatial:
                pred = ev.spatial.gather_rows(pred)  # every rank's rows, to the writer
            if dump_dir is not None and (dist.is_writer() or not spatial):
                from PIL import Image

                pred_np = pred[:batch["valid"]].to(torch.uint8).cpu().numpy()
                for j, bname in enumerate(batch["names"]):
                    base = os.path.splitext(os.path.basename(bname))[0]
                    Image.fromarray(pred_np[j]).save(os.path.join(dump_dir, base + ".png"))
            if i % 50 == 0 and dist.is_writer():
                print(f"eval: {i} batches processed", flush=True)
        scores, cls_iu = ev.score.get_scores()
        results[name] = scores
        if not dist.is_writer():
            continue
        names = CLASS_NAMES_19 if cfg.eval.num_classes == 19 else CLASS_NAMES_16
        for i, cname in enumerate(names):
            print(f"===>{cname}: {cls_iu[i]}")
        for k, v in scores.items():
            print(f"{name} {k}: {v}")
    return results


if __name__ == "__main__":
    main()
