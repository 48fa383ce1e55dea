"""Write two-scale max-merged pseudo-labels as palette PNGs.

Counterpart of ``diga_tpu/cli/pseudolabel_generator.py`` (:26-64), the
reference pseudolabel_generator.py:52-105: for every target train image,
the argmax of max(upsample(f(x)), upsample(f(x_down))) as a P-mode PNG
with the Cityscapes (or SYNTHIA) palette, named by the image's basename,
so the files round-trip through the self-training loader
(CityLoader.py:130-132).  The model is ``build_eval``'s frozen eval model,
so its GroupNorm runs on the kernel B2a/B2b on the card; only the uint8
label map leaves the device.

Usage:
  python -m diga_tpu_torch.cli.pseudolabel_generator --preset gta2city_warmup \\
      --weight_dir ./work_dir/warmup/weights --target_root ./data/Cityscapes \\
      --output_dir ./data/Cityscapes/pseudo_train_warm_up
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch
from PIL import Image

from .. import resolve_device
from ..data import cityscapes_dataset
from ..data.label_maps import CITYSCAPES_COLORS_19, SYNTHIA_COLORS_16, make_png_palette
from ..eval.evaluator import two_scale_logits
from ..train.build import build_eval
from .common import base_parser, get_config, refuse_multi_device


def predict_labels(eval_apply: Callable, image: torch.Tensor, out_hw, ds_hw) -> torch.Tensor:
    """(B, H, W) uint8 argmax of the two-scale max-merged logits."""
    with torch.inference_mode():
        merged = two_scale_logits(eval_apply, image, out_hw, ds_hw)
        return torch.argmax(merged, dim=-1).to(torch.uint8)


def main(argv=None):
    p = base_parser("DiGA pseudo-label generation (PyTorch/CUDA port)")
    p.add_argument("--weight_dir", type=str, default=None,
                   help="role-keyed .pth dir (student.pth) of the labelling model")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    refuse_multi_device(p, args)
    device = resolve_device(args.device)
    cfg = get_config(args)
    eval_apply, _ = build_eval(cfg, args.weight_dir, device)
    ds = cityscapes_dataset(cfg.data.target_root, cfg.data.target_img_list,
                            cfg.data.target_lbl_list, split="train", resize_hw=cfg.eval.out_hw)
    colors = CITYSCAPES_COLORS_19 if cfg.eval.num_classes == 19 else SYNTHIA_COLORS_16
    palette = make_png_palette(colors)
    os.makedirs(args.output_dir, exist_ok=True)
    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    for i in range(n):
        s = ds[i]
        image = torch.from_numpy(s["image"][None]).to(device)
        label = predict_labels(eval_apply, image, cfg.eval.out_hw, cfg.eval.ds_hw)
        img = Image.fromarray(np.asarray(label[0].cpu())).convert("P")
        img.putpalette(palette)
        img.save(os.path.join(args.output_dir, os.path.basename(s["name"])))
        if i % 100 == 0:
            print(f"{i} processed", flush=True)
    print(f"wrote {n} pseudo-labels to {args.output_dir}", flush=True)
    return n


if __name__ == "__main__":
    main()
