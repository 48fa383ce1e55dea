"""Compute the class feature centroids (prototypes) for self-training.

Counterpart of ``diga_tpu/cli/calc_centroids.py`` (:24-119), the reference
calc_centroids.py:17-81: several epochs over the target train set (the
default, after the warm-up) or, with ``--source``, over the GTA5 or
SYNTHIA source set mixed by the frozen translator and CrDoMix with its
labels, accumulating per-class masked feature means with 'mean' updates.
The model is ``build_eval``'s frozen eval model (DeepLab's GroupNorm on the
kernel B2a/B2b on the card; HRNet+OCR for the semi-supervised presets,
whose centroids are 512-d); the centroids stay on the device until they
are saved.  The CrDoMix selections come from a ``torch.Generator`` seeded
with the preset's seed.

As in the JAX CLI (:42-46), the model sees the image as the dataset gives
it, BGR, even for an ``rgb_input`` preset, unlike the eval and the
pseudo-labels (ROADMAP question D3).  ``--source`` on a Cityscapes source
(the semi-supervised presets) is refused: the JAX CLI runs the translator
there on a state that has none (``train/build.py:170-174``) and fails.

Writes ``feat_centroids.npy`` and, for the reference, the torch tensor
file ``feat_centroids``.

Usage:
  python -m diga_tpu_torch.cli.calc_centroids --preset gta2city_warmup \\
      --weight_dir ./work_dir/warmup/weights --target_root ./data/Cityscapes \\
      --centroid_dir ./work_dir/centroids
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..data import cityscapes_dataset, gta5_dataset, synthia_dataset
from ..models.translator import translate
from ..ops.mixing import crdomix, sample_half_classes
from ..ops.prototypes import Centroids, masked_class_means, update_centroids
from ..train.build import build_eval, compute_dtype, init_translator_frozen
from .common import base_parser, get_config, refuse_multi_device


def main(argv=None):
    p = base_parser("DiGA class centroid computation (PyTorch/CUDA port)")
    p.add_argument("--weight_dir", type=str, default=None,
                   help="role-keyed .pth dir (student.pth, and enc_s/dec_s2t for --source)")
    p.add_argument("--centroid_dir", type=str, required=True)
    p.add_argument("--source", action="store_true",
                   help="compute on the CrDoMix'd source (reference --source)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    refuse_multi_device(p, args)
    device = resolve_device(args.device)
    cfg = get_config(args)
    spec = cfg.data.source_streams[0]
    sources = {"gta5": gta5_dataset, "synthia": synthia_dataset}
    if args.source and spec.kind not in sources:
        p.error(f"--source on a {spec.kind!r} source: preset {cfg.name} has no image "
                "translator, and the reference --source path mixes the source through one "
                "(the JAX package's calc_centroids --source fails on it too); compute "
                "the centroids on the target, without --source")
    _, model = build_eval(cfg, args.weight_dir, device)
    k = cfg.train.num_classes
    cents = Centroids.create(k, cfg.extra.get("feat_dim", 256), device)

    if args.source:
        ds = sources[spec.kind](cfg.data.source_root, cfg.data.source_list,
                                resize_hw=spec.resize_hw)
        translator = init_translator_frozen(cfg, args.weight_dir, device).requires_grad_(False)
        dtype = compute_dtype(cfg)
        amp = torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32)
        gen = torch.Generator(device=device).manual_seed(cfg.train.seed)

        def model_input(image, label):
            with amp:
                rec = translate(translator, image)
            return crdomix(rec, image, label, sample_half_classes(label, gen, k), k)
    else:
        ds = cityscapes_dataset(cfg.data.target_root, cfg.data.target_img_list,
                                cfg.data.target_lbl_list, split="train",
                                resize_hw=cfg.data.target_streams[0].resize_hw)

        def model_input(image, label):
            return image

    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    for epoch in range(args.epochs):
        for i in range(n):
            s = ds[i]
            image = torch.from_numpy(s["image"][None]).to(device)
            label = torch.from_numpy(s["label"][None].astype(np.int32)).to(device)
            with torch.inference_mode():
                _, _, logits, feat = model(model_input(image, label).permute(0, 3, 1, 2))
                # prediction-masked means; the source's also masked by its labels
                vec, ok = masked_class_means(feat.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1),
                                             label if args.source else None)
                cents = update_centroids(cents, vec, ok, start_mean=True)
            if i % 100 == 0:
                print(f"epoch {epoch}: {i} processed", flush=True)

    os.makedirs(args.centroid_dir, exist_ok=True)
    vectors = cents.vectors.cpu()
    np.save(os.path.join(args.centroid_dir, "feat_centroids.npy"), vectors.numpy())
    torch.save(vectors, os.path.join(args.centroid_dir, "feat_centroids"))
    print(f"saved centroids {tuple(vectors.shape)} to {args.centroid_dir}", flush=True)
    return cents


if __name__ == "__main__":
    main()
