"""Segmentation trainer CLI: the warm-up, DG and self-training stages.

Counterpart of ``diga_tpu/cli/train_seg.py`` (:50-119) on one device, with
``--device`` (default ``cuda``).  Refused, with a message, until their
slices land: ``--resume`` (full-state checkpoints), ``--pretrained_backbone``
(the Caffe ResNet-101 init is not in the repository and nothing is
downloaded), the multi-device flags, the translator stage, and the step
options that are not ported (``--extra fuse_forwards``, the semiseg knobs).

Usage:
  python -m diga_tpu_torch.cli.train_warm_up --preset gta2city_warmup \\
      --source_root ./data/GTA5 --target_root ./data/Cityscapes \\
      --work_dir ./work_dir/warmup [--load_weight_dir ./work_dir/translator]
  python -m diga_tpu_torch.cli.train_self_training --preset gta2city_selftrain \\
      --load_weight_dir ./work_dir/warmup/weights \\
      --centroid_path ./work_dir/centroids/feat_centroids.npy ...
  python -m diga_tpu_torch.cli.train_warm_up --preset synthia2city_warmup \\
      --source_root ./data/SYNTHIA --target_root ./data/Cityscapes ...
  (``--parity`` on any of them: f32 and the kornia photometric chain)
"""

from __future__ import annotations

from .. import resolve_device
from ..train.build import TRAIN_STAGES, build_experiment, make_step_config
from ..train.loop import run_training
from .common import base_parser, get_config, refuse_multi_device


def main(argv=None, force_stage: str | None = None):
    p = base_parser("DiGA segmentation training (PyTorch/CUDA port)")
    p.add_argument("--load_weight_dir", type=str, default=None,
                   help="previous-stage role-keyed weights (enc_s/dec_s2t and/or student)")
    p.add_argument("--centroid_path", type=str, default=None,
                   help="initial class centroids of the self-training stage (.npy or a "
                        "torch-saved tensor, e.g. calc_centroids' output)")
    p.add_argument("--pretrained_backbone", type=str, default=None,
                   help="not supported yet: the Caffe ResNet-101 init (ROADMAP queue A item 11)")
    p.add_argument("--resume", action="store_true",
                   help="not supported yet: full-state resume (ROADMAP queue A item 11)")
    args = p.parse_args(argv)
    refuse_multi_device(p, args)
    if args.resume:
        p.error("--resume is not supported by the port yet (full-state checkpoints, "
                "ROADMAP queue A item 11)")
    if args.pretrained_backbone is not None:
        p.error("--pretrained_backbone is not supported by the port yet: the Caffe "
                "ResNet-101 init is not in the repository and the port downloads nothing "
                "(ROADMAP queue A item 11)")
    cfg = get_config(args)
    if force_stage is not None and cfg.stage != force_stage:
        p.error(f"preset {cfg.name} is stage {cfg.stage!r}, expected {force_stage!r}")
    if cfg.stage not in TRAIN_STAGES:
        p.error(f"stage {cfg.stage!r} is not ported yet; the port trains the stages "
                f"{TRAIN_STAGES} (translator training is ROADMAP queue A item 13)")
    try:
        make_step_config(cfg)
    except (NotImplementedError, ValueError) as e:
        p.error(str(e))
    device = resolve_device(args.device)
    state, step, eval_apply = build_experiment(cfg, device, args.load_weight_dir,
                                               args.centroid_path)
    result = run_training(cfg, state, step, eval_apply, work_dir=args.work_dir, device=device,
                          num_steps=args.num_steps, eval_limit=args.eval_limit)
    if result.best_miou > 0:
        where = (f"best weights in {args.work_dir}/weights, the last step's in "
                 f"{args.work_dir}/weights_final")
    else:  # as the JAX trainer: no eval scored above 0, so no <work_dir>/weights
        where = (f"no best weights (no eval above mIoU 0); the last step's in "
                 f"{args.work_dir}/weights_final")
    print(f"done: best mIoU {result.best_miou:.4f} @ step {result.best_step}; {where}",
          flush=True)
    return result


if __name__ == "__main__":
    main()
