"""Segmentation trainer CLI: the warm-up, DG and self-training stages.

Counterpart of ``diga_tpu/cli/train_seg.py`` (:50-119), with ``--device``
(default ``cuda``).  One process on one device by default; ``--n_devices
N`` trains data-parallel over N processes of this host, ``--multihost``
as one rank of a torchrun world (``parallel/dist.py``): each rank loads
the recipe batch, so the global batch is the recipe times the world, and
only rank 0 writes.  Full-state checkpoints as the JAX
trainer writes them (``utils/checkpoint.py``): ``--save_every`` N saves
the state to ``<work_dir>/ckpt_final`` every N steps in the background,
each new best mIoU writes ``<work_dir>/weights`` and ``<work_dir>/ckpt_best``
(``on_best``, their one writer),
the end writes ``<work_dir>/ckpt_final``, and ``--resume`` continues from
``<work_dir>/ckpt_final`` where one exists.  ``--pretrained_backbone PATH``
lays a reference ResNet-101 ``.pth`` (the Caffe init, or a
``state_dict``-wrapped checkpoint) over DeepLab's backbone, or an ImageNet
hrnetv2 ``.pth`` over HRNet's (the semi-supervised presets).  Refused,
with a message: ``--pretrained_backbone auto`` (it downloads; the port
fetches nothing), the translator stage (its CLI is
``train_domain_translator``) and the JAX HRNet's TPU knobs (``--extra
hrnet_pad``, ``remat_policy``, ``remat``).  ``--extra fuse_forwards=true``
runs the self-training step in its throughput mode: one teacher and one
student forward a step over the concatenated batches, whose pooled BN
statistics make it differ from the unfused step (not parity-exact).

Usage:
  python -m diga_tpu_torch.cli.train_warm_up --preset gta2city_warmup \\
      --source_root ./data/GTA5 --target_root ./data/Cityscapes \\
      --work_dir ./work_dir/warmup [--load_weight_dir ./work_dir/translator]
  python -m diga_tpu_torch.cli.train_self_training --preset gta2city_selftrain \\
      --load_weight_dir ./work_dir/warmup/weights \\
      --centroid_path ./work_dir/centroids/feat_centroids.npy ...
  python -m diga_tpu_torch.cli.train_warm_up --preset synthia2city_warmup \\
      --source_root ./data/SYNTHIA --target_root ./data/Cityscapes ...
  python -m diga_tpu_torch.cli.train_warm_up --preset semiseg_1_8_warmup \\
      --source_root ./data/Cityscapes --source_list <labeled images> \\
      --target_lbl_list <their labels, in the same order> \\
      --target_root ./data/Cityscapes --target_img_list <unlabeled images> ...
  (``--parity`` on any of them: f32 and the kornia photometric chain;
  ``--resume`` continues a run in the same ``--work_dir``;
  ``--extra fuse_forwards=true`` on a self-training preset)
  python -m diga_tpu_torch.cli.train_warm_up --preset gta2city_warmup --n_devices 8 ...
  torchrun --nnodes 2 --nproc_per_node 8 ... -m diga_tpu_torch.cli.train_warm_up \
      --preset gta2city_warmup --multihost ...
"""

from __future__ import annotations

import os

from ..parallel import dist
from ..train.build import (TRAIN_STAGES, build_experiment, check_model_config,
                           export_state_role_keyed, make_step_config)
from ..train.loop import run_training
from ..utils.checkpoint import restore_train_state, save_train_state
from .common import base_parser, check_world, get_config, rank_device, run_world


def main(argv=None, force_stage: str | None = None):
    p = base_parser("DiGA segmentation training (PyTorch/CUDA port)")
    p.add_argument("--load_weight_dir", type=str, default=None,
                   help="previous-stage role-keyed weights (enc_s/dec_s2t and/or student)")
    p.add_argument("--centroid_path", type=str, default=None,
                   help="initial class centroids of the self-training stage (.npy or a "
                        "torch-saved tensor, e.g. calc_centroids' output)")
    p.add_argument("--pretrained_backbone", type=str, default=None,
                   help="backbone init .pth: the Caffe ResNet-101 (raw ResNetMulti keys), or "
                        "a SegModel-layout or state_dict-wrapped checkpoint; for HRNet the "
                        "ImageNet hrnetv2 file; 'auto' (a download) is refused")
    p.add_argument("--save_every", type=int, default=2000,
                   help="periodic full-state checkpoint to <work_dir>/ckpt_final (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="restore the full train state (weights, momentum, step, centroids, "
                        "generators) from <work_dir>/ckpt_final if present")
    args = p.parse_args(argv)
    check_world(p, args)
    if args.pretrained_backbone == "auto":
        p.error("--pretrained_backbone auto downloads the Caffe ResNet-101 init, which the port "
                "does not do: fetch the file elsewhere and pass its path")
    cfg = get_config(args)
    if force_stage is not None and cfg.stage != force_stage:
        p.error(f"preset {cfg.name} is stage {cfg.stage!r}, expected {force_stage!r}")
    if cfg.stage not in TRAIN_STAGES:
        p.error(f"stage {cfg.stage!r}: this CLI trains the stages {TRAIN_STAGES}; the "
                "translator stage is python -m diga_tpu_torch.cli.train_domain_translator")
    try:
        make_step_config(cfg)
        check_model_config(cfg)
    except (NotImplementedError, ValueError) as e:
        p.error(str(e))
    return run_world(args, train, cfg, args)


def train(cfg, args):
    """Build, train and save on this rank (every rank of a world runs it)."""
    device = rank_device(args)
    if dist.active():
        print(f"rank {dist.rank()} of world {dist.world()}, backend {dist.backend()}, on "
              f"{device}", flush=True)
    state, step, eval_apply = build_experiment(cfg, device, args.load_weight_dir,
                                               args.centroid_path, args.pretrained_backbone)
    ckpt_final = os.path.join(args.work_dir, "ckpt_final")
    if args.resume and os.path.exists(ckpt_final):  # every rank restores
        restore_train_state(ckpt_final, state)
        if dist.is_writer():
            print(f"resumed from {ckpt_final} at step {state.step}", flush=True)

    def on_best(state, i, miou):
        export_state_role_keyed(state, os.path.join(args.work_dir, "weights"))
        save_train_state(os.path.join(args.work_dir, "ckpt_best"), state)
        print(f"saved best weights and checkpoint at step {i} (mIoU {miou:.4f})", flush=True)

    result = run_training(cfg, state, step, eval_apply, work_dir=args.work_dir, device=device,
                          num_steps=args.num_steps, eval_limit=args.eval_limit, on_best=on_best,
                          save_every=args.save_every, save_path=ckpt_final)
    if not dist.is_writer():
        return result
    save_train_state(ckpt_final, state)
    if result.best_miou > 0:
        where = f"best weights in {args.work_dir}/weights and {args.work_dir}/ckpt_best"
    else:  # as the JAX trainer: no eval scored above 0, so no <work_dir>/weights
        where = "no best weights (no eval above mIoU 0)"
    print(f"done: best mIoU {result.best_miou:.4f} @ step {result.best_step}; {where}; the "
          f"final state (step {state.step}) in {ckpt_final}", flush=True)
    return result


if __name__ == "__main__":
    main()
