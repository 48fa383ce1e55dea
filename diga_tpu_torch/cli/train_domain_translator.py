"""Train the CycleGAN-style image domain translator (the UDA pipeline's first stage).

Counterpart of ``diga_tpu/cli/train_domain_translator.py`` on one device,
with ``--device`` (default ``cuda``): six Adam(0.5, 0.999) optimizers at
the preset's LR, each poly-decayed (power 0.9) every step, on batches of
1 small + 1 full-resize image per domain (reference
train_domain_translator.py:73-79,105-115,149-170,210-214).  The module
widths and loss weights come from the preset's ``--extra`` keys:
``enc_dim``, ``dec_dim``, ``n_downsample``, ``n_res``, ``dis_dim``,
``dis_layers``, ``dis_scales``, ``subpixel_up``, ``lambda_*``,
``translator_remat``.  It logs every
50 steps, writes the six roles (``enc_s``, ``enc_t``, ``dec_s2t``,
``dec_t2s``, ``dis_s2t``, ``dis_t2s``) to ``<work_dir>/weights`` every
``--save_every`` steps and at the end, and the full state (the six roles,
the six Adam states and the step) to ``<work_dir>/ckpt_final``.  The
warm-up reads ``--load_weight_dir <work_dir>/weights``.  As in JAX, there
is no ``--resume``.

  python -m diga_tpu_torch.cli.train_domain_translator --preset gta2city_translator \\
      --source_root ./data/GTA5 --target_root ./data/Cityscapes \\
      --work_dir ./work_dir/translator [--vgg_weights vgg19.pth]
"""

from __future__ import annotations

import copy
import os

import torch
import torch.nn as nn

from .. import resolve_device
from ..configs.presets import ExperimentConfig
from ..models.convert import load_torch_state_dict
from ..models.translator import Discriminator, ImgDecoder, ImgEncoder
from ..models.vgg import VGG19Features
from ..train.build import compute_dtype, seeded
from ..train.loop import make_translator_iterator, to_device
from ..train.schedules import poly_schedule
from ..train.steps_translator import (ROLES, TranslatorConfig, TranslatorState,
                                      build_translator_step, create_translator_state)
from ..utils.checkpoint import export_role_keyed, save_train_state
from ..utils.logging import MetricLogger
from .common import base_parser, get_config, refuse_multi_device


def translator_config(cfg: ExperimentConfig, with_vgg: bool) -> TranslatorConfig:
    ex = cfg.extra.get
    return TranslatorConfig(
        lambda_adv=ex("lambda_adv", 0.5), lambda_cyc=ex("lambda_cyc", 10.0),
        lambda_seg_edge=ex("lambda_seg_edge", 20.0),
        lambda_percep=ex("lambda_percep", 0.1) if with_vgg else 0.0,
        lambda_self=ex("lambda_self", 0.001),
        remat=ex("translator_remat", None),  # None = on only with the perceptual term
        compute_dtype=compute_dtype(cfg))


def make_translator(cfg: ExperimentConfig) -> nn.ModuleDict:
    """The six modules at the preset's widths (the reference architecture by
    default).  One encoder, decoder and discriminator are drawn from
    PyTorch's default init (kaiming-uniform convs) under ``cfg.train.seed``
    and each pair's second member is a copy of the first, so the pairs
    start equal, as the JAX package initialises both members of a pair from
    one key (``diga_tpu/train/steps_translator.py:62-77``)."""
    ex = cfg.extra.get
    with seeded(cfg.train.seed):
        enc = ImgEncoder(dim=ex("enc_dim", 64), n_downsample=ex("n_downsample", 2),
                         n_res=ex("n_res", 4))
        dec = ImgDecoder(dim=ex("dec_dim", 256), n_upsample=ex("n_downsample", 2),
                         n_res=ex("n_res", 4), subpixel_up=ex("subpixel_up", True))
        dis = Discriminator(dim=ex("dis_dim", 64), n_layer=ex("dis_layers", 4),
                            num_scales=ex("dis_scales", 3))
    return nn.ModuleDict({"enc_s": enc, "enc_t": copy.deepcopy(enc),
                          "dec_s2t": dec, "dec_t2s": copy.deepcopy(dec),
                          "dis_s2t": dis, "dis_t2s": copy.deepcopy(dis)})


def build_translator_experiment(cfg: ExperimentConfig, device: torch.device,
                                vgg_weights: str | None = None):
    """(state, step) of the translator stage on ``device``; the LR decays
    over ``cfg.train.num_steps``."""
    modules = make_translator(cfg).to(device)
    vgg = None
    if vgg_weights:
        vgg = VGG19Features().load_torchvision(load_torch_state_dict(vgg_weights)).to(device)
    state = create_translator_state(modules, cfg.train.learning_rate, vgg)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes: let cuDNN time its algorithms
    step = build_translator_step(translator_config(cfg, vgg is not None),
                                 poly_schedule(cfg.train.learning_rate, cfg.train.num_steps),
                                 with_vgg=vgg is not None)
    return state, step


def export_translator(state: TranslatorState, weight_dir: str) -> None:
    """The six roles as reference ``.pth`` files."""
    export_role_keyed(weight_dir, {r: state.modules[r].state_dict() for r in ROLES})


def main(argv=None) -> dict[str, float]:
    p = base_parser("DiGA domain translator training (PyTorch/CUDA port)")
    p.add_argument("--vgg_weights", type=str, default=None,
                   help="torchvision vgg19 state_dict (.pth) for the perceptual loss; "
                        "without it that term is off")
    p.add_argument("--save_every", type=int, default=2000,
                   help="export the six roles to <work_dir>/weights every N steps")
    args = p.parse_args(argv)
    refuse_multi_device(p, args)
    cfg = get_config(args)
    if cfg.stage != "translator":
        p.error(f"preset {cfg.name} is stage {cfg.stage!r}, expected 'translator'")
    device = resolve_device(args.device)
    state, step = build_translator_experiment(cfg, device, args.vgg_weights)
    it, loaders = make_translator_iterator(cfg)
    logger = MetricLogger(args.work_dir)
    weight_dir = os.path.join(args.work_dir, "weights")
    steps = cfg.train.num_steps
    metrics: dict = {}
    try:
        for i in range(steps):
            metrics = step(state, to_device(next(it), device))
            if i % 50 == 0:
                host = {k: float(v) for k, v in metrics.items()}
                logger.log(i, host)
                logger.print(i, host)
            if args.save_every and i > 0 and i % args.save_every == 0:
                export_translator(state, weight_dir)
    finally:
        for ld in loaders:
            ld.stop()
        logger.close()
    export_translator(state, weight_dir)
    save_train_state(os.path.join(args.work_dir, "ckpt_final"), state)
    print(f"translator training done ({steps} steps); weights in {weight_dir}, the final "
          f"state in {os.path.join(args.work_dir, 'ckpt_final')}", flush=True)
    return {k: float(v) for k, v in metrics.items()}


if __name__ == "__main__":
    main()
