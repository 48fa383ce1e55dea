"""Assemble models, optimizer, state and the step from a preset config.

Counterpart of ``diga_tpu/train/build.py``: ``make_model`` (:31-58: DeepLabV2,
or HRNet-W48/W32+OCR for the semi-supervised presets),
``make_schedule``/``make_step_config``/``wants_target`` (:61-108), the
translator helpers (:111-140), ``build_experiment`` (:143-279) for the
warm-up, DG and self-training stages, and ``export_state_role_keyed``
(:289-313); previous-stage weights come from role-keyed ``.pth`` files,
a reference ResNet-101 ``.pth`` (DeepLab) or an ImageNet hrnetv2 ``.pth``
(HRNet) initialises the backbone (``--pretrained_backbone``, :202-218),
and the self-training centroids
come from ``calc_centroids``' output (reference stage chaining).  ``build_eval`` is
the frozen eval model of ``evaluate_val``.

Parameters are f32; the compute dtype is applied by ``torch.autocast``
around the forwards (the JAX model casts its params at use).  Only the
frozen eval model of ``build_eval`` is cast in place.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..configs.presets import ExperimentConfig
from ..models.convert import (hrnet_imagenet_state_dict, load_torch_state_dict,
                              pretrained_backbone_state_dict)
from ..models.hrnet_ocr import ARCHS, HRNetOCR
from ..models.resnet_deeplab import DeepLabV2
from ..models.translator import ImgDecoder, ImgEncoder
from ..ops.prototypes import Centroids
from ..parallel import dist
from ..parallel.sync_bn import convert_sync_bn
from ..utils.checkpoint import export_role_keyed, load_role_keyed
from ..utils.profiling import span
from .optim import sgd_grouped
from .schedules import poly_schedule, poly_warmup_schedule
from .state import SegModel, SegTrainState, create_seg_state, reference_state_dict
from .steps import StepConfig, build_dg_step, build_selftrain_step, build_warmup_step


def compute_dtype(cfg: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


@contextlib.contextmanager
def seeded(seed: int):
    """Draw module inits from ``seed`` without touching the caller's RNG."""
    gen_state = torch.random.get_rng_state()
    torch.manual_seed(seed)
    try:
        yield
    finally:
        torch.random.set_rng_state(gen_state)


# the JAX HRNet's TPU memory and layout knobs (diga_tpu/models/hrnet_ocr.py
# :68-181,293-318); an 80 GB card runs the model without them
_HRNET_TPU_KNOBS = ("hrnet_pad", "remat_policy", "remat")


def check_model_config(cfg: ExperimentConfig) -> None:
    """Raise on a model choice the port does not build: an unknown model or
    HRNet arch, or a TPU knob of the JAX HRNet."""
    kind = cfg.extra.get("model", "deeplab")
    if kind not in ("deeplab", "hrnet_ocr"):
        raise ValueError(f"--extra model={kind!r}: expected 'deeplab' or 'hrnet_ocr'")
    if kind == "hrnet_ocr":
        for key in _HRNET_TPU_KNOBS:
            if cfg.extra.get(key):
                raise NotImplementedError(
                    f"--extra {key} is a TPU memory/layout knob of the JAX HRNet and is not "
                    "ported: the port runs HRNet-W48+OCR without it")
        arch = cfg.extra.get("hrnet_arch", "w48")
        if arch not in ARCHS:
            raise ValueError(f"--extra hrnet_arch={arch!r}: expected one of {sorted(ARCHS)}")


def make_model(cfg: ExperimentConfig) -> SegModel:
    """The preset's model at its class count: DeepLabV2 (``extra['layers']``
    for tiny depths), or HRNetOCR for ``extra['model'] == 'hrnet_ocr'``
    (``extra['hrnet_arch']`` ``w48`` or ``w32``)."""
    check_model_config(cfg)
    if cfg.extra.get("model", "deeplab") == "hrnet_ocr":
        return HRNetOCR(num_classes=cfg.train.num_classes,
                        arch=ARCHS[cfg.extra.get("hrnet_arch", "w48")])
    layers = tuple(cfg.extra.get("layers", (3, 4, 23, 3)))
    return DeepLabV2(num_classes=cfg.train.num_classes, layers=layers)


def _use_benchmark_convs(device: torch.device) -> None:
    if device.type == "cuda":
        # a few fixed shapes run many times: let cuDNN time its algorithms
        # once per shape.  Its heuristic choice for the dilated ASPP convs
        # is a direct kernel that made the two-scale eval take seconds per
        # image (chip_smoke.py --profile on an H100).
        torch.backends.cudnn.benchmark = True


def _eval_apply(model: SegModel, rgb_input: bool, amp_dtype: torch.dtype | None) -> Callable:
    """``eval_apply(image_nhwc) -> logits_nhwc`` with ``model`` in eval mode
    for the call (a training model goes back to train mode after it); the
    forward runs in a span named after the model's class, as the steps'."""

    def eval_apply(img: torch.Tensor) -> torch.Tensor:
        if rgb_input:
            # semiseg feeds RGB (BGR->RGB flip at model input,
            # semi-supervised_segmentation/evaluate_val.py:76)
            img = torch.flip(img, dims=(-1,))
        was_training = model.training
        model.eval()
        try:
            amp = (torch.autocast(device_type=img.device.type, dtype=amp_dtype)
                   if amp_dtype is not None else contextlib.nullcontext())
            with amp, span(type(model).__name__):
                _, _, logits, _ = model(img.permute(0, 3, 1, 2))
        finally:
            model.train(was_training)
        return logits.permute(0, 2, 3, 1)

    return eval_apply


def build_eval(cfg: ExperimentConfig, weight_dir: str | None,
               device: torch.device) -> tuple[Callable, SegModel]:
    """(eval_apply, model) of a frozen eval model.

    Weights come from ``<weight_dir>/student.pth``; with no ``weight_dir``
    the model keeps a random init drawn from ``cfg.train.seed``, as the
    JAX package's ``build_experiment`` does.  The convs and linears are
    cast to the compute dtype in place: the model is never trained.
    """
    with seeded(cfg.train.seed):
        model = make_model(cfg)
    if weight_dir is not None:
        if not os.path.exists(os.path.join(weight_dir, "student.pth")):
            raise FileNotFoundError(f"no student.pth in --weight_dir {weight_dir!r}")
        model.load_state_dict(load_role_keyed(weight_dir, ["student"])["student"], strict=True)
    model.eval().set_compute_dtype(compute_dtype(cfg)).to(device)
    _use_benchmark_convs(device)
    return _eval_apply(model, cfg.extra.get("rgb_input", False), None), model


def make_schedule(cfg: ExperimentConfig) -> Callable[[int], float]:
    t = cfg.train
    if t.lr_warmup > 0:
        return poly_warmup_schedule(t.learning_rate, t.num_steps, t.lr_warmup, t.power)
    return poly_schedule(t.learning_rate, t.num_steps, t.power)


TRAIN_STAGES = ("warmup", "dg", "selftrain")


def make_step_config(cfg: ExperimentConfig) -> StepConfig:
    t = cfg.train
    photometric = cfg.extra.get("photometric", "diga")
    if t.seg_loss not in ("ce", "ohem"):
        raise ValueError(f"seg_loss {t.seg_loss!r}: expected 'ce' or 'ohem'")
    if photometric not in ("diga", "kornia"):
        raise ValueError(f"--extra photometric={photometric!r}: expected 'diga' or 'kornia'")
    return StepConfig(
        num_classes=t.num_classes,
        crop_hw=tuple(t.crop_hw),
        beta=t.beta,
        lambda_seg=t.lambda_seg,
        lambda_distil=t.lambda_distil,
        seg_loss=t.seg_loss,
        photometric=photometric,
        # the SYNTHIA warm-up jitters with p=0.7 (Synthia/...warm_up.py:108)
        p_jitter=cfg.extra.get("p_jitter", 0.5),
        # the DG chain drops RandomSharpness (train_DiGA_DG.py:114)
        with_sharpness=cfg.extra.get("with_sharpness", cfg.stage != "dg"),
        # the reference warm-up/DG no-grad student(target) forward; on by
        # default for parity, --extra tgt_stats_forward=false drops it
        tgt_stats_forward=cfg.extra.get("tgt_stats_forward", cfg.stage in ("warmup", "dg")),
        # semiseg: 0.1x aux term, RGB input, no translator (:77-79)
        aux_weight=cfg.extra.get("aux_weight", 0.0),
        rgb_input=cfg.extra.get("rgb_input", False),
        use_crdomix=not cfg.extra.get("no_translator", False),
        # the self-training throughput mode, off unless asked for (:97)
        fuse_forwards=bool(cfg.extra.get("fuse_forwards", False)),
        compute_dtype=compute_dtype(cfg),
    )


def wants_target(cfg: ExperimentConfig) -> bool:
    """Does the stage's step read ``batch['t_img']``?  Self-training always
    (consensus and DACS); warm-up and DG for the target-stats forward."""
    return cfg.stage == "selftrain" or make_step_config(cfg).tgt_stats_forward


def load_centroids(cfg: ExperimentConfig, centroid_path: str | None) -> Centroids:
    """``--centroid_path`` (``.npy``, or a torch-saved tensor) with every count
    at 100, else zero centroids (``diga_tpu/train/build.py:176-186``)."""
    k = cfg.train.num_classes
    if centroid_path is None:
        return Centroids.create(k, cfg.extra.get("feat_dim", 256))
    if not os.path.exists(centroid_path):
        raise FileNotFoundError(f"--centroid_path {centroid_path!r} does not exist")
    if centroid_path.endswith(".npy"):
        vectors = torch.from_numpy(np.load(centroid_path))
    else:
        vectors = torch.as_tensor(torch.load(centroid_path, map_location="cpu"))
    if vectors.ndim != 2 or vectors.shape[0] != k:
        raise ValueError(f"centroids {tuple(vectors.shape)} from {centroid_path!r}: "
                         f"expected ({k}, feat_dim)")
    return Centroids(vectors=vectors.to(torch.float32), counts=torch.full((k,), 100.0))


def make_translator_modules(cfg: ExperimentConfig) -> tuple[ImgEncoder, ImgDecoder]:
    """The frozen translator's modules: the decoder's up-blocks in the
    subpixel form unless ``--extra subpixel_up=false``, as the JAX package
    builds them (``diga_tpu/train/build.py:111-118``); the same weights."""
    return ImgEncoder(), ImgDecoder(subpixel_up=cfg.extra.get("subpixel_up", True))


def init_translator_frozen(cfg: ExperimentConfig, weight_dir: str | None,
                           device: torch.device) -> nn.ModuleDict:
    """enc_s/dec_s2t from a role-keyed dir, else a random init drawn from
    ``cfg.train.seed``."""
    with seeded(cfg.train.seed + 7):
        enc, dec = make_translator_modules(cfg)
    if weight_dir and os.path.exists(os.path.join(weight_dir, "enc_s.pth")):
        sds = load_role_keyed(weight_dir, ["enc_s", "dec_s2t"])
        enc.load_state_dict(sds["enc_s"], strict=True)
        dec.load_state_dict(sds["dec_s2t"], strict=True)
    return nn.ModuleDict({"enc_s": enc, "dec_s2t": dec}).to(device)


def build_experiment(cfg: ExperimentConfig, device: torch.device,
                     load_weight_dir: str | None = None,
                     centroid_path: str | None = None,
                     pretrained_backbone: str | None = None
                     ) -> tuple[SegTrainState, Callable, Callable]:
    """(state, step, eval_apply) for the warm-up, DG or self-training stage.

    The student starts from a random init drawn from ``cfg.train.seed``,
    with the backbone (and, for DeepLab, a matching head) of the
    ``pretrained_backbone`` file laid over it; a previous stage's
    ``<load_weight_dir>/student.pth`` replaces both.  The teacher starts as
    a copy of the student.

    ``step(state, batch) -> metrics`` (``train/steps.py``): the DG step for
    stage ``dg`` and for a warm-up with ``--extra no_translator`` (the
    semiseg warm-up), else the stage's own; the self-training step without
    the translator takes the photometric view as its second view.
    ``eval_apply`` runs the student in eval mode under the compute dtype's
    autocast.

    Under a process group (``parallel/dist.py``; ``device`` is then the
    rank's own) every BN of the student, and so of its copy the teacher,
    becomes a ``SyncBatchNorm2d``, and the student, the frozen translator
    and the centroids are broadcast from rank 0 before the state is made.
    """
    if cfg.stage not in TRAIN_STAGES:
        raise NotImplementedError(
            f"stage {cfg.stage!r}: build_experiment builds the warm-up, DG and self-training "
            "stages; the translator stage is diga_tpu_torch.cli.train_domain_translator")
    scfg = make_step_config(cfg)
    with seeded(cfg.train.seed):
        student = make_model(cfg)
    if pretrained_backbone is not None:
        if not os.path.exists(pretrained_backbone):
            raise FileNotFoundError(f"--pretrained_backbone {pretrained_backbone!r} does not exist")
        lay_over = (hrnet_imagenet_state_dict if isinstance(student, HRNetOCR)
                    else pretrained_backbone_state_dict)
        student.load_state_dict(lay_over(student, load_torch_state_dict(pretrained_backbone)),
                                strict=True)
    if load_weight_dir and os.path.exists(os.path.join(load_weight_dir, "student.pth")):
        student.load_state_dict(load_role_keyed(load_weight_dir, ["student"])["student"],
                                strict=True)
    student.to(device)
    convert_sync_bn(student)
    dist.broadcast_module(student)
    translator = None
    if cfg.stage in ("warmup", "selftrain") and not cfg.extra.get("no_translator", False):
        translator = init_translator_frozen(cfg, load_weight_dir, device)
        dist.broadcast_module(translator)
    centroids = load_centroids(cfg, centroid_path) if cfg.stage == "selftrain" else None
    if centroids is not None and dist.active():
        centroids = Centroids(centroids.vectors.to(device), centroids.counts.to(device))
        dist.broadcast_tensors([centroids.vectors, centroids.counts])
    t = cfg.train
    optimizer = sgd_grouped(student, t.learning_rate, t.momentum, t.weight_decay, t.head_lr_mult)
    state = create_seg_state(student, optimizer, t.seed, translator, centroids)
    _use_benchmark_convs(device)
    if cfg.stage == "selftrain":
        build_step = build_selftrain_step
    else:
        build_step = build_warmup_step if translator is not None else build_dg_step
    step = build_step(scfg, make_schedule(cfg))
    amp = None if scfg.compute_dtype == torch.float32 else scfg.compute_dtype
    return state, step, _eval_apply(student, cfg.extra.get("rgb_input", False), amp)


def export_state_role_keyed(state: SegTrainState, out_dir: str) -> None:
    """Write student.pth and teacher.pth in the reference layout."""
    export_role_keyed(out_dir, {"student": reference_state_dict(state.student),
                                "teacher": reference_state_dict(state.teacher)})
