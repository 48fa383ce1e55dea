"""Assemble models, optimizer, state and the step from a preset config.

Counterpart of ``diga_tpu/train/build.py``: ``make_model`` (:31-58),
``make_schedule``/``make_step_config`` (:61-98), the translator helpers
(:111-140), ``build_experiment`` (:143-279) for the warm-up stage, and
``export_state_role_keyed`` (:289-313); previous-stage weights come from
role-keyed ``.pth`` files (reference stage chaining).  ``build_eval`` is
the frozen eval model of ``evaluate_val``.

Parameters are f32; the compute dtype is applied by ``torch.autocast``
around the forwards (the JAX model casts its params at use).  Only the
frozen eval model of ``build_eval`` is cast in place.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch
import torch.nn as nn

from ..configs.presets import ExperimentConfig
from ..models.resnet_deeplab import DeepLabV2
from ..models.translator import ImgDecoder, ImgEncoder
from ..utils.checkpoint import export_role_keyed, load_role_keyed
from .optim import sgd_grouped
from .schedules import poly_schedule, poly_warmup_schedule
from .state import SegTrainState, create_seg_state
from .steps import StepConfig, build_warmup_step


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


def make_model(cfg: ExperimentConfig) -> DeepLabV2:
    """DeepLabV2 at the preset's class count (``extra['layers']`` for tiny depths)."""
    if cfg.extra.get("model", "deeplab") != "deeplab":
        raise NotImplementedError(
            f"model {cfg.extra['model']!r} is not ported yet (DeepLabV2 only; "
            "HRNet is ROADMAP queue A item 14)")
    layers = tuple(cfg.extra.get("layers", (3, 4, 23, 3)))
    return DeepLabV2(num_classes=cfg.train.num_classes, layers=layers)


def _use_benchmark_convs(device: torch.device) -> None:
    if device.type == "cuda":
        # a few fixed shapes run many times: let cuDNN time its algorithms
        # once per shape.  Its heuristic choice for the dilated ASPP convs
        # is a direct kernel that made the two-scale eval take seconds per
        # image (chip_smoke.py --profile on an H100).
        torch.backends.cudnn.benchmark = True


def _eval_apply(model: DeepLabV2, rgb_input: bool, amp_dtype: torch.dtype | None) -> Callable:
    """``eval_apply(image_nhwc) -> logits_nhwc`` with ``model`` in eval mode
    for the call (a training model goes back to train mode after it)."""

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
            with amp:
                _, _, logits, _ = model(img.permute(0, 3, 1, 2))
        finally:
            model.train(was_training)
        return logits.permute(0, 2, 3, 1)

    return eval_apply


def build_eval(cfg: ExperimentConfig, weight_dir: str | None,
               device: torch.device) -> tuple[Callable, DeepLabV2]:
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


# extra knobs of the JAX StepConfig whose code paths are not ported yet
_NOT_PORTED = {
    "aux_weight": "HRNet/semiseg, ROADMAP queue A item 14",
    "rgb_input": "HRNet/semiseg, ROADMAP queue A item 14",
    "no_translator": "the DG-style step, ROADMAP queue A item 8",
    "fuse_forwards": "self-training, ROADMAP queue A item 9",
}
# knobs whose non-default value belongs to an unported stage
_DEFAULTS_ONLY = {"with_sharpness": (True, "the DG chain, ROADMAP queue A item 8")}


def make_step_config(cfg: ExperimentConfig) -> StepConfig:
    t = cfg.train
    if t.seg_loss != "ce":
        raise NotImplementedError(f"seg_loss {t.seg_loss!r} is not ported yet (OHEM, ROADMAP)")
    if cfg.extra.get("photometric", "diga") != "diga":
        raise NotImplementedError("the kornia photometric chain is not ported yet (ROADMAP)")
    for key, where in _NOT_PORTED.items():
        if cfg.extra.get(key):
            raise NotImplementedError(f"--extra {key} is not ported yet ({where})")
    for key, (value, where) in _DEFAULTS_ONLY.items():
        if cfg.extra.get(key, value) != value:
            raise NotImplementedError(f"--extra {key}={cfg.extra[key]!r} is not ported yet ({where})")
    return StepConfig(
        num_classes=t.num_classes,
        crop_hw=tuple(t.crop_hw),
        beta=t.beta,
        lambda_seg=t.lambda_seg,
        lambda_distil=t.lambda_distil,
        p_jitter=cfg.extra.get("p_jitter", 0.5),
        # the reference warm-up's no-grad student(target) forward; on by
        # default for parity, --extra tgt_stats_forward=false drops it
        tgt_stats_forward=cfg.extra.get("tgt_stats_forward", cfg.stage in ("warmup", "dg")),
        compute_dtype=compute_dtype(cfg),
    )


def make_translator_modules() -> tuple[ImgEncoder, ImgDecoder]:
    return ImgEncoder(), ImgDecoder()


def init_translator_frozen(cfg: ExperimentConfig, weight_dir: str | None,
                           device: torch.device) -> nn.ModuleDict:
    """enc_s/dec_s2t from a role-keyed dir, else a random init drawn from
    ``cfg.train.seed``."""
    with seeded(cfg.train.seed + 7):
        enc, dec = make_translator_modules()
    if weight_dir and os.path.exists(os.path.join(weight_dir, "enc_s.pth")):
        sds = load_role_keyed(weight_dir, ["enc_s", "dec_s2t"])
        enc.load_state_dict(sds["enc_s"], strict=True)
        dec.load_state_dict(sds["dec_s2t"], strict=True)
    return nn.ModuleDict({"enc_s": enc, "dec_s2t": dec}).to(device)


def build_experiment(cfg: ExperimentConfig, device: torch.device,
                     load_weight_dir: str | None = None
                     ) -> tuple[SegTrainState, Callable, Callable]:
    """(state, step, eval_apply) for the warm-up stage.

    ``step(state, batch) -> metrics`` (``train/steps.py``); ``eval_apply``
    runs the student in eval mode under the compute dtype's autocast.
    """
    if cfg.stage != "warmup":
        raise NotImplementedError(
            f"stage {cfg.stage!r} is not ported yet: the port trains the warm-up stage "
            "(DG, self-training and translator steps are ROADMAP queue A items 8, 9, 13)")
    scfg = make_step_config(cfg)
    with seeded(cfg.train.seed):
        student = make_model(cfg)
    if load_weight_dir and os.path.exists(os.path.join(load_weight_dir, "student.pth")):
        student.load_state_dict(load_role_keyed(load_weight_dir, ["student"])["student"],
                                strict=True)
    student.to(device)
    translator = init_translator_frozen(cfg, load_weight_dir, device)
    t = cfg.train
    optimizer = sgd_grouped(student, t.learning_rate, t.momentum, t.weight_decay, t.head_lr_mult)
    state = create_seg_state(student, optimizer, t.seed, translator)
    _use_benchmark_convs(device)
    step = build_warmup_step(scfg, make_schedule(cfg))
    amp = None if scfg.compute_dtype == torch.float32 else scfg.compute_dtype
    return state, step, _eval_apply(student, cfg.extra.get("rgb_input", False), amp)


def _reference_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's state_dict in the reference layout (no BN batch counters)."""
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def export_state_role_keyed(state: SegTrainState, out_dir: str) -> None:
    """Write student.pth and teacher.pth in the reference layout."""
    export_role_keyed(out_dir, {"student": _reference_state_dict(state.student),
                                "teacher": _reference_state_dict(state.teacher)})
