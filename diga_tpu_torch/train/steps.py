"""The UDA warm-up train step.

Counterpart of ``diga_tpu/train/steps.py::build_warmup_step`` (:194-268)
with its ``StepConfig`` (:35-117), reference
train_DiGA_gta2city_warm_up.py:197-305.  One call runs, in the reference
order:
  1. EMA of the teacher parameters (alpha ramped by the step);
  2. the photometric view of the source batch;
  3. the frozen translator (enc_s -> dec_s2t) under ``no_grad``;
  4. CrDoMix: translated image outside, photometric view inside half the
     source classes;
  5. the teacher forward on [source; mix] in train mode (batch-statistic
     BN, dropout) under ``no_grad`` — never eval mode;
  6. the student forward and backward: CE on the source half plus
     ``lambda_distil`` x the symmetric distillation, both on logits
     upsampled to the crop (``ops.distill``: the CUDA kernels B1a/B1b on
     the card);
  7. the target-stats forward: the student's backbone on the target batch
     with the pre-step parameters, after the [source; mix] statistics
     update (``steps.py:246-252``; JAX dead-codes the head there);
  8. the SGD step at ``schedule(step)``.
Forwards run under ``torch.autocast`` in the compute dtype; parameters
stay f32.  The metrics stay device tensors until they are logged.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from ..models.translator import translate
from ..ops import distill as D
from ..ops import mixing
from ..ops import photometric as P
from ..ops.ema import ema_alpha, ema_update
from ..ops.losses import cross_entropy2d
from ..ops.resize import resize_bilinear
from .optim import set_lr
from .state import SegTrainState


EMA_CAP = 0.999      # util/utils.py:103-116
DISTIL_SCALE = 0.5   # weight of the aug->clean direction, util/loss.py:125-143


@dataclasses.dataclass(frozen=True)
class StepConfig:
    num_classes: int = 19
    crop_hw: tuple[int, int] = (512, 896)
    beta: float = 0.4                    # photometric blend strength
    lambda_seg: float = 1.0
    lambda_distil: float = 0.5
    p_jitter: float = 0.5                # ColorJitter p (SYNTHIA warm-up: 0.7)
    # the reference's no-grad student(target) forward, kept for its BN
    # running-statistics side effect (diga_tpu StepConfig.tgt_stats_forward)
    tgt_stats_forward: bool = False
    compute_dtype: torch.dtype = torch.bfloat16


def _autocast(device: torch.device, dtype: torch.dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)  # contiguous NHWC -> channels_last NCHW view


def _logits_up(model, x_nchw: torch.Tensor, crop_hw) -> torch.Tensor:
    """The model's logits, bilinearly upsampled to the crop, as NHWC."""
    return resize_bilinear(model(x_nchw)[2].permute(0, 2, 3, 1), crop_hw)


def build_warmup_step(cfg: StepConfig, schedule: Callable[[int], float]) -> Callable:
    """``step(state, batch, *, selection=None, photometric_draws=None) -> metrics``.

    ``batch``: ``s_img`` (B, H, W, 3) f32 NHWC, ``s_lbl`` (B, H, W) int, and
    ``t_img`` when ``cfg.tgt_stats_forward``; all on the state's device.
    ``selection`` (B, C+1) and ``photometric_draws`` replace the step's own
    draws (tests inject the JAX package's).
    """

    def step(state: SegTrainState, batch: dict, *, selection: torch.Tensor | None = None,
             photometric_draws: dict | None = None) -> dict[str, torch.Tensor]:
        s_img, s_lbl = batch["s_img"], batch["s_lbl"]
        b = s_img.shape[0]
        amp = _autocast(s_img.device, cfg.compute_dtype)

        ema_update(state.teacher, state.student, ema_alpha(state.step, EMA_CAP))

        draws = photometric_draws
        if draws is None:
            draws = P.draw(state.gen_photometric, b, p_jitter=cfg.p_jitter)
        s_aug = P.diga_photometric(s_img, draws, cfg.beta)
        if selection is None:
            selection = mixing.sample_half_classes(s_lbl, state.gen_mix, cfg.num_classes)
        with torch.no_grad():
            with amp:
                rec_s2t = translate(state.translator, s_img)
            s_mix = mixing.crdomix(rec_s2t, s_aug, s_lbl, selection, cfg.num_classes)
            s_cat = _nchw(torch.cat([s_img, s_mix], dim=0))
            with amp:
                t_up = _logits_up(state.teacher, s_cat, cfg.crop_hw)

        with amp:
            s_up = _logits_up(state.student, s_cat, cfg.crop_hw)
            ce = cross_entropy2d(s_up[:b], s_lbl)
            distil = D.distillation_loss(t_up, s_up, DISTIL_SCALE)
            total = cfg.lambda_seg * ce + cfg.lambda_distil * distil
        total.backward()

        if cfg.tgt_stats_forward:
            with torch.no_grad(), amp:
                state.student.backbone(_nchw(batch["t_img"]))

        set_lr(state.optimizer, schedule(state.step))
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return {"loss": total.detach(), "loss_semseg": ce.detach(), "loss_distil": distil.detach()}

    return step
