"""The DG, UDA warm-up and self-training train steps.

Counterpart of ``diga_tpu/train/steps.py``: ``build_dg_step`` (:120-191),
``build_warmup_step`` (:194-268) and ``build_selftrain_step`` (:271-402),
with their ``StepConfig`` (:35-117).  Reference: train_DiGA_DG.py:188-275,
train_DiGA_gta2city_warm_up.py:197-305,
train_DiGA_gta2city_self_training.py:214-387, and for the semi-supervised
Cityscapes stages train_DiGA_semiseg_warm_up.py (the DG step with the aux
term) and train_DiGA_semiseg_self_training.py (no translator).

The DG and warm-up steps run, in the reference order:
  1. EMA of the teacher parameters (alpha ramped by the step);
  2. the photometric view of the source batch;
  3. warm-up only: the frozen translator (enc_s -> dec_s2t) under
     ``no_grad``, then CrDoMix: the translated image outside, the
     photometric view inside half the source classes;
  4. the teacher forward on [source; second view] in train mode
     (batch-statistic BN, dropout) under ``no_grad``, never eval mode;
  5. the student forward and backward: the segmentation loss (CE, or OHEM
     for the SYNTHIA stages) on the source half plus
     ``lambda_distil`` x the symmetric distillation, both on logits
     upsampled to the crop (``ops.distill``: the CUDA kernels B1a/B1b on
     the card); with ``aux_weight`` > 0 (HRNet+OCR) the same two terms on
     the OCR soft-region logits, times ``aux_weight``, are added to them;
  6. the target-stats forward: the student's ``bn_stats_forward`` on the
     target batch with the pre-step parameters, after the [source; view]
     statistics update (``steps.py:169-175,246-252``: JAX runs the whole
     model, whose outputs feed nothing; every BN it updates is in
     ``bn_stats_forward``);
  7. the SGD step at ``schedule(step)``.
The self-training step is laid out in ``build_selftrain_step``.  With
``rgb_input`` every model forward sees the image with its channels flipped
BGR->RGB (``_student_apply``, :104-117); the photometric chain, CrDoMix
and DACS work on the BGR tensor before the flip.
Forwards run under ``torch.autocast`` in the compute dtype; parameters
stay f32.  The metrics stay device tensors until they are logged.

Every part of a step runs in a scope (``scope``, the port's
``utils/profiling.py::span``: a ``torch.profiler.record_function``, kept
as a host span while a recording is open), inside one ``train_step``
scope: the model forwards by class name (``DeepLabV2``, ``HRNetOCR``),
the frozen translator by module (``ImgEncoder``, ``ImgDecoder``),
``photometric``, ``crdomix`` (DACS as ``crdomix/dacs``), ``prototypes``,
``cross_entropy`` (OHEM and the aux term), ``distill``, ``resize``,
``ema`` and ``sgd``: the names
``utils/profiling.py::default_component``, the JAX package's rule, reads.
A scope only marks a span of the profiler's trace and of a recording: it
computes nothing and synchronises nothing.

Every model call (the forwards and the target-stats forward) goes through
the step's ``calls`` (``train/graphs.py::ModelCalls``), by default a
``ModelCalls(CudaGraphs())`` of the step's own: on the card, with no
process group, each call is replayed as a CUDA graph; on the CPU and under
a process group it is the plain call.

Under a process group (``parallel/dist.py``) the same order of operations
runs on every rank's share of the global batch: the BNs are
``SyncBatchNorm2d`` (``train/build.py``), the gradients are averaged over
the ranks before the SGD step, the centroid scan runs over every rank's
rows in global order, OHEM selects over the global batch, every per-image
draw (photometric, CrDoMix/DACS selections, channel dropout) is made at
the global batch's shape and sliced, and the returned metrics are the
ranks' average.  A concatenated batch stays local: ``[source; view]`` is
the rank's own source and view, laid out for the dropout draw by
``dist.batch_segments``.  An injected draw takes the rank's rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable

import torch

from ..models.translator import translate
from ..ops import distill as D
from ..ops import mixing
from ..ops import photometric as P
from ..ops import prototypes
from ..ops.ema import ema_alpha, ema_update
from ..ops.losses import cross_entropy2d, ohem_cross_entropy
from ..ops.resize import resize_bilinear
from ..parallel import dist
from ..utils.profiling import span as scope
from .graphs import CudaGraphs, ModelCalls
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
    seg_loss: str = "ce"                 # 'ce' | 'ohem' (the SYNTHIA stages)
    ohem_thresh: float = 0.7
    ohem_min_kept: int = 100_000
    # 'diga': the chain in unit space (the JAX package's documented
    # deviation); 'kornia': the reference-faithful kornia-0.5.8 chain on the
    # normalized tensor, incl. the trailing 2x-1 (``--parity``)
    photometric: str = "diga"
    p_jitter: float = 0.5                # ColorJitter p (SYNTHIA warm-up: 0.7)
    # RandomSharpness in the photometric chain; the DG chain has it
    # commented out (train_DiGA_DG.py:114)
    with_sharpness: bool = True
    # the reference's no-grad student(target) forward, kept for its BN
    # running-statistics side effect (diga_tpu StepConfig.tgt_stats_forward)
    tgt_stats_forward: bool = False
    # semiseg (HRNet+OCR): the aux term's weight on the OCR soft-region
    # logits, DG/warm-up step only, and the BGR->RGB flip at the model input
    # (train_DiGA_semiseg_warm_up.py:238,259-263)
    aux_weight: float = 0.0
    rgb_input: bool = False
    # the self-training step's second view: CrDoMix with the frozen
    # translator, or the photometric view itself (semiseg, :260)
    use_crdomix: bool = True
    # self-training throughput mode (diga_tpu StepConfig.fuse_forwards):
    # one teacher forward over [source; view; target] and one student
    # forward over [source; view; DACS image].  Train-mode BN then
    # normalizes with, and updates its running statistics from, the pooled
    # batch, so the mode is not parity-exact against the unfused step.
    fuse_forwards: bool = False
    compute_dtype: torch.dtype = torch.bfloat16


def _autocast(device: torch.device, dtype: torch.dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _model_input(cfg: StepConfig, x: torch.Tensor) -> torch.Tensor:
    """An NHWC BGR batch as the model's NCHW input (a channels_last view),
    its channels flipped to RGB with ``rgb_input``."""
    if cfg.rgb_input:
        x = torch.flip(x, dims=(-1,))
    return x.permute(0, 3, 1, 2)


def in_scope(name: str, step: Callable) -> Callable:
    """``step`` run inside the profiler scope ``name``."""
    @functools.wraps(step)
    def scoped(*args, **kwargs):
        with scope(name):
            return step(*args, **kwargs)
    return scoped


def _forward(calls: ModelCalls, model, x: torch.Tensor, segments: tuple[int, ...] = ()):
    """``model(x)`` through ``calls``, in a scope named after the model's
    class; ``segments``: the local sizes of the parts ``x`` concatenates
    (one part if empty), for the dropout draw under a process group."""
    with scope(type(model).__name__), dist.batch_segments(*(segments or (x.shape[0],))):
        return calls.forward(model, x)


def _logits_up(cfg: StepConfig, calls: ModelCalls, model, x: torch.Tensor,
               with_aux: bool = False, segments: tuple[int, ...] = ()):
    """The model's logits on the NHWC batch ``x``, bilinearly upsampled to
    the crop, as NHWC; with ``with_aux`` also the aux logits, likewise."""
    _, aux, logits, _ = _forward(calls, model, _model_input(cfg, x), segments)
    with scope("resize"):
        up = resize_bilinear(_nhwc(logits), cfg.crop_hw)
        return (up, resize_bilinear(_nhwc(aux), cfg.crop_hw)) if with_aux else up


def _seg_loss_fn(cfg: StepConfig) -> Callable:
    if cfg.seg_loss == "ohem":
        return lambda logits, labels: ohem_cross_entropy(
            logits, labels, thresh=cfg.ohem_thresh, min_kept=cfg.ohem_min_kept)
    return cross_entropy2d


def _photometric(cfg: StepConfig, generator: torch.Generator, img: torch.Tensor,
                 draws: dict | None) -> torch.Tensor:
    with scope("photometric"):
        if draws is None:
            draw = P.draw_kornia if cfg.photometric == "kornia" else P.draw
            # kornia's jitter order is one permutation for the whole batch
            draws = dist.draw_local(lambda n: draw(generator, n, p_jitter=cfg.p_jitter),
                                    img.shape[0], shared=("order",))
        return P.diga_photometric(img, draws, cfg.beta, variant=cfg.photometric,
                                  with_sharpness=cfg.with_sharpness)


def _crdomix_view(cfg: StepConfig, state: SegTrainState, s_img, s_lbl, s_aug, selection, amp):
    """The translated source image with the photometric view pasted into
    half its classes (reference warm_up.py:239-261)."""
    with scope("crdomix"):
        if selection is None:
            selection = mixing.sample_half_classes(s_lbl, state.gen_mix, cfg.num_classes)
        with torch.no_grad():
            with amp:
                rec_s2t = translate(state.translator, s_img)
            return mixing.crdomix(rec_s2t, s_aug, s_lbl, selection, cfg.num_classes)


def _ema(state: SegTrainState) -> None:
    with scope("ema"):
        ema_update(state.teacher, state.student, ema_alpha(state.step, EMA_CAP))


def _sgd_step(state: SegTrainState, schedule: Callable[[int], float]) -> None:
    with scope("sgd"):
        dist.all_reduce_grads(p for g in state.optimizer.param_groups for p in g["params"])
        set_lr(state.optimizer, schedule(state.step))
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


def _distill_and_update(cfg: StepConfig, schedule, calls: ModelCalls, state: SegTrainState,
                        s_cat: torch.Tensor, s_lbl: torch.Tensor, t_img: torch.Tensor | None,
                        amp) -> dict[str, torch.Tensor]:
    """Steps 4-7 of the DG and warm-up steps on ``s_cat`` = [source; view] (NHWC)."""
    b = s_lbl.shape[0]
    aux = cfg.aux_weight > 0
    seg_loss = _seg_loss_fn(cfg)
    with torch.no_grad(), amp:
        t_up = _logits_up(cfg, calls, state.teacher, s_cat, aux, (b, b))
    with amp:
        s_up = _logits_up(cfg, calls, state.student, s_cat, aux, (b, b))
        if aux:
            (t_up, t_aux_up), (s_up, s_aux_up) = t_up, s_up
        with scope("cross_entropy"):
            ce = seg_loss(s_up[:b], s_lbl)
            if aux:
                ce = ce + cfg.aux_weight * seg_loss(s_aux_up[:b], s_lbl)
        with scope("distill"):
            distil = D.distillation_loss(t_up, s_up, DISTIL_SCALE)
            if aux:
                distil = distil + cfg.aux_weight * D.distillation_loss(t_aux_up, s_aux_up,
                                                                       DISTIL_SCALE)
        total = cfg.lambda_seg * ce + cfg.lambda_distil * distil
    total.backward()
    if cfg.tgt_stats_forward:
        with torch.no_grad(), amp, scope(type(state.student).__name__):
            calls.bn_stats_forward(state.student, _model_input(cfg, t_img))
    _sgd_step(state, schedule)
    return dist.mean_metrics({"loss": total.detach(), "loss_semseg": ce.detach(),
                              "loss_distil": distil.detach()})


def _graphed(calls: ModelCalls | None) -> ModelCalls:
    """``calls``, or a step's own graphed calls where it has none."""
    return ModelCalls(CudaGraphs()) if calls is None else calls


def build_dg_step(cfg: StepConfig, schedule: Callable[[int], float],
                  calls: ModelCalls | None = None) -> Callable:
    """``step(state, batch, *, photometric_draws=None) -> metrics``: the
    warm-up step without the translator and CrDoMix; the second view is the
    photometric view itself (reference train_DiGA_DG.py:188-275).

    ``batch``: ``s_img`` (B, H, W, 3) f32 NHWC, ``s_lbl`` (B, H, W) int, and
    ``t_img`` when ``cfg.tgt_stats_forward``.  ``calls`` makes the model
    calls, here as in the other builders (by default graphed where they
    can be, ``ModelCalls(CudaGraphs())``).
    """
    calls = _graphed(calls)

    def step(state: SegTrainState, batch: dict, *,
             photometric_draws: dict | None = None) -> dict[str, torch.Tensor]:
        s_img, s_lbl = batch["s_img"], batch["s_lbl"]
        amp = _autocast(s_img.device, cfg.compute_dtype)
        _ema(state)
        s_aug = _photometric(cfg, state.gen_photometric, s_img, photometric_draws)
        s_cat = torch.cat([s_img, s_aug], dim=0)
        return _distill_and_update(cfg, schedule, calls, state, s_cat, s_lbl, batch.get("t_img"),
                                   amp)

    return in_scope("train_step", step)


def build_warmup_step(cfg: StepConfig, schedule: Callable[[int], float],
                      calls: ModelCalls | None = None) -> Callable:
    """``step(state, batch, *, selection=None, photometric_draws=None) -> metrics``.

    ``batch`` as for ``build_dg_step``.  ``selection`` (B, C+1) and
    ``photometric_draws`` (``P.draw``'s, or ``P.draw_kornia``'s when
    ``cfg.photometric == 'kornia'``) replace the step's own draws (tests
    inject the JAX package's).
    """
    calls = _graphed(calls)

    def step(state: SegTrainState, batch: dict, *, selection: torch.Tensor | None = None,
             photometric_draws: dict | None = None) -> dict[str, torch.Tensor]:
        s_img, s_lbl = batch["s_img"], batch["s_lbl"]
        amp = _autocast(s_img.device, cfg.compute_dtype)
        _ema(state)
        s_aug = _photometric(cfg, state.gen_photometric, s_img, photometric_draws)
        s_mix = _crdomix_view(cfg, state, s_img, s_lbl, s_aug, selection, amp)
        s_cat = torch.cat([s_img, s_mix], dim=0)
        return _distill_and_update(cfg, schedule, calls, state, s_cat, s_lbl, batch.get("t_img"),
                                   amp)

    return in_scope("train_step", step)


def build_selftrain_step(cfg: StepConfig, schedule: Callable[[int], float],
                         calls: ModelCalls | None = None) -> Callable:
    """``step(state, batch, *, selection=None, dacs_selection=None,
    photometric_draws=None, target_photometric_draws=None) -> metrics``.

    ``batch``: ``s_img``, ``s_lbl`` as above, ``t_img`` (B', H, W, 3) and
    ``t_pseudo`` (B', H, W) int pseudo-labels.  One call runs, in the
    reference order:
      1. the EMA of the teacher parameters;
      2. the photometric views of source and target;
      3. the frozen translator and CrDoMix, as in the warm-up; without
         ``use_crdomix`` (semiseg) the second view is the photometric view
         itself, and no CrDoMix selection is drawn;
      4. the teacher on [source; mix], then on the target, in train mode
         under ``no_grad``: its BN statistics chain through both forwards,
         and its GroupNorm runs on the kernel B2a/B2b on the card; with
         ``fuse_forwards`` one forward over [source; mix; target], split
         at the target's batch (JAX :305-316);
      5. the centroid weights of the teacher's target features, upsampled
         to the crop, and the bilateral consensus against ``t_pseudo``;
      6. DACS: source classes pasted into the target's photometric view,
         with the consensus as the label elsewhere;
      7. the centroid update from the target, then from the source's mix
         half, both in EMA mode;
      8. the student on [source; mix], then on the DACS image, its BN
         statistics chained; with ``fuse_forwards`` one forward over
         [source; mix; DACS image], split at the DACS batch (:354-361);
      9. loss = lambda_seg x (the segmentation loss on the source + on the
         DACS image) + lambda_distil x
         the distillation against the teacher's [source; mix] logits, with
         no aux term whatever ``aux_weight`` says (JAX's has none, :353-380);
     10. the SGD step.
    A fused forward draws its dropout masks once, from the model's own
    generator, as the JAX step draws one key per fused forward.
    """
    calls = _graphed(calls)

    def step(state: SegTrainState, batch: dict, *, selection: torch.Tensor | None = None,
             dacs_selection: torch.Tensor | None = None,
             photometric_draws: dict | None = None,
             target_photometric_draws: dict | None = None) -> dict[str, torch.Tensor]:
        s_img, s_lbl = batch["s_img"], batch["s_lbl"]
        t_img, t_pseudo = batch["t_img"], batch["t_pseudo"]
        b, k = s_img.shape[0], cfg.num_classes
        amp = _autocast(s_img.device, cfg.compute_dtype)

        _ema(state)
        s_aug = _photometric(cfg, state.gen_photometric, s_img, photometric_draws)
        t_aug = _photometric(cfg, state.gen_photometric_target, t_img, target_photometric_draws)
        s_view = (_crdomix_view(cfg, state, s_img, s_lbl, s_aug, selection, amp)
                  if cfg.use_crdomix else s_aug)
        s_cat = torch.cat([s_img, s_view], dim=0)

        with torch.no_grad():
            with amp:
                nt = t_img.shape[0]
                if cfg.fuse_forwards:
                    _, _, a_logits, a_feat = _forward(
                        calls, state.teacher, _model_input(cfg, torch.cat([s_cat, t_img], dim=0)),
                        (b, b, nt))
                    st_logits, tt_logits = a_logits[:-nt], a_logits[-nt:]
                    st_feat, tt_feat = a_feat[:-nt], a_feat[-nt:]
                else:
                    _, _, st_logits, st_feat = _forward(calls, state.teacher,
                                                        _model_input(cfg, s_cat), (b, b))
                    _, _, tt_logits, tt_feat = _forward(calls, state.teacher,
                                                        _model_input(cfg, t_img))
            st_logits, st_feat = _nhwc(st_logits), _nhwc(st_feat)
            tt_logits, tt_feat = _nhwc(tt_logits), _nhwc(tt_feat)
            with scope("resize"):
                st_up = resize_bilinear(st_logits, cfg.crop_hw)

            with scope("prototypes"):
                weights = prototypes.centroid_weight(tt_feat, state.centroids.vectors)
                t_consensus = prototypes.bilateral_consensus(
                    t_pseudo, resize_bilinear(weights, cfg.crop_hw))
            with scope("crdomix"), scope("dacs"):
                if dacs_selection is None:
                    dacs_selection = mixing.sample_half_classes(s_lbl, state.gen_dacs, k)
                cross_img, cross_lbl = mixing.dacs_crossmix(t_aug, s_img, s_lbl, t_consensus,
                                                            dacs_selection, k)

            with scope("prototypes"):
                # the scan runs over every rank's images in global order
                vec_t, ok_t = prototypes.masked_class_means(tt_feat, tt_logits, t_consensus)
                cents = prototypes.update_centroids(state.centroids, dist.gather_rows(vec_t),
                                                    dist.gather_rows(ok_t), start_mean=False)
                vec_s, ok_s = prototypes.masked_class_means(st_feat[b:], st_logits[b:], s_lbl)
                cents = prototypes.update_centroids(cents, dist.gather_rows(vec_s),
                                                    dist.gather_rows(ok_s), start_mean=False)

        with amp:
            nc = cross_img.shape[0]
            if cfg.fuse_forwards:
                f_up = _logits_up(cfg, calls, state.student,
                                  torch.cat([s_cat, cross_img], dim=0), segments=(b, b, nc))
                s_up, cross_up = f_up[:-nc], f_up[-nc:]
            else:
                s_up = _logits_up(cfg, calls, state.student, s_cat, segments=(b, b))
                cross_up = _logits_up(cfg, calls, state.student, cross_img)
            seg_loss = _seg_loss_fn(cfg)
            with scope("cross_entropy"):
                ce = seg_loss(s_up[:b], s_lbl)
                ce_cross = seg_loss(cross_up, cross_lbl)
            with scope("distill"):
                distil = D.distillation_loss(st_up, s_up, DISTIL_SCALE)
            total = cfg.lambda_seg * (ce + ce_cross) + cfg.lambda_distil * distil
        total.backward()
        _sgd_step(state, schedule)
        state.centroids = cents
        return dist.mean_metrics({
            "loss": total.detach(), "loss_semseg": ce.detach(),
            "loss_crossmix": ce_cross.detach(), "loss_distil": distil.detach(),
            "consensus_kept": (t_consensus != prototypes.IGNORE).to(torch.float32).mean()})

    return in_scope("train_step", step)
