"""The first steps of the DG / UDA warm-up train step, in plain PyTorch.

Written from DiGA's ``train_DiGA_DG.py`` (:188-275),
``train_DiGA_gta2city_warm_up.py`` (:197-305) and
``train_DiGA_semiseg_warm_up.py``; one step, in the reference order:

  1. the EMA teacher: t <- a*t + (1 - a)*s over every parameter, with
     a = min(1 - 1/(step + 1), cap);
  2. the photometric view of the source batch;
  3. with a translator: CrDoMix, the translated image outside the selected
     source classes and the photometric view inside;
  4. the teacher (train mode, no gradient) and the student forward on
     [source; view], logits upsampled to the crop;
  5. lambda_seg * CE on the source half (+ aux_weight * CE on the OCR
     soft-region logits) + lambda_distil * the symmetric distillation
     (+ aux_weight * the same on the soft-region logits); backward;
  6. the target-stats forward: the student's BN statistics on the target;
  7. the recipe's optimizer (``reference/optimizers/<name>.py``): its update
     of each leaf at its scheduled LR, the head's parameters at
     ``head_lr_mult`` x it.

Each run returns the numbers the benchmark compares with the program: the
loss of every step, each trainable leaf's first update as the optimizer
gets it (the optimizer module's ``first_update``), each leaf's raw first
gradient (for the rule that leaves out leaves with no gradient), and after
the last step each leaf's change and each BN statistic's change.
"""

from __future__ import annotations

import copy

import torch

from . import ops, optimizer as optimizer_of
from .lowp import precision_scope


def _nchw(x: torch.Tensor, rgb: bool) -> torch.Tensor:
    if rgb:
        x = x.flip(-1)
    return x.permute(0, 3, 1, 2).contiguous()


def _logits_up(model, x, crop_hw, aux: bool):
    _, aux_logits, logits, _ = model(x)
    up = ops.resize(logits.float().permute(0, 2, 3, 1), crop_hw)
    if not aux:
        return up, None
    return up, ops.resize(aux_logits.float().permute(0, 2, 3, 1), crop_hw)


def run_steps(student: torch.nn.Module, translator: torch.nn.Module | None, recipe: dict,
              batches: list[dict], draws: list[dict], dropout_seeds: tuple[int, int],
              precision: str = "f32") -> dict:
    """``len(batches)`` steps from ``student``'s weights (changed in place).

    ``recipe``: the traffic file's hyper-parameters.  ``draws[k]``:
    ``photometric`` (per-image factors and gates) and, with a translator,
    ``selection`` (B, C+1).  ``dropout_seeds``: the student's and the
    teacher's dropout generators' seeds.  ``precision``: ``f32`` (TF32 off)
    or ``fp8``, the control (``lowp.py``).
    """
    r = recipe
    opt = optimizer_of(r)
    device = next(student.parameters()).device
    student.set_generator(None)
    teacher = copy.deepcopy(student).requires_grad_(False)
    student.train()
    teacher.train()
    student.set_generator(torch.Generator(device).manual_seed(dropout_seeds[0]))
    teacher.set_generator(torch.Generator(device).manual_seed(dropout_seeds[1]))
    named = [(n, p) for n, p in student.named_parameters() if p.requires_grad]
    theta0 = {n: p.detach().clone() for n, p in named}
    stats0 = {n: b.detach().clone() for n, b in student.named_buffers()
              if n.endswith(("running_mean", "running_var"))}
    mult = {n: r["head_lr_mult"] if student.head_param(n) else 1.0 for n, _ in named}
    aux = r["aux_weight"] > 0
    leaf_state: dict[str, dict] = {n: {} for n, _ in named}
    out = {"loss": [], "first_update": {}, "first_grad": {}}
    with precision_scope(precision, [student, teacher] + ([translator] if translator else [])) as amp:
        for k, (batch, draw) in enumerate(zip(batches, draws)):
            with torch.no_grad():
                a = ops.ema_alpha(k, r["ema_cap"])
                for tp, sp in zip(teacher.parameters(), student.parameters()):
                    tp.mul_(a).add_(sp, alpha=1.0 - a)
            s_img, s_lbl = batch["s_img"].float(), batch["s_lbl"]
            b = s_img.shape[0]
            view = ops.photometric_view(s_img, draw["photometric"], r["beta"], r["with_sharpness"])
            if translator is not None:
                with torch.no_grad(), amp():
                    rec = translator(s_img.permute(0, 3, 1, 2).contiguous())
                rec = rec.float().permute(0, 2, 3, 1)
                view = ops.crdomix(rec, view, s_lbl, draw["selection"], r["num_classes"])
            x = _nchw(torch.cat([s_img, view]), r["rgb_input"])
            with torch.no_grad(), amp():
                t_up, t_aux = _logits_up(teacher, x, r["crop_hw"], aux)
            with amp():
                s_up, s_aux = _logits_up(student, x, r["crop_hw"], aux)
            ce = ops.cross_entropy(s_up[:b], s_lbl)
            distil = ops.distillation(t_up, s_up, r["distil_scale"])
            if aux:
                ce = ce + r["aux_weight"] * ops.cross_entropy(s_aux[:b], s_lbl)
                distil = distil + r["aux_weight"] * ops.distillation(t_aux, s_aux,
                                                                     r["distil_scale"])
            total = r["lambda_seg"] * ce + r["lambda_distil"] * distil
            total.backward()
            if r["tgt_stats_forward"]:
                with torch.no_grad(), amp():
                    student.stats_forward(_nchw(batch["t_img"].float(), r["rgb_input"]))
            lr = opt.lr(r, k)
            with torch.no_grad():
                for n, p in named:
                    if k == 0:
                        out["first_grad"][n] = float(p.grad.norm())
                    opt.update(n, p, leaf_state[n], k, lr * mult[n], r)
                    if k == 0:
                        out["first_update"][n] = float(opt.first_update(leaf_state[n]).norm())
                    p.grad = None
            out["loss"].append(float(total.detach()))
    with torch.no_grad():
        out["change"] = {n: float((p - theta0[n]).norm()) for n, p in named}
        buffers = dict(student.named_buffers())
        out["stats_change"] = {n: float((buffers[n] - v).norm()) for n, v in stats0.items()}
    return out

