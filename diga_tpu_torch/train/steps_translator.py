"""The CycleGAN-style translator train step.

Counterpart of ``diga_tpu/train/steps_translator.py`` (:27-233), reference
train_domain_translator.py:240-337.  Each step runs, in the reference
order: the generator forward of both directions, the discriminator
updates on the detached fakes, then the generator update against the
UPDATED discriminators.  Six Adam(0.5, 0.999) optimizers, one per module,
each at ``schedule(step)`` (``train/optim.py::adam_translator``).

G loss = 0.5·adv + 10·cycle + 20·seg_edge + λ_self·self (+ 0.1·perceptual
with VGG19 weights; reference :320-325).  Losses are f32; the modules run
under ``torch.autocast`` in the compute dtype with f32 parameters.

``fuse=True`` (the default, ``:130-184``): ONE generator forward makes all
six images, each decoder runs its two same-weight inputs as one batch, and
each discriminator scores real and fake in one call; the generator
gradient flows back through that saved forward after the discriminator
step.  Exact against the reference order: InstanceNorm is per sample and
the PatchGAN has no norm.  ``fuse=False`` (``:187-233``) is the
reference's two generator forwards.  ``remat`` wraps every module call in
``torch.utils.checkpoint`` (``use_reentrant=False``); ``None`` turns it on
only with the perceptual term, whose VGG forwards add full-resolution
activations back (``:86-96``).

As in ``train/steps.py``, the step runs in one ``translator_step``
profiler scope, each module call in a scope named after its class
(``ImgEncoder``, ``ImgDecoder``, ``Discriminator``, ``VGG19Features``),
and each Adam update in ``scale_by_adam`` (optax's name for Adam's
transform, which ``utils/profiling.py::default_component`` reads as
``optimizer_ema``).

Under a process group (``parallel/dist.py``) each rank steps on its share
of the global batch: every Adam step follows the average of its role's
gradients over the ranks, and the metrics are the ranks' average.  The
losses are means over equal shards and the modules have no BatchNorm
(InstanceNorm is per sample), so this is the step on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn as nn
from torch.profiler import record_function as scope
from torch.utils.checkpoint import checkpoint

from ..models.vgg import VGG19Features, vgg_perceptual_loss
from ..ops import losses as L
from ..parallel import dist
from .optim import adam_translator, set_lr
from .steps import _autocast, in_scope

ROLES = ("enc_s", "enc_t", "dec_s2t", "dec_t2s", "dis_s2t", "dis_t2s")
GEN_ROLES = ROLES[:4]


@dataclasses.dataclass(frozen=True)
class TranslatorConfig:
    lambda_adv: float = 0.5
    lambda_cyc: float = 10.0
    lambda_seg_edge: float = 20.0
    lambda_percep: float = 0.1
    lambda_self: float = 0.001
    remat: bool | None = None      # None = on only with the perceptual term
    fuse: bool = True
    compute_dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass
class TranslatorState:
    """The six modules, their Adam optimizers, the step counter and the
    frozen VGG19 of the perceptual term (or None)."""

    modules: nn.ModuleDict
    optimizers: dict[str, torch.optim.Adam]
    step: int = 0
    vgg: VGG19Features | None = None

    def state_dict(self) -> dict:
        """{"roles": {role: state_dict}, "state": {"step", "optimizers"}}."""
        return {"roles": {r: self.modules[r].state_dict() for r in ROLES},
                "state": {"step": self.step,
                          "optimizers": {r: o.state_dict() for r, o in self.optimizers.items()}}}

    def load_state_dict(self, sd: dict) -> None:
        for r in ROLES:
            self.modules[r].load_state_dict(sd["roles"][r], strict=True)
        for r, o in self.optimizers.items():
            o.load_state_dict(sd["state"]["optimizers"][r])
        self.step = int(sd["state"]["step"])


def create_translator_state(modules: nn.ModuleDict, base_lr: float,
                            vgg: VGG19Features | None = None) -> TranslatorState:
    """The state of ``modules`` (the six ``ROLES``, on their device) at step
    0, each with its Adam.  The JAX package initialises both members of a
    pair from one key, so they start equal (``:62-77``); the CLI's
    ``make_translator`` builds them so."""
    modules.train()
    if vgg is not None:
        vgg.requires_grad_(False).eval()
    return TranslatorState(modules=modules,
                           optimizers={r: adam_translator(modules[r], base_lr) for r in ROLES},
                           vgg=vgg)


def build_translator_step(cfg: TranslatorConfig, schedule: Callable[[int], float],
                          with_vgg: bool = False) -> Callable:
    """``step(state, batch) -> metrics`` on an NHWC batch {'s_img', 's_lbl',
    't_img'}; the metrics stay device tensors."""
    percep = with_vgg and cfg.lambda_percep > 0
    remat = cfg.remat if cfg.remat is not None else percep

    def call(module: nn.Module, x: torch.Tensor, remat: bool = remat):
        with scope(type(module).__name__):
            return checkpoint(module, x, use_reentrant=False) if remat else module(x)

    def update(state: TranslatorState, role: str) -> None:
        opt = state.optimizers[role]
        with scope("scale_by_adam"):
            dist.all_reduce_grads(state.modules[role].parameters())
            set_lr(opt, schedule(state.step))
            opt.step()

    def d_step(state, role, real, fake, amp) -> torch.Tensor:
        """One discriminator update on detached ``fake`` (reference :262-282)."""
        dis = state.modules[role]
        state.optimizers[role].zero_grad(set_to_none=True)
        with amp:
            if cfg.fuse:  # real and fake in one call
                n = real.shape[0]
                outs = call(dis, torch.cat([real, fake]))
                loss = L.lsgan_d_loss([o[:n] for o in outs], [o[n:] for o in outs])
            else:
                loss = L.lsgan_d_loss(call(dis, real), call(dis, fake))
        loss.backward()
        update(state, role)
        return loss.detach()

    def g_losses(state, outs, s, s_lbl, t):
        r_s2t, r_t2s, r_s, r_t, r_s_cyc, r_t_cyc = outs
        m = state.modules
        loss_self = L.l1_loss(r_s, s) + L.l1_loss(r_t, t)
        loss_cyc = L.l1_loss(r_s_cyc, s) + L.l1_loss(r_t_cyc, t)
        loss_edge = L.seg_edge_loss(r_s2t, s, s_lbl)
        loss_adv = (L.lsgan_g_loss(call(m["dis_s2t"], r_s2t))
                    + L.lsgan_g_loss(call(m["dis_t2s"], r_t2s)))
        total = (cfg.lambda_adv * loss_adv + cfg.lambda_cyc * loss_cyc
                 + cfg.lambda_seg_edge * loss_edge + cfg.lambda_self * loss_self)
        if percep:
            with scope(type(state.vgg).__name__):
                total = total + cfg.lambda_percep * (vgg_perceptual_loss(state.vgg, r_s2t, s)
                                                     + vgg_perceptual_loss(state.vgg, r_t2s, t))
        return total, {"loss_adv": loss_adv, "loss_cyc": loss_cyc, "loss_edge": loss_edge,
                       "loss_self": loss_self}

    def generator_fused(m, s, t):
        ns, nt = s.shape[0], t.shape[0]
        fs, ft = call(m["enc_s"], s), call(m["enc_t"], t)
        d1 = call(m["dec_s2t"], torch.cat([fs, ft]))  # [translated source; target self-recon]
        d2 = call(m["dec_t2s"], torch.cat([ft, fs]))  # [translated target; source self-recon]
        r_s2t, r_t, r_t2s, r_s = d1[:ns], d1[ns:], d2[:nt], d2[nt:]
        r_s_cyc = call(m["dec_t2s"], call(m["enc_t"], r_s2t))
        r_t_cyc = call(m["dec_s2t"], call(m["enc_s"], r_t2s))
        return r_s2t, r_t2s, r_s, r_t, r_s_cyc, r_t_cyc

    def generator_reference(m, s, t):
        fs, ft = call(m["enc_s"], s), call(m["enc_t"], t)
        r_s2t, r_t2s = call(m["dec_s2t"], fs), call(m["dec_t2s"], ft)
        r_s, r_t = call(m["dec_t2s"], fs), call(m["dec_s2t"], ft)
        r_s_cyc = call(m["dec_t2s"], call(m["enc_t"], r_s2t))
        r_t_cyc = call(m["dec_s2t"], call(m["enc_s"], r_t2s))
        return r_s2t, r_t2s, r_s, r_t, r_s_cyc, r_t_cyc

    def step(state: TranslatorState, batch: dict) -> dict[str, torch.Tensor]:
        s = batch["s_img"].permute(0, 3, 1, 2)  # contiguous NHWC -> channels_last NCHW
        t = batch["t_img"].permute(0, 3, 1, 2)
        s_lbl = batch["s_lbl"]
        m = state.modules
        amp = _autocast(s.device, cfg.compute_dtype)
        if cfg.fuse:
            with amp:
                outs = generator_fused(m, s, t)
            fakes = outs[0].detach(), outs[1].detach()
        else:
            with torch.no_grad(), amp:
                fakes = (call(m["dec_s2t"], call(m["enc_s"], s, False), False),
                         call(m["dec_t2s"], call(m["enc_t"], t, False), False))
        loss_d_s2t = d_step(state, "dis_s2t", t, fakes[0], amp)
        loss_d_t2s = d_step(state, "dis_t2s", s, fakes[1], amp)
        if not cfg.fuse:
            with amp:
                outs = generator_reference(m, s, t)
        with amp:
            total, aux = g_losses(state, outs, s, s_lbl, t)
        gen_params = [p for r in GEN_ROLES for p in m[r].parameters()]
        for r in GEN_ROLES:
            state.optimizers[r].zero_grad(set_to_none=True)
        total.backward(inputs=gen_params)  # the discriminators stay as updated
        for r in GEN_ROLES:
            update(state, r)
        state.step += 1
        return dist.mean_metrics({"loss_g": total.detach(), "loss_d_s2t": loss_d_s2t,
                                  "loss_d_t2s": loss_d_t2s,
                                  **{k: v.detach() for k, v in aux.items()}})

    return in_scope("translator_step", step)
