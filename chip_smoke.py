#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (diga_tpu_torch) on one H100.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout.  It builds the CUDA kernels from the
sources in the checkout and drives the port's main paths at full width on
the card, each through the CLI a user would call: the two-scale
evaluation of DeepLabV2-R101 (``evaluate_val``), the GTA5->Cityscapes
warm-up (``train_warm_up``), the self-training chain from the warm-up's
weights (``pseudolabel_generator`` -> ``calc_centroids`` ->
``train_self_training``), the DG stage (``train_dg``), the
SYNTHIA->Cityscapes chain at 16 classes, a ``--parity`` warm-up, the
translator stage (``train_domain_translator``), a resumed warm-up, and the
semi-supervised Cityscapes chain on HRNet-W48+OCR; ``profile_step`` (with
``--components``), the loop's device prefetch, the fused self-training step
(``--extra fuse_forwards=true``), ``parity_check`` against the replay
oracle, the loaders' C host ops, ``make_viz``, three soaks, and the
height-sharded eval (``evaluate_val --shard spatial``).
Phases, any failure of which exits non-zero:

  1. device: require CUDA; print the card's name and power limit
  2. build: nvcc every kernel source, all at once (``-Xptxas -v`` lines),
     and g++ the loaders' C host ops (``csrc/host_ops.cpp``); each host op
     bit-equal to its numpy form on one 1024x2048 image and label, with
     both host times
  3. GroupNorm kernels (B2a/B2b) against their plain versions on the card,
     f32 (1e-5) and bf16 (3e-2), at the paths' shapes (the eval's
     (1, 129, 257, 256) and (1, 65, 129, 256), the teachers' (6, 65, 113,
     256), (3, 65, 113, 256), (8, 65, 113, 256) and the fused
     self-training teacher's (9, 65, 113, 256), calc_centroids --source's
     (1, 91, 161, 256), parity_check's activation input's (1, 17, 29,
     256), and every shard's rows of the eval's two sites in the
     height-sharded eval over 2, 4 and 8 shards, (1, 8|9|16|17|32|33, 129,
     256) and (1, 16|17|32|33|64|65, 257, 256)) and at the edges of
     B2a's design: ragged, C=64, C=32, one row, fewer rows than one tile, a
     whole number of tiles, batch 6 with a ragged H·W, a base pointer
     16-byte but not 128-byte aligned; f32 channel sums at 1e-5 relative;
     B2b bitwise equal to its plain version on B2a's mul/add, both through
     ``group_norm`` (the pair, B2b launched under B2a's tail) and alone;
     three runs bitwise equal, with B2a's ticket workspace back at zero
     after each.  Distillation kernels (B1a/B1b) against theirs, f32 and
     bf16, at the train paths' (6, 512, 896, 19), (8, 512, 896, 19), (8,
     512, 896, 16) and (6, 512, 896, 16), all on the 16-byte launch plan,
     and at the edges of their tiled design: a ragged (2, 7, 13, 19) whose
     aug half is not 16-byte aligned, K=16, K=32, fewer pixels than one
     tile, a whole number of tiles, an offset base pointer; and peaky
     logits (x10) at (6, 512, 896, 19) in
     bf16.  The loss at 1e-5 relative, the gradient within 1e-5 x max|ds|
     in f32 and one bf16 ulp in bf16, no teacher gradient, two runs bitwise
     equal.  The depthwise 3x3 kernels of MiT-B5's sep-ASPP head (D1a: the
     forward, and the input gradient on the same kernel; D1b: the weight
     gradient) against their plain versions at the head's sites, training's
     (6|3, 128, 224, 1024) in f32 and bf16 and the eval's (1, 256, 512,
     1024), (1, 128, 256, 1024) in bf16, at dilations 6, 12 and 18, and at
     the edges of the walk: a map smaller than the halo, one channel vector,
     two channel slices with a ragged second, a row of 25 outputs a residue;
     within 1e-5 of the largest output (of Σ|dy·x| for the weight gradient),
     one bf16 ulp more in bf16, three runs bitwise equal
  4. tiny-depth model on the card against the same model on the CPU, f32,
     TF32 off: eval logits within 1e-3 of the CPU logits' largest
     magnitude; 3 warm-up, 3 DG and 3 self-training steps with the same
     injected draws, then 3 semiseg warm-up and 3 semiseg self-training
     steps of a tiny HRNet+OCR (branches 8-64, OCR 32/16): losses at 1e-4
     relative, ``consensus_kept`` within
     1e-3, parameters within 1e-5, BN running statistics within 1e-4 +
     1e-3 x |value| (cuDNN's f32 conv algorithms), centroid counts equal
     and vectors within 1e-5 + 1e-4 x |value|
  4b. profile_step (gta2city_warmup at full width, a synthetic batch, 2
     warm-up, 2 timed and 2 traced steps), the process's first profiler
     use: its report has device time in the distill and group_norm
     families and names the distill_* and gn_* kernels; with
     ``--components`` at most 5 % of the device time unmatched, B1 in
     ``loss_resize`` and B2 in ``model_fwd``
  5. main path, eval: full-width R101 (random weights from a numpy seed,
     saved as student.pth), two synthetic 1024x2048 Cityscapes val images,
     evaluate_val in bf16; finite two-scale logits whose argmax matches the
     dumped predictions; eval timing (GroupNorm kernel vs plain, in turns),
     peak memory
  6. main path, warm-up: train_warm_up with preset gta2city_warmup at full
     width (R101, bf16, source 1 + 2 GTA5 images at 720x1280 and
     1052x1914, target 1 + 2 Cityscapes images at 512x1024 and 1024x2048,
     crop 512x896, random seeded translator, 3 steps); finite losses; the
     exported student.pth loads strictly into the eval model.  Then the
     step timed on one batch (distillation kernel vs plain, in turns):
     ms/step, source imgs/s, peak memory
  6b. device prefetch on the warm-up's full-resolution streams: host
     s/batch from the loader alone, to_device's host call and copy time;
     the warm-up step fed from batches on the host through to_device and
     through device_prefetch in turns, 6 steps each (wall ms/step, the
     host's wait for its batch); then 20 steps fed from the loader through
     device_prefetch, each batch copied back to pinned host memory after
     its step and required equal to its host copy; the loader alone with
     the C host ops and with their numpy forms, beside the numpy ops'
     0.216 s/batch and 515.35 ms/step of an earlier run
  7. main paths, self-training chain and DG, at full width from the
     warm-up's last-step state (``ckpt_final``: 3 steps with no eval
     write no best ``weights``), on two 1024x2048 Cityscapes train images:
     pseudolabel_generator (preset gta2city_warmup) writes P-mode PNGs into
     <target_root>/pseudo_train_warm_up; calc_centroids (one epoch) writes
     finite (19, 256) centroids; train_self_training (preset
     gta2city_selftrain: source 2 + 1, target 2 + 1 with the pseudo-labels,
     3 steps) logs finite losses and a consensus_kept in [0, 1]; train_dg
     (preset dg_gta5: source 2 + 2, target 2 + 2, 3 steps).  Then the
     pseudo-label ms/img and the self-training and DG steps timed as in 6;
     ``make_viz figure`` over the 2 pseudo-label PNGs (host only, no launch)
  7b. train_self_training --extra fuse_forwards=true (3 steps, from the
     warm-up's state): one teacher forward a step, every GroupNorm at (9,
     65, 113, 256); finite losses, consensus_kept in [0, 1].  Then the
     fused and unfused step timed in turns on one batch (ms/step, source
     imgs/s, peak memory; busy share under --profile).  Then parity_check
     --vs_torch_replay --compute_dtype float32 on the warm-up's student.pth
     and the two val images: pixel disagreement below 1e-3 against the
     replay, the activation difference printed; the bf16 disagreement
     printed beside it, not gated
  8. main paths, SYNTHIA->Cityscapes at full width (R101, 16 classes,
     bf16, synthetic SYNTHIA at its own 760x1280 with uint16 labels):
     train_warm_up (preset synthia2city_warmup: OHEM, LR warm-up 1000,
     ColorJitter p 0.7; source 1 + 3 at 720x1280 and 1140x1920, target 1 +
     3, crop 512x896, 3 steps) -> pseudolabel_generator (2 images, the
     16-class palette) -> calc_centroids on the target and with --source on
     SYNTHIA (finite (16, 256)) -> train_self_training (preset
     synthia2city_selftrain, 3 steps) -> evaluate_val at 16 classes (2 val
     images, scores with mean_iou_13); then train_warm_up --parity (preset
     gta2city_warmup, f32, the kornia chain, 2 steps, at one bottleneck a
     stage and R101's widths, to save f32 autotuning time).  Then the SYNTHIA
     warm-up step timed as in 6
  8b. main paths, the translator stage and the resume, at full width:
     train_domain_translator (preset gta2city_translator: encoders 64,
     decoders 256 with subpixel up-blocks, 4 residual blocks, 3-scale
     PatchGANs; source 1 + 1 GTA5 at 720x1280 and 1052x1914, target 1 + 1
     Cityscapes at 512x1024 and 1024x2048, crop 512x896, bf16, 3 steps):
     finite losses, the six roles in ``weights/``, ``ckpt_final/state.pth``
     at step 3; train_warm_up --load_weight_dir <translator>/weights (1
     step, the stage chain on the port's own weights); the translator step
     fused and unfused timed on one batch (ms/step, source imgs/s, peak
     memory; busy share under --profile); synthia2city_translator (2
     steps); a translator with a seeded VGG19 ``--vgg_weights`` (2 steps,
     the perceptual term with remat); train_warm_up --num_steps 2
     --save_every 1, then --resume --num_steps 3: one more step, from step
     2 to 3
  8c. main paths, the semi-supervised Cityscapes chain at full width
     (HRNet-W48+OCR, 19 classes, bf16, a numpy-seeded student.pth; 1024x2048
     Cityscapes fixtures: a labeled source of 2 images whose labels come
     through --target_lbl_list by position, an unlabeled target of 2, 2 val
     images): train_warm_up (semiseg_1_8_warmup: the DG step with the 0.1x
     OCR aux term and the RGB flip; source 1 + 2 at 512x1024 and 1024x2048,
     target 1 + 2 for the BN-statistics forward, crop 512x1024, 3 steps) ->
     pseudolabel_generator (2 images) -> calc_centroids (one epoch: finite
     (19, 512)) -> train_self_training (semiseg_1_8_selftrain, no
     translator, 3 steps) -> evaluate_val (2 images: finite two-scale
     logits whose argmax is the dumped prediction); each ckpt_final's
     student.pth loads strictly into the eval model.  Then the eval's ms/img
     and the warm-up and self-training steps timed as in 6, beside the
     compute floor counted from the code (``hrnet_ocr_gmacs``), and the
     self-training step fused against unfused as in 7b (one fused step
     launches B1 once and no B2), and the unfused step with its profiler
     scopes switched off, in turns with it, beside the scopes' count a step
     and their host cost alone: a bare ``record_function``, and the port's
     ``span`` with no recording open and with one
  8d. soaks through ``soak``'s CLI, each asserting its own invariants:
     ``--mode onchip --preset gta2city_warmup`` at full width
     (``SOAK_ONCHIP_STEPS``), ``--preset dg_gta5`` on 96x160 fixtures at
     R101's full depth (``SOAK_FIXTURE_STEPS``: the mid-run checkpoint
     restored into a fresh experiment, in-loop evals of 4 images) and
     ``--mode onchip --preset gta2city_translator``
     (``SOAK_TRANSLATOR_STEPS``); ms/step and source imgs/s of each
  8e. data-parallel training over processes: train_warm_up --n_devices 1
     at full width (3 steps, as in 6): an NCCL world of one rank in this
     process, so every BN is the synced BN on its reduce path and every
     step all-reduces the gradients in one flat bucket; the backend and the
     world size printed; its step-0 losses against the no-flag run's of 6
     within ``PARALLEL_LOSS_RTOL``.  Then its step built and timed as in 6
     in a world of one (ms/step against phase 6's no-group ms/step, the
     first step's losses from the built state against phase 6's).  Then
     ``dryrun_multichip(torch.cuda.device_count())`` (one step each of the
     translator, the batch-sharded eval, self-training, warm-up and semiseg
     at tiny shapes).  With 2 cards or more, the tiny f32 warm-up over 2
     ranks against 1 on the same global batch within
     ``PARALLEL_WORLD_RTOL``; with one card a line says it did not run
  8f. the height-sharded two-scale eval (``--shard spatial``) at full
     width on phase 5's first val image: R101 over 2, 4 and 8 local shards
     (``parallel/spatial.py``'s ``LocalShards``: one thread a shard on this
     card, since NCCL puts no two ranks on one card) in f32 without TF32
     from cuDNN's heuristics, predictions against the unsharded eval's on
     at most ``SPATIAL_GATE`` of the pixels; then in bf16 (the path's
     dtype, cuDNN tuned) over the same shards, at most ``SPATIAL_GATE`` of
     the pixels whose unsharded top two logits differ by more than
     ``SPATIAL_MARGIN_ULPS`` bf16 ulps, which must be at least
     ``SPATIAL_DECIDED_MIN`` of them (the disagreement over every pixel,
     the exact ties and the disagreement by margin printed); in every run
     B2a and B2b at exactly the shards' rows of the eval's two sites,
     every shard's confusion equal, the scored pixels equal, the logits'
     largest difference and the mIoU difference printed; ms/img of the
     halo path in an NCCL world of one (the group transport) and over 2
     and 4 local shards against unsharded, in turns; HRNet-W48+OCR over 2
     shards in f32, gated the same way; ``evaluate_val --n_devices 1
     --shard spatial`` (2 images, an NCCL world of one): B2 at the eval's
     two sites, its scored pixels the labels' valid pixels, its dumped
     predictions against this phase's unsharded bf16 eval of the same
     images under the bf16 gate, its mIoU beside phase 5's printed
  9. kernel timing: per-site GroupNorm and distillation device times
     (CUDA events around back-to-back calls queued behind a sleep kernel)
     against their byte bounds, plain versions and nearest library calls
     (``torch.addcmul`` for B2b, ``torch.var_mean`` for B2a), with the
     kernels' launch plans; B2b alone (stream order) and the whole
     ``group_norm`` (the pair) per site; D1a (forward and input gradient)
     and D1b at training's six depthwise sites, beside their byte bounds,
     their plain versions and, as yardsticks the port never calls, cuDNN's
     call (``cudnn.benchmark`` on) and ATen's depthwise kernels (cuDNN
     off); then the ``kernels`` JSON line, the card line and the result
     line

Every CLI run counts the launches of the port's kernels that the card ran
(CUPTI's kernel records, ``utils/profiling.py::device_launches``: a train path's model calls
replay as CUDA graphs, which launch their kernels without the wrappers;
phase 5's evaluate_val, ``dryrun_multichip`` and the height-sharded
evals, which replay no graph, read the wrappers' tallies), and requires
per run no launch of D1a or D1b (no path here builds MiT-B5) and of
(B1a, B1b, B2a, B2b):
evaluate_val (2 images) 0, 0, 24, 24; train_warm_up (3 steps) 3, 3, 18,
18; pseudolabel_generator (2 images) 0, 0, 24, 24; calc_centroids (2
images) 0, 0, 12, 12; train_self_training (3 steps) 3, 3, 36, 36;
train_dg (3 steps) 3, 3, 18, 18; the SYNTHIA chain the same per CLI
(calc_centroids twice: target and source); train_warm_up --parity (2
steps) 2, 2, 12, 12; each train_domain_translator run 0, 0, 0, 0 (the
translator stage reaches no TPU kernel: its InstanceNorm is plain
reductions); the warm-up from the translator's weights (1 step) 1, 1, 6,
6; the resume's two warm-ups (2 steps, then 1) 2, 2, 12, 12 and 1, 1, 6,
6; train_warm_up --n_devices 1 (3 steps) 3, 3, 18, 18;
dryrun_multichip(1) (one card: in this process) at least one of each;
the height-sharded R101 eval of one image over n shards (f32 and bf16)
0, 0, 12n, 12n (6 sites x 2 scales x n shards), HRNet-W48+OCR's 0, 0, 0,
0, and evaluate_val --n_devices 1 --shard spatial (2 images) 0, 0, 24, 24;
the semiseg train_warm_up (3 steps) 6, 6, 0, 0 (the logits and the
OCR aux logits), train_self_training (3 steps) 3, 3, 0, 0, and its
pseudolabel_generator, calc_centroids and evaluate_val 0, 0, 0, 0
(HRNet+OCR has no GroupNorm); profile_step (its 2 traced steps, from its
own trace) 2, 2, 12, 12; the
fused train_self_training (3 steps) 3, 3, 18, 18; parity_check 0, 0, 30,
30 (6 for the activation input, 2 images x 2 scales x 6); the onchip
warm-up soak (N steps) N, N, 6N, 6N; the DG fixture soak (N steps, E
evals) N, N, 6N + 48E, 6N + 48E (4 val images x 2 scales x 6); the
onchip translator soak 0, 0, 0, 0.  On a train path every B1a launch must be
at its site: bf16 (6, 512, 896, 19) for the GTA5 warm-ups and
self-training, (8, 512, 896, 19) for DG, (8, 512, 896, 16) and (6, 512,
896, 16) for the SYNTHIA warm-up and self-training, f32 (6, 512, 896, 19)
under --parity, bf16 (6, 512, 1024, 19) for the semiseg warm-up and
self-training, bf16 (6, 512, 896, 19) for profile_step and the fused
self-training, bf16 (8, 64, 128, 19) for the DG fixture soak; every
GroupNorm of the fused self-training at (9, 65, 113, 256), of profile_step
and the onchip warm-up soak at (6, 65, 113, 256), of parity_check at (1, 17, 29,
256), (1, 129, 257, 256) and (1, 65, 129, 256).  A kernel's
``launches`` in the JSON line is its sum over these runs.

``--profile DIR`` also writes torch.profiler tables and traces of one
two-scale eval and of one warm-up, self-training, DG and translator step,
of the semiseg eval, warm-up and self-training step, and of the fused and
unfused self-training steps (GTA5 and semiseg), into DIR, with their busy
shares.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from diga_tpu_torch.cli import (calc_centroids, evaluate_val, make_viz, parity_check,
                                pseudolabel_generator, soak, train_dg, train_domain_translator,
                                train_self_training, train_warm_up)
from diga_tpu_torch.cli import profile_step as profile_step_cli
from diga_tpu_torch.configs.presets import get_preset
from diga_tpu_torch.data import cityscapes_dataset, label_maps, synthetic
from diga_tpu_torch.data.normalize import IMG_MEAN_BGR, normalize_image
from diga_tpu_torch.data.prefetch import device_prefetch
from diga_tpu_torch.eval.evaluator import two_scale_logits
from diga_tpu_torch.models import resnet_deeplab
from diga_tpu_torch.models.hrnet_ocr import HRNetOCR
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.models import translator as translator_module
from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder
from diga_tpu_torch.models.vgg import VGG19Features
from diga_tpu_torch.ops import distill as D
from diga_tpu_torch.ops import depthwise as DW
from diga_tpu_torch.ops import group_norm as G
from diga_tpu_torch.ops import mixing, native
from diga_tpu_torch.ops import photometric as P
from diga_tpu_torch.ops.prototypes import Centroids
from diga_tpu_torch.ops.losses import distillation_loss as plain_distillation_loss
from diga_tpu_torch.ops.metrics import confusion_update
from diga_tpu_torch.eval.evaluator import TwoScaleEvaluator
from diga_tpu_torch.parallel import dist, spatial, spatial_ops
from diga_tpu_torch.parallel.dryrun import dryrun_multichip, warmup_world
from diga_tpu_torch.parallel.spatial_ops import convert_spatial
from diga_tpu_torch.parallel.sync_bn import SyncBatchNorm2d
from diga_tpu_torch.train.build import (build_eval, build_experiment, make_schedule,
                                        make_step_config, wants_target)
from diga_tpu_torch.train.loop import make_train_iterator, make_translator_iterator, to_device
from diga_tpu_torch.train.optim import sgd_grouped
from diga_tpu_torch.train.schedules import poly_schedule
from diga_tpu_torch.train.state import create_seg_state
from diga_tpu_torch.train import graphs as graphs_module
from diga_tpu_torch.train import steps as steps_module
from diga_tpu_torch.train import steps_translator as steps_translator_module
from diga_tpu_torch.train.steps import (StepConfig, build_dg_step, build_selftrain_step,
                                        build_warmup_step)
from diga_tpu_torch.train.steps_translator import ROLES, build_translator_step
from diga_tpu_torch.utils import native as host_ops
from diga_tpu_torch.utils.checkpoint import export_role_keyed
from diga_tpu_torch.utils import profiling as span_recorder

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 non-tensor-core FLOP/s, the rate the GroupNorm arithmetic runs at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, the semiseg steps' compute floor
SLEEP_CYCLES_PER_MS = 2_000_000  # torch.cuda._sleep at the H100's clock of at most 1.98 GHz
GN_SITES = [(1, 129, 257, 256), (1, 65, 129, 256)]  # eval ASPP GN at full / half scale
GN_TRAIN_SITES = [
    (6, 65, 113, 256),  # the warm-ups' and self-trainings' teachers on 6 images, crop 512x896
    (3, 65, 113, 256),  # the self-training teachers on the target
    (8, 65, 113, 256),  # the DG and SYNTHIA warm-up teachers on 8 images
    (9, 65, 113, 256),  # the fused self-training teacher on [source; mix; target], 3 + 3 + 3
]
GN_SOURCE_SITE = (1, 91, 161, 256)  # calc_centroids --source on the 720x1280 source stream
GN_PARITY_SITE = (1, 17, 29, 256)  # parity_check's activation input, 129x225 at output stride 8
SPATIAL_SHARDS = (2, 4, 8)  # phase 8f: R101's height split over this many local shards


def gn_slab_sites(n: int) -> set:
    """The GroupNorm sites of the height-sharded eval over ``n`` shards:
    each shard's rows of the eval's two sites (``parallel/spatial.py``'s
    balanced split; a shard with no rows launches nothing)."""
    return {(b, hi - lo, w, c) for b, h, w, c in GN_SITES
            for lo, hi in (spatial.rows(h, n, r) for r in range(n)) if hi > lo}


GN_SPATIAL_SITES = sorted(set().union(*(gn_slab_sites(n) for n in SPATIAL_SHARDS)))
# phase 9 times the one-device sites; phase 3 checks these and the slabs
GN_TIMED_SITES = GN_SITES + GN_TRAIN_SITES + [GN_SOURCE_SITE, GN_PARITY_SITE]
GN_PATH_SITES = GN_TIMED_SITES + GN_SPATIAL_SITES
GN_CHECKS = [  # (shape, base pointer offset in bytes)
    *((s, 0) for s in GN_PATH_SITES),
    ((2, 17, 29, 256), 0),  # ragged
    ((2, 8, 16, 64), 0),  # C=64
    ((2, 9, 11, 32), 0),  # C=32, one channel per group
    ((1, 1, 1, 256), 0),  # one row: seven of the cluster's eight blocks have none
    ((1, 3, 5, 256), 0),  # 15 rows, fewer than one tile (32 bf16 / 16 f32 rows)
    ((1, 16, 32, 256), 0),  # 512 rows: one whole tile per block in both dtypes
    ((6, 7, 13, 256), 0),  # batch 6, ragged H·W: six tickets
    ((2, 17, 29, 256), 16),  # base 16-byte but not 128-byte aligned
]
DISTILL_SHAPE = (6, 512, 896, 19)  # warm-up/self-training upsampled [clean; aug] logits
DISTILL_DG_SHAPE = (8, 512, 896, 19)  # the DG step's, 4 source images
DISTILL_SYNTHIA_WARMUP_SHAPE = (8, 512, 896, 16)  # the SYNTHIA warm-up's, 1 + 3 source images
DISTILL_SYNTHIA_SELFTRAIN_SHAPE = (6, 512, 896, 16)  # the SYNTHIA self-training's, 1 + 2
# the semiseg warm-up's (logits and OCR aux logits) and self-training's, 1 + 2 at crop 512x1024
DISTILL_SEMISEG_SHAPE = (6, 512, 1024, 19)
DISTILL_SITES = [DISTILL_SHAPE, DISTILL_DG_SHAPE, DISTILL_SYNTHIA_WARMUP_SHAPE,
                 DISTILL_SYNTHIA_SELFTRAIN_SHAPE, DISTILL_SEMISEG_SHAPE]
BOTH = (torch.float32, torch.bfloat16)
DISTILL_CHECKS = [  # (shape, dtypes, logit scale, base pointer offset in elements)
    (DISTILL_SHAPE, BOTH, 3.0, 0),
    (DISTILL_DG_SHAPE, BOTH, 3.0, 0),
    (DISTILL_SYNTHIA_WARMUP_SHAPE, BOTH, 3.0, 0),
    (DISTILL_SYNTHIA_SELFTRAIN_SHAPE, BOTH, 3.0, 0),
    (DISTILL_SEMISEG_SHAPE, BOTH, 3.0, 0),
    ((2, 7, 13, 19), BOTH, 3.0, 0),  # ragged; the aug half starts at 91·K·elem, not 16-aligned
    ((2, 9, 11, 16), BOTH, 3.0, 0),  # K=16 (SYNTHIA)
    ((2, 8, 16, 32), BOTH, 3.0, 0),  # K=32, the largest tiles
    ((2, 1, 5, 19), BOTH, 3.0, 0),  # fewer pixels than one tile
    ((2, 16, 32, 19), BOTH, 3.0, 0),  # 512 pixels: a whole number of tiles in both dtypes
    ((2, 8, 16, 32), BOTH, 3.0, 1),  # base pointer 1 element past 16-byte alignment
    (DISTILL_SHAPE, (torch.bfloat16,), 30.0, 0),  # peaky logits (x10)
]
# MiT-B5's sep-ASPP depthwise convs (NHWC shape, dilation): training's
# teacher and student at batch 6 and the target statistics at batch 3, and
# the two-scale eval's batch 1 at both scales of a 1024x2048 image
DEPTHWISE_DILATIONS = (6, 12, 18)
DEPTHWISE_TRAIN_SHAPES = [(6, 128, 224, 1024), (3, 128, 224, 1024)]
DEPTHWISE_EVAL_SHAPES = [(1, 256, 512, 1024), (1, 128, 256, 1024)]
DEPTHWISE_CHECKS = [  # (NHWC shape, dilation, dtypes)
    *((s, d, BOTH) for s in DEPTHWISE_TRAIN_SHAPES for d in DEPTHWISE_DILATIONS),
    *((s, d, (torch.bfloat16,)) for s in DEPTHWISE_EVAL_SHAPES for d in DEPTHWISE_DILATIONS),
    ((2, 9, 13, 40), 18, BOTH),  # smaller than the halo, ragged, 5 bf16 vectors
    ((1, 5, 7, 8), 6, BOTH),  # one bf16 vector of channels
    ((2, 17, 97, 1032), 1, BOTH),  # two channel slices, the second ragged; 4 runs a row
    ((1, 3, 300, 64), 12, BOTH),  # a wide row: 25 outputs a residue
]
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
PRESET = "gta2city_warmup"
SELFTRAIN_PRESET = "gta2city_selftrain"
DG_PRESET = "dg_gta5"
SYNTHIA_PRESET = "synthia2city_warmup"
SYNTHIA_SELFTRAIN_PRESET = "synthia2city_selftrain"
TRANSLATOR_PRESET = "gta2city_translator"
SYNTHIA_TRANSLATOR_PRESET = "synthia2city_translator"
SEMISEG_WARMUP_PRESET = "semiseg_1_8_warmup"
SEMISEG_SELFTRAIN_PRESET = "semiseg_1_8_selftrain"
PSEUDO_DIR = "pseudo_train_warm_up"  # the self-training presets' pseudo_dir
OUT_HW, DS_HW = (1024, 2048), (512, 1024)
SYNTHIA_HW = (760, 1280)  # SYNTHIA-RAND-CITYSCAPES' own image size
N_IMAGES = 2
SEED = 0
TRAIN_STEPS = 3
PARITY_STEPS = 2
PARITY_LAYERS = [1, 1, 1, 1]  # the --parity warm-up's depth: R101's widths, one block a stage
TRAIN_PATHS = ("train_warm_up", "train_self_training", "train_dg", "synthia train_warm_up",
               "synthia train_self_training", "parity train_warm_up",
               "translated train_warm_up", "resume train_warm_up", "resumed train_warm_up",
               "fused train_self_training", "profile_step", "soak onchip gta2city_warmup",
               "soak fixtures dg_gta5", "n_devices train_warm_up", "dryrun_multichip")
# phase 8e: the world-1 warm-up's losses against the no-flag run's, bf16 (the
# synced BN's f32 arithmetic against cuDNN's BatchNorm, and cuDNN's own
# run-to-run spread); the 2-rank tiny warm-up against the 1-rank one, f32
PARALLEL_LOSS_RTOL = 2e-2
SPATIAL_HRNET_SHARDS = 2
SPATIAL_TIMED_SHARDS = (2, 4)  # bf16 ms/img, beside the world of one NCCL rank
SPATIAL_GATE = 1e-3  # pixel disagreement with the unsharded eval (parity_check's gate)
# bf16: the gate holds on the pixels whose unsharded top two logits differ by
# more than this many bf16 ulps of the top one (cuDNN's algorithms for the slab
# shapes round differently; ties and near-ties may go either way), and those
# pixels must be at least SPATIAL_DECIDED_MIN of the image (with the seeded
# R101 on phase 5's images, over 4 ulps: 0.881-0.882 of the pixels, 9.2e-6 to
# 3.3e-5 of them disagreeing at n = 1, 2, 4, 8; over 2 ulps 2.5e-4 to 9.0e-4)
SPATIAL_MARGIN_ULPS = 4
SPATIAL_DECIDED_MIN = 0.8
SPATIAL_HRNET_PATH = f"spatial eval HRNet-W48+OCR f32 n={SPATIAL_HRNET_SHARDS}"
PARALLEL_WORLD_RTOL = 1e-4
PREFETCH_BATCHES = 20  # prefetched batches held equal to their host copies under real steps
PROFILE_STEPS = 2  # profile_step's traced (and untraced timed) steps, after its 2 warm-up steps
TRANSLATOR_STEPS = 3
TRANSLATOR_SHORT_STEPS = 2  # the SYNTHIA and the VGG translator runs
# the translator stage reaches no TPU kernel: each run must launch none
TRANSLATOR_PATHS = ("train_domain_translator", "synthia train_domain_translator",
                    "vgg train_domain_translator", "soak onchip gta2city_translator")
# the soaks' steps: the fewest at which each one's invariants hold with margin (a
# step-by-step probe on the card: the onchip warm-up's loss falls from 5.23 to 4.15 by
# step 9, the translator's self-recon L1 from 0.996 to 0.901 by step 11, and the DG
# fixture soak's loss windows from 4.52 to 4.39 at 40 steps)
SOAK_ONCHIP_STEPS = 12
SOAK_FIXTURE_STEPS = 40
SOAK_TRANSLATOR_STEPS = 12
# phase 6b with the numpy host ops (an earlier run, NVIDIA H100 80GB HBM3, 700 W)
NUMPY_OPS_LOADER_S, NUMPY_OPS_LOADER_FED_MS = 0.216, 515.35
# HRNet+OCR has no GroupNorm: its train paths launch B1 only, its eval paths nothing
SEMISEG_TRAIN_PATHS = ("semiseg train_warm_up", "semiseg train_self_training")
SEMISEG_EVAL_PATHS = ("semiseg pseudolabel_generator", "semiseg calc_centroids",
                      "semiseg evaluate_val")
TINY_HRNET = {  # phase 4's HRNet+OCR: one block per stage, branches (8, 16, 32, 64)
    "stem_channels": 8, "stage1_blocks": 1, "stage1_channels": 8,
    "stages": [(1, 1, (8, 16)), (1, 1, (8, 16, 32)), (1, 1, (8, 16, 32, 64))],
    "ocr_mid_channels": 32, "ocr_key_channels": 16,
}
DEVICE = torch.device("cuda")  # the main paths' device, passed to every CLI as --device
TPU_KERNELS = {  # name: (id, source, the TPU kernel it replaces)
    "distill_loss": ("B1a", "diga_tpu_torch/csrc/distill.cu", "diga_tpu/ops/pallas_kernels.py:35"),
    "distill_grad": ("B1b", "diga_tpu_torch/csrc/distill.cu", "diga_tpu/ops/pallas_kernels.py:85"),
    "group_norm_stats": ("B2a", "diga_tpu_torch/csrc/group_norm.cu", "diga_tpu/ops/pallas_gn.py:53"),
    "group_norm_apply": ("B2b", "diga_tpu_torch/csrc/group_norm.cu", "diga_tpu/ops/pallas_gn.py:74"),
}


# kernels of the port that replace no TPU kernel (diga_tpu leaves convolutions
# to XLA): name: (id, source, what they serve); no path of this script builds
# MiT-B5, so phase 3 checks and phase 9 times them alone
PORT_ONLY_KERNELS = {
    "depthwise_fwd": ("D1a", "diga_tpu_torch/csrc/depthwise.cu",
                      "MiT-B5's sep-ASPP depthwise 3x3 convs and their input gradients"),
    "depthwise_wgrad": ("D1b", "diga_tpu_torch/csrc/depthwise.cu",
                        "the weight gradients of MiT-B5's sep-ASPP depthwise 3x3 convs"),
}


def launches() -> dict:
    return {**G.launches, **D.launches, **DW.launches}


def reset_launches() -> None:
    G.reset_launches()
    D.reset_launches()
    DW.reset_launches()


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Random weights for ``model``'s keys from a numpy seed: kaiming-scaled
    convs and linears, BN statistics near (0, 1), small scales on the last
    BN of each residual branch (DeepLab's bottlenecks, HRNet's BasicBlocks)
    so activations stay bounded through the residual chains."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = v.clone()
            continue
        if len(shape) >= 2:  # conv (O, I, kh, kw) or linear (O, I)
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(size=shape) * math.sqrt(2.0 / fan_in)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            a = rng.normal(size=shape) * 0.1
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif ".bn3." in k or (".branches." in k and ".bn2." in k):
            a = rng.uniform(0.1, 0.3, size=shape)
        else:  # BN / GN scales
            a = rng.uniform(0.8, 1.2, size=shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def gn_inputs(shape, dtype, seed, offset=0, device="cuda"):
    """Seeded x, scale, bias; ``offset`` > 0 places x that many bytes into a
    larger buffer (contiguous, base pointer moved off 128-byte alignment)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) + rng.uniform(-2, 2, size=(c,))).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    xt = torch.from_numpy(x).to(device, dtype)
    if offset:
        k = offset // xt.element_size()
        buf = torch.empty(xt.numel() + k, device=device, dtype=dtype)
        buf[k:] = xt.reshape(-1)
        xt = buf[k:].view(shape)
    return (xt, torch.from_numpy(scale).to(device), torch.from_numpy(bias).to(device), x)


def gn_plan(x: torch.Tensor):
    """B2a's launch plan on x, as the wrapper makes it."""
    b, h, w, c = x.shape
    return G.stats_plan(b, h * w, c, x.element_size(), G.max_clusters(x.device.index, x.dtype, c))


def gn_apply_plan(x: torch.Tensor):
    """B2b's launch plan on x, as the wrappers make it."""
    b, h, w, c = x.shape
    return G.apply_plan(b, h * w, c, x.element_size(), native.sm_count(x.device.index))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    logs = native.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    host_ops.build()
    print(f"build: {os.path.relpath(host_ops.LIBRARY)} (g++) in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_host_ops(card: str) -> dict:
    """The C host ops of the loaders held bit-equal to their numpy forms on
    one 1024x2048 image and label (the BN-statistics target's size), with
    each one's host ms (the best of 5) beside numpy's."""
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, size=(*OUT_HW, 3), dtype=np.uint8)
    lbl = rng.integers(0, 256, size=OUT_HW, dtype=np.uint8)
    gt = host_ops.remap_u8(lbl, label_maps.CITYSCAPES_LUT).astype(np.int32)
    pred = rng.integers(-1, 21, size=OUT_HW).astype(np.int32)
    pairs = {
        "normalize_bgr": (host_ops.normalize_bgr, normalize_image, (img, IMG_MEAN_BGR)),
        "remap_u8": (host_ops.remap_u8, label_maps.remap_labels, (lbl, label_maps.GTA5_LUT)),
        "fast_hist": (host_ops.fast_hist, host_ops.fast_hist_plain, (gt, pred, 19)),
        "label_histogram": (host_ops.label_histogram, host_ops.label_histogram_plain, (lbl,)),
    }

    def best_ms(fn, args) -> float:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    out = {}
    for name, (c_op, plain, args) in pairs.items():
        a, b = c_op(*args), plain(*args)
        require(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
                f"host op {name}: the C op differs from its numpy form")
        out[name] = (best_ms(c_op, args), best_ms(plain, args))
    print(f"host ops at {OUT_HW[0]}x{OUT_HW[1]}, bit-equal to numpy; host ms C / numpy: "
          + ", ".join(f"{k} {c:.2f} / {p:.2f}" for k, (c, p) in out.items())
          + f" | card={card}", flush=True)
    return out


def phase_kernels_vs_plain() -> dict:
    """Returns, per kernel, the largest |kernel - plain| at the path's sites (bf16)."""
    errs = {name: 0.0 for name in G.launches}  # the GroupNorm pair
    for i, (shape, offset) in enumerate(GN_CHECKS):
        for dtype in (torch.float32, torch.bfloat16):
            x, sc, bi, x_np = gn_inputs(shape, dtype, seed=100 + i, offset=offset)
            tol = TOL[dtype]
            tag = (f"shape={shape} dtype={str(dtype).split('.')[-1]}"
                   + (f" base offset {offset} B" if offset else ""))
            require(x.data_ptr() % 16 == 0 and (offset == 0) == (x.data_ptr() % 128 == 0),
                    f"base pointer alignment at {tag}")
            with torch.inference_mode():
                runs = []  # B2a, B2b alone on its mul/add, the pair (B2b under B2a's tail)
                for _ in range(3):
                    st = G.group_norm_stats(x, sc, bi)
                    runs.append((*st, G.group_norm_apply(x, st[2], st[3]), G.group_norm(x, sc, bi)))
                    torch.cuda.synchronize()
                    require(not bool(G.ticket_workspace(x.device).any()),
                            f"B2a's tickets not back at zero after a call at {tag}")
                s, s2, mul, add, y, y_pair = runs[0]
                ps, ps2, pmul, padd = G.group_norm_stats_plain(x, sc, bi)
                py_apply = G.group_norm_apply_plain(x, mul, add)
                py = G.group_norm_plain(x, sc, bi)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for r in runs[1:] for a, b in zip(runs[0], r)),
                    f"kernel results differ between three runs at {tag}")
            require(y.dtype == dtype and y.shape == x.shape, f"output dtype/shape at {tag}")
            if dtype == torch.float32:
                xq = x_np.astype(np.float64)
                abs_sum = torch.from_numpy(np.abs(xq).sum(axis=(1, 2))).to(s.device)
                sq_sum = torch.from_numpy((xq * xq).sum(axis=(1, 2))).to(s.device)
                e_s = float(((s.double() - ps.double()).abs() / abs_sum).max())
                e_s2 = float(((s2.double() - ps2.double()).abs() / sq_sum).max())
                require(e_s <= 1e-5 and e_s2 <= 1e-5,
                        f"channel sums off at {tag}: rel {e_s:.2e}, {e_s2:.2e}")
            require(close(mul, pmul, tol) and close(add, padd, tol), f"mul/add off at {tag}")
            # B2b repeats the plain version's arithmetic (the product rounded
            # to x's type before the add), so it must match it bit for bit
            require(torch.equal(y, py_apply), f"B2b alone not bitwise the plain version at {tag}: "
                    f"max_abs_err {max_err(y, py_apply):.3e}")
            require(torch.equal(y_pair, py_apply), f"B2b in group_norm not bitwise the plain "
                    f"version at {tag}: max_abs_err {max_err(y_pair, py_apply):.3e}")
            require(close(y_pair, py, tol), f"group_norm off at {tag}")
            e_stats = max(max_err(mul, pmul), max_err(add, padd))
            e_apply = max_err(y, py_apply)
            print(f"check {tag}: stats max_abs_err={e_stats:.3e} apply bitwise equal alone and in "
                  f"group_norm, group_norm max_abs_err={max_err(y_pair, py):.3e} tol={tol} "
                  f"bitwise-repeatable x3, tickets zero | B2a plan {gn_plan(x).describe()} | B2b "
                  f"plan {gn_apply_plan(x).describe()}", flush=True)
            if shape in GN_PATH_SITES and dtype == torch.bfloat16:
                errs["group_norm_stats"] = max(errs["group_norm_stats"], e_stats)
                errs["group_norm_apply"] = max(errs["group_norm_apply"], e_apply)
    return errs


def gn_site_inputs(shape, gen, dtype=torch.bfloat16):
    """Enough seeded copies of x at a path site to exceed the 50 MB L2 when
    cycled, and f32 scale/bias."""
    c = shape[-1]
    n_buf = max(2, math.ceil(120e6 / (math.prod(shape) * 2)))
    xs = [(torch.randn(shape, generator=gen, device="cuda") + 1.0).to(dtype)
          for _ in range(n_buf)]
    sc = torch.rand(c, generator=gen, device="cuda") + 0.5
    bi = torch.randn(c, generator=gen, device="cuda") * 0.1
    return xs, sc, bi


def phase_model_gpu_vs_cpu() -> None:
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        layers = (1, 1, 1, 1)
        sd = seeded_state_dict(DeepLabV2(19, layers), SEED + 1)
        x = np.random.default_rng(SEED + 2).normal(size=(1, 129, 257, 3)).astype(np.float32)
        logits = {}
        for dev in ("cpu", "cuda"):
            model = DeepLabV2(19, layers)
            model.load_state_dict(sd, strict=True)
            model.eval().to(dev)
            with torch.inference_mode():
                logits[dev] = model(torch.from_numpy(x).to(dev).permute(0, 3, 1, 2))[2].cpu()
        scale = float(logits["cpu"].abs().max())
        err = max_err(logits["cuda"], logits["cpu"])
        require(math.isfinite(err) and err <= 1e-3 * scale,
                f"tiny model on the card vs the CPU: max_abs_err {err:.3e} > 1e-3 x {scale:.3e}")
        print(f"model gpu-vs-cpu layers={layers} f32 tf32=off: max_abs_err={err:.3e} "
              f"max|logit|={scale:.3e} tol=1e-3*max|logit|", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def phase_main_path(work: str) -> tuple[dict, dict]:
    """evaluate_val at full width; returns (launch counts, fixture paths)."""
    root = os.path.join(work, "city")
    t0 = time.perf_counter()
    val_img, val_lbl = synthetic.make_cityscapes_fixture(
        root, n=N_IMAGES, h=OUT_HW[0], w=OUT_HW[1], split="val")
    wdir = os.path.join(work, "weights")
    export_role_keyed(wdir, {"student": seeded_state_dict(DeepLabV2(19), SEED)})
    print(f"main path setup (fixture + student.pth): {time.perf_counter() - t0:.1f} s", flush=True)
    dump = os.path.join(work, "preds")
    argv = ["--preset", PRESET, "--weight_dir", wdir, "--eval_limit", str(N_IMAGES),
            "--target_root", root, "--val_img_list", val_img, "--val_lbl_list", val_lbl,
            "--dump_preds", dump]

    reset_launches()
    t0 = time.perf_counter()
    results = evaluate_val.main(argv)
    torch.cuda.synchronize()
    counts = launches()
    print(f"main path: evaluate_val {N_IMAGES} images in {time.perf_counter() - t0:.1f} s "
          f"(model build and first-call set-up included); launches={counts}", flush=True)
    gn = N_IMAGES * 2 * 6  # images x scales x ASPP GroupNorm sites
    want = kernel_counts(0, gn)
    require(counts == want, f"kernel launches on the eval path {counts}, expected {want}")
    scores = results.get("cityscapes", {})
    require({"overall_acc", "mean_acc", "fwavacc", "mean_iou"} <= set(scores),
            f"no mIoU dict from evaluate_val: {results}")
    require(0.0 <= scores["mean_iou"] <= 1.0, f"mean_iou out of range: {scores}")
    print("main path scores: " + json.dumps({k: float(v) for k, v in scores.items()}))
    return counts, {"root": root, "val_img": val_img, "val_lbl": val_lbl,
                    "wdir": wdir, "dump": dump, "scores": scores}


def check_outputs(eval_apply, paths: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Finite two-scale logits whose argmax is what evaluate_val dumped."""
    ds = cityscapes_dataset(paths["root"], paths["val_img"], paths["val_lbl"], resize_hw=OUT_HW)
    sample = ds[0]
    img = torch.from_numpy(sample["image"][None]).cuda()
    lbl = torch.from_numpy(sample["label"][None].astype(np.int64)).cuda()
    with torch.inference_mode():
        merged = two_scale_logits(eval_apply, img, OUT_HW, DS_HW)
    require(tuple(merged.shape) == (1, *OUT_HW, 19), f"logits shape {tuple(merged.shape)}")
    require(bool(torch.isfinite(merged).all()), "non-finite two-scale logits")
    pred = merged.argmax(-1)[0].cpu().numpy()
    base = os.path.splitext(os.path.basename(sample["name"]))[0]
    dumped = np.array(Image.open(os.path.join(paths["dump"], base + ".png")))
    agree = float((dumped == pred).mean())
    require(agree >= 0.999, f"dumped predictions agree with recomputed argmax on {agree:.5f}")
    print(f"outputs: logits {tuple(merged.shape)} {merged.dtype} finite, "
          f"max|logit|={float(merged.float().abs().max()):.3e}, "
          f"argmax agrees with the dumped prediction on {agree:.6f} of pixels", flush=True)
    return img, lbl


def eval_ms_per_img(eval_apply, img, lbl, n: int) -> float:
    conf = torch.zeros((19, 19), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(n):
            merged = two_scale_logits(eval_apply, img, OUT_HW, DS_HW)
            conf = confusion_update(conf, lbl, merged.argmax(-1), 19)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_eval_timing(eval_apply, img, lbl, card: str) -> float:
    """Two-scale ms/img with the GroupNorm kernel and with its plain version,
    in turns; returns the kernel's."""
    for _ in range(2):  # warm-up: cuDNN set-up, allocator
        eval_ms_per_img(eval_apply, img, lbl, 1)
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    for variant in ("kernel", "plain", "plain", "kernel"):
        resnet_deeplab.group_norm = G.group_norm if variant == "kernel" else G.group_norm_plain
        try:
            times[variant].append(eval_ms_per_img(eval_apply, img, lbl, 5))
        finally:
            resnet_deeplab.group_norm = G.group_norm
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    k, p = (float(np.mean(times[v])) for v in ("kernel", "plain"))
    print(f"eval two-scale R101 bf16 batch 1 {OUT_HW[0]}x{OUT_HW[1]}+{DS_HW[0]}x{DS_HW[1]}: "
          f"ms/img gn=kernel {k:.2f} {times['kernel']} gn=plain {p:.2f} {times['plain']} "
          f"peak_mem_MiB={peak_mb:.0f} | card={card}", flush=True)
    return k


def device_time_us(events) -> float:
    """Summed self time of the device-side events (kernels, copies) of a
    torch.profiler ``key_averages()``, in µs."""
    from torch.autograd import DeviceType

    return sum(getattr(e, "self_device_time_total", 0.0) for e in events
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))


def time_us(fn, arg_sets, iters: int = 100) -> tuple[float, float]:
    """(device µs, call µs) per call, cycling through ``arg_sets`` (together
    larger than the 50 MB L2, so each call reads cold data).  Device µs:
    CUDA events around ``iters`` back-to-back calls queued whole behind a
    sleep kernel that outlasts the host's queueing, so the card runs them
    with no host time between (the ~1 µs gaps between kernels count); where
    the launch queue fills before the sleep ends, fewer calls.  Call µs:
    CUDA events around ``iters`` back-to-back calls without the sleep, which
    is the host's launch cost where that exceeds the device time.  The sleep
    is three times what the host should need, and a queue the host was too
    slow for is retried with fewer calls."""
    def run(i):
        fn(*arg_sets[i % len(arg_sets)])

    def event():
        return torch.cuda.Event(enable_timing=True)

    for i in range(iters):  # warm-up
        run(i)
    start, end = event(), event()
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        run(i)
    end.record()
    torch.cuda.synchronize()
    call = start.elapsed_time(end) / iters * 1e3
    n = iters
    for _ in range(8):
        sleep_ms = 3e-3 * n * call + 5.0  # the host queues a call in at most `call` µs
        torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
        t0 = time.perf_counter()
        start.record()
        for i in range(n):
            run(i)
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms < 0.8 * sleep_ms:  # the card never waited for the host
            return start.elapsed_time(end) / n * 1e3, call
        n = max(10, n // 2)
    raise SmokeFailure(f"time_us: the host could not queue {n} calls of {fn} within the sleep")


def bound_us(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    t_ops = n_flops / F32_FLOPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_gn_timing(card: str) -> dict:
    """Per-site times; returns the kernels' numbers at the full-scale site."""
    dtype = torch.bfloat16
    per_kernel = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in GN_TIMED_SITES:
        b, h, w, c = shape
        numel = b * h * w * c
        xb = numel * 2
        xs, sc, bi = gn_site_inputs(shape, gen, dtype)
        sc16, bi16 = sc.to(dtype), bi.to(dtype)
        with torch.inference_mode():
            ma = [G.group_norm_stats_plain(x, sc, bi)[2:] for x in xs]
            full = [(x, sc, bi) for x in xs]
            app = [(x, m, a) for x, (m, a) in zip(xs, ma)]
            lib_app = [(a[:, None, None, :], x, m[:, None, None, :]) for x, (m, a) in zip(xs, ma)]
            nchw = [(x.permute(0, 3, 1, 2), 32, sc16, bi16, 1e-5) for x in xs]
            t = {
                "gn": time_us(G.group_norm, full),
                "gn_plain": time_us(G.group_norm_plain, full),
                "gn_library": time_us(F.group_norm, nchw),
                "stats": time_us(G.group_norm_stats, full),
                "stats_plain": time_us(G.group_norm_stats_plain, full),
                # the nearest single call to B2a's group statistics (means and
                # variances rather than sums), on the (b, h·w, 32, C/32) view
                "stats_library": time_us(lambda v: torch.var_mean(v, dim=(1, 3)),
                                         [(x.view(b, h * w, 32, c // 32),) for x in xs]),
                "apply": time_us(G.group_norm_apply, app),
                "apply_plain": time_us(G.group_norm_apply_plain, app),
                "apply_library": time_us(torch.addcmul, lib_app),
            }
        small = b * c * (2 * 4 + 2 * 2)  # Σx, Σx² f32 + mul, add bf16
        bounds = {
            "gn": bound_us(2 * xb + 2 * c * 4, 5 * numel),
            "stats": bound_us(xb + 2 * c * 4 + small, 3 * numel),
            "apply": bound_us(2 * xb + b * c * 2 * 2, 2 * numel),
        }

        def fmt(key):
            dev, call = t[key]
            return f"{dev:.2f} (call {call:.2f})"

        plan, aplan = gn_plan(xs[0]), gn_apply_plan(xs[0])
        print(f"gn_site shape={shape} bf16, device us (call us): group_norm {fmt('gn')} "
              f"bound {bounds['gn'][0]:.2f} by {bounds['gn'][1]} share "
              f"{bounds['gn'][0] / t['gn'][0]:.2f}, plain {fmt('gn_plain')}, "
              f"F.group_norm {fmt('gn_library')} | stats {fmt('stats')} bound "
              f"{bounds['stats'][0]:.2f} share {bounds['stats'][0] / t['stats'][0]:.2f}, plain "
              f"{fmt('stats_plain')}, torch.var_mean {fmt('stats_library')} | apply "
              f"{fmt('apply')} bound {bounds['apply'][0]:.2f}, plain {fmt('apply_plain')}, "
              f"torch.addcmul {fmt('apply_library')} | stats plan {plan.describe()} "
              f"| apply plan {aplan.describe()} | card={card}", flush=True)
        for name, key, lib in (("group_norm_stats", "stats", "stats_library"),
                               ("group_norm_apply", "apply", "apply_library")):
            site = {"shape": list(shape), "ms": t[key][0] / 1e3,
                    "plain_ms": t[key + "_plain"][0] / 1e3,
                    "bound_ms": bounds[key][0] / 1e3, "bound_by": bounds[key][1],
                    "library_ms": t[lib][0] / 1e3, "call_ms": t[key][1] / 1e3}
            if name == "group_norm_stats":
                site["plan"] = plan.describe()
            else:  # B2b's plan, and the whole group_norm (the pair) at the site
                site.update(plan=aplan.describe(), group_norm_ms=t["gn"][0] / 1e3,
                            group_norm_bound_ms=bounds["gn"][0] / 1e3,
                            group_norm_call_ms=t["gn"][1] / 1e3)
            if shape == GN_SITES[0]:  # the kernel's row: the eval's full-scale site
                per_kernel[name] = {**site, "sites": []}
            per_kernel[name]["sites"].append(site)
        del xs, ma, full, app, lib_app, nchw
    return per_kernel


def phase_profile(eval_apply, img, lbl, ms_per_img: float, out_dir: str,
                  name: str = "eval") -> None:
    """Device time of one two-scale eval by op (torch.profiler); the busy
    share is that device time over the unprofiled ms/img of phase 5 (or 8c)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eval_ms_per_img(eval_apply, img, lbl, 1)
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=60)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    dev_ms = device_time_us(avgs) / 1e3
    print(f"profile: one two-scale {name}, device time {dev_ms:.2f} ms; busy share "
          f"{dev_ms / ms_per_img:.3f} of {ms_per_img:.2f} ms/img; table and trace in {out_dir}",
          flush=True)
    print("\n".join(table.splitlines()[:30]))


# ---------------------------------------------------------------------------
# the distillation kernels and the training path
# ---------------------------------------------------------------------------

def distill_inputs(shape, dtype, seed, scale=3.0, offset=0, device="cuda"):
    """Seeded logits; ``offset`` > 0 places each tensor that many elements
    into a larger buffer (contiguous, base pointer off 16-byte alignment)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device, dtype)
        if offset:
            buf = torch.empty(x.numel() + offset, device=device, dtype=dtype)
            buf[offset:] = x.reshape(-1)
            x = buf[offset:].view(shape)
        out.append(x)
    return tuple(out)


def distill_plans(t: torch.Tensor, s: torch.Tensor) -> tuple:
    """The launch plans of B1a and B1b on these inputs (ds as allocated by
    ``empty_like(s)``: its pointer's alignment stands in for the real one)."""
    ds = torch.empty_like(s)
    n2, h, w, k = t.shape
    args = (n2 // 2 * h * w, k, t.element_size(), native.sm_count(t.device.index))
    return (D.launch_plan(*args, (t.data_ptr(), s.data_ptr())),
            D.launch_plan(*args, (t.data_ptr(), s.data_ptr(), ds.data_ptr()), backward=True))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))) - 7)


def phase_distill_vs_plain() -> dict:
    """Returns, per kernel, the largest |kernel - plain| at the path's shape (bf16)."""
    errs = {"distill_loss": 0.0, "distill_grad": 0.0}
    g = torch.tensor(0.5, device="cuda")  # lambda_distil, the step's incoming gradient
    for i, (shape, dtypes, logit_scale, offset) in enumerate(DISTILL_CHECKS):
        for dtype in dtypes:
            t, s = distill_inputs(shape, dtype, seed=200 + i, scale=logit_scale, offset=offset)
            loss = [D.distillation_loss_kernel(t, s, 0.5) for _ in range(2)]
            ds = [D.distillation_grad_kernel(t, s, g, 0.5) for _ in range(2)]
            ref = D.distillation_loss_plain(t, s, 0.5)
            ref_ds = D.distillation_grad_plain(t, s, g, 0.5)
            tt, st = t.clone().requires_grad_(True), s.clone().requires_grad_(True)
            D.distillation_loss(tt, st, 0.5).backward()
            torch.cuda.synchronize()
            tag = (f"shape={shape} dtype={str(dtype).split('.')[-1]} logits x{logit_scale:g}"
                   + (f" base offset {offset}" if offset else ""))
            require(torch.equal(loss[0], loss[1]) and torch.equal(ds[0], ds[1]),
                    f"distillation kernels differ between two runs at {tag}")
            require(ds[0].dtype == dtype and ds[0].shape == s.shape, f"ds dtype/shape at {tag}")
            require(tt.grad is None and st.grad is not None, f"teacher got a gradient at {tag}")
            e_loss = abs(float(loss[0]) - float(ref))
            require(e_loss <= 1e-5 * abs(float(ref)),
                    f"loss off at {tag}: {float(loss[0])!r} vs {float(ref)!r}")
            diff = (ds[0].float() - ref_ds.float()).abs()
            scale = float(ref_ds.float().abs().max())
            # f32: 1e-5 of the largest gradient; bf16: one bf16 ulp at the
            # largest gradient (where softmax(s) ~ softmax(t) the difference
            # cancels, and a few-ulp f32 difference between expf and torch's
            # exp can move a small element across one rounding boundary)
            tol_v = 1e-5 * scale if dtype == torch.float32 else float(bf16_ulp(torch.tensor(scale)))
            ok = float(diff.max()) <= tol_v
            tol = (f"1e-5*max|ds|={tol_v:.3e}" if dtype == torch.float32
                   else f"one bf16 ulp of max|ds|={tol_v:.3e}")
            require(ok, f"ds off at {tag}: max_abs_err {float(diff.max()):.3e}, tol {tol}")
            plans = distill_plans(t, s)
            require(shape not in DISTILL_SITES or all(p.vec for p in plans),
                    f"the path's shape must take the 16-byte copies at {tag}: {plans}")
            print(f"check distill {tag}: loss {float(loss[0]):.6f} rel_err "
                  f"{e_loss / abs(float(ref)):.2e} | ds max_abs_err {float(diff.max()):.3e} "
                  f"tol {tol} | teacher grad None | bitwise-repeatable | plan loss "
                  f"{plans[0].describe()}; grad {plans[1].describe()}", flush=True)
            if shape in DISTILL_SITES and (dtype, logit_scale) == (torch.bfloat16, 3.0):
                errs = {"distill_loss": max(errs["distill_loss"], e_loss),
                        "distill_grad": max(errs["distill_grad"], float(diff.max()))}
            del t, s, loss, ds, ref, ref_ds, tt, st
    return errs


def depthwise_inputs(shape, dtype, seed, device="cuda"):
    """Seeded map and incoming gradient, NHWC ``shape`` (b, h, w, c) as
    channels_last NCHW, and a (c, 1, 3, 3) weight."""
    b, h, w, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype).permute(0, 3, 1, 2)
    dy = torch.randn((b, h, w, c), generator=gen, device=device).to(dtype).permute(0, 3, 1, 2)
    wt = (torch.randn((c, 1, 3, 3), generator=gen, device=device) / 3).to(dtype)
    return x, wt, dy


def depthwise_plan(shape, d: int, dtype):
    """The kernels' launch plan at a site."""
    return DW.launch_plan(shape, d, torch.empty((), dtype=dtype).element_size(),
                          native.sm_count(0))


def phase_depthwise_vs_plain() -> dict:
    """The head's depthwise kernels against their plain versions at the
    paths' sites and the edges of the walk: the forward and the input
    gradient (the same kernel, weights turned) within 1e-5 of the largest
    output, and in bf16 one ulp more (f32 sums in another order, rounded
    once); the weight gradient within 1e-5 of Σ|dy·x| (and one bf16 ulp);
    three calls bitwise equal.  Returns each kernel's largest |kernel -
    plain| at the training sites in bf16."""
    errs = {"depthwise_fwd": 0.0, "depthwise_wgrad": 0.0}
    sms = native.sm_count(0)
    for i, (shape, d, dtypes) in enumerate(DEPTHWISE_CHECKS):
        for dtype in dtypes:
            bf16 = dtype == torch.bfloat16
            x, wt, dy = depthwise_inputs(shape, dtype, seed=400 + i)
            ys = [DW.depthwise_conv3x3_kernel(x, wt, d) for _ in range(3)]
            dxs = [DW.depthwise_conv3x3_kernel(dy, wt, d, rotate=True) for _ in range(3)]
            dws = [DW.depthwise_wgrad_kernel(x, dy, d) for _ in range(3)]
            torch.cuda.synchronize()
            tag = f"shape={shape} d={d} dtype={str(dtype).split('.')[-1]}"
            require(all(torch.equal(o[0], o[k]) for o in (ys, dxs, dws) for k in (1, 2)),
                    f"depthwise kernels differ between three runs at {tag}")
            found = {}
            for name, got, want in (
                    ("fwd", ys[0], DW.depthwise_conv3x3_plain(x, wt, d)),
                    ("dgrad", dxs[0], DW.depthwise_conv3x3_plain(dy, wt, d, rotate=True))):
                require(got.is_contiguous(memory_format=torch.channels_last)
                        and got.dtype == dtype, f"depthwise {name} layout/dtype at {tag}")
                err = (got.float() - want.float()).abs()
                tol = 1e-5 * want.float().abs().max() + (bf16_ulp(want) if bf16 else 0.0)
                require(bool((err <= tol).all()),
                        f"depthwise {name} off at {tag}: max_abs_err {float(err.max()):.3e}")
                found[name] = float(err.max())
            want = DW.depthwise_wgrad_plain(x, dy, d, sms).float()
            scale = DW.depthwise_wgrad_plain(x.abs(), dy.abs(), d, sms).float()
            err = (dws[0].float() - want).abs()
            tol = 1e-5 * scale + (bf16_ulp(want) if bf16 else 0.0)
            require(dws[0].shape == wt.shape and dws[0].dtype == dtype and bool((err <= tol).all()),
                    f"depthwise wgrad off at {tag}: max_abs_err {float(err.max()):.3e}")
            found["wgrad"] = float(err.max())
            print(f"check depthwise {tag}: fwd max_abs_err {found['fwd']:.3e} | dgrad "
                  f"{found['dgrad']:.3e} | wgrad {found['wgrad']:.3e} (max|dw| "
                  f"{float(want.abs().max()):.3e}) | bitwise-repeatable x3 | plan "
                  f"{depthwise_plan(shape, d, dtype).describe()}", flush=True)
            if shape in DEPTHWISE_TRAIN_SHAPES and bf16:
                errs = {"depthwise_fwd": max(errs["depthwise_fwd"], found["fwd"], found["dgrad"]),
                        "depthwise_wgrad": max(errs["depthwise_wgrad"], found["wgrad"])}
            del x, wt, dy, ys, dxs, dws, want, scale, err
    return errs


def tiny_model(hrnet: bool) -> torch.nn.Module:
    return (HRNetOCR(19, TINY_HRNET, droprate=0.0) if hrnet
            else DeepLabV2(19, (1, 1, 1, 1), droprate=0.0))


def tiny_train(stage: str, device: str, model_sd: dict, translator_sd: dict,
               centroids: Centroids, hrnet: bool = False):
    """A tiny f32 train state of ``stage`` on ``device`` and its step; with
    ``hrnet`` the semiseg recipe (no translator, the DG step as the warm-up,
    the 0.1x aux term, the RGB flip)."""
    student = tiny_model(hrnet)
    student.load_state_dict(model_sd, strict=True)
    translator = None
    if stage != "dg" and not hrnet:
        enc, dec = ImgEncoder(dim=16, n_res=1), ImgDecoder(dim=64, n_res=1)
        enc.load_state_dict(translator_sd["enc_s"], strict=True)
        dec.load_state_dict(translator_sd["dec_s2t"], strict=True)
        translator = torch.nn.ModuleDict({"enc_s": enc, "dec_s2t": dec}).to(device)
    student.to(device)
    opt = sgd_grouped(student, 2.5e-4)
    state = create_seg_state(student, opt, SEED, translator,
                             centroids if stage == "selftrain" else None)
    semiseg = dict(aux_weight=0.1, rgb_input=True, use_crdomix=False) if hrnet else {}
    cfg = StepConfig(crop_hw=(64, 128), beta=0.4, tgt_stats_forward=stage != "selftrain",
                     with_sharpness=stage != "dg", compute_dtype=torch.float32, **semiseg)
    build = {"warmup": build_dg_step if hrnet else build_warmup_step, "dg": build_dg_step,
             "selftrain": build_selftrain_step}[stage]
    return state, build(cfg, poly_schedule(2.5e-4, 100))


def phase_steps_gpu_vs_cpu(stage: str, hrnet: bool = False) -> None:
    """3 tiny steps of ``stage`` on the card against the CPU, same inputs and
    draws: losses at 1e-4 relative, ``consensus_kept`` within 1e-3,
    parameters within 1e-5, BN running statistics within 1e-4 + 1e-3 x
    |value|, centroid vectors within 1e-5 + 1e-4 x |value| and counts equal.
    ``hrnet``: the tiny HRNet+OCR in the semiseg recipe (``tiny_train``)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(SEED + 3)
        model_sd = tiny_model(hrnet).state_dict()
        translator_sd = {"enc_s": ImgEncoder(dim=16, n_res=1).state_dict(),
                         "dec_s2t": ImgDecoder(dim=64, n_res=1).state_dict()}
        rng = np.random.default_rng(SEED + 4)
        feat_dim = TINY_HRNET["ocr_mid_channels"] if hrnet else 256
        centroids = Centroids(
            torch.from_numpy(rng.normal(size=(19, feat_dim)).astype(np.float32) * 0.1),
            torch.full((19,), 150.0))
        card, host = DEVICE.type, "cpu"
        runs = {dev: tiny_train(stage, dev, model_sd, translator_sd, centroids, hrnet)
                for dev in (host, card)}
        gen = torch.Generator().manual_seed(SEED + 5)
        losses = {dev: [] for dev in runs}
        for _ in range(TRAIN_STEPS):
            lbl = rng.integers(0, 19, size=(2, 64, 128)).astype(np.int32)
            lbl[:, :, :8] = 255
            batch = {"s_img": (rng.normal(size=(2, 64, 128, 3)) * 0.5).astype(np.float32),
                     "s_lbl": lbl,
                     "t_img": (rng.normal(size=(2, 64, 128, 3)) * 0.5).astype(np.float32)}
            draws = {"photometric_draws": P.draw(gen, 2)}
            if stage != "dg" and not hrnet:
                draws["selection"] = mixing.sample_half_classes(torch.from_numpy(lbl), gen, 19)
            if stage == "selftrain":
                pseudo = rng.choice(rng.choice(19, size=3, replace=False), size=(2, 64, 128))
                pseudo[:, :, 40:48] = 255
                batch["t_pseudo"] = pseudo.astype(np.int32)
                draws["target_photometric_draws"] = P.draw(gen, 2)
                draws["dacs_selection"] = mixing.sample_half_classes(torch.from_numpy(lbl), gen, 19)
            for dev, (state, step) in runs.items():
                kw = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                          else v.to(dev)) for k, v in draws.items()}
                m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, **kw)
                losses[dev].append({k: float(v) for k, v in m.items()})
        for a, b in zip(losses[card], losses[host]):
            for k in a:
                tol = 1e-3 if k == "consensus_kept" else 1e-4 * abs(b[k])
                require(math.isfinite(a[k]) and abs(a[k] - b[k]) <= tol,
                        f"tiny {stage} {k} on the card {a[k]!r} vs the CPU {b[k]!r}")
        sd = {dev: {k: v.detach().cpu() for k, v in state.student.state_dict().items()}
              for dev, (state, _) in runs.items()}
        # parameters within 1e-5 (updates are lr x grad); running statistics
        # within 1e-4 + 1e-3 x |value|: cuDNN may time Winograd or FFT
        # algorithms for the f32 convs, about 1e-5 relative error each
        e_param = e_stat = 0.0
        for k, v in sd[host].items():
            if k.endswith("num_batches_tracked"):
                continue
            d = (sd[card][k] - v).abs()
            if "running" in k:
                e_stat = max(e_stat, float((d / (1e-4 + 1e-3 * v.abs())).max()))
            else:
                e_param = max(e_param, float(d.max()))
        require(e_param <= 1e-5 and e_stat <= 1.0,
                f"tiny {stage} state on the card vs the CPU: params {e_param:.3e} (tol 1e-5), "
                f"running stats {e_stat:.3e} of their tolerance 1e-4 + 1e-3 x |value|")
        extra = ""
        if stage == "selftrain":
            c_card, c_host = runs[card][0].centroids, runs[host][0].centroids
            e_cent = float(((c_card.vectors.cpu() - c_host.vectors).abs()
                            / (1e-5 + 1e-4 * c_host.vectors.abs())).max())
            require(torch.equal(c_card.counts.cpu(), c_host.counts) and e_cent <= 1.0,
                    f"tiny self-training centroids on the card vs the CPU: counts "
                    f"{c_card.counts.tolist()} vs {c_host.counts.tolist()}, vectors at "
                    f"{e_cent:.3f} of their tolerance 1e-5 + 1e-4 x |value|")
            require(all(0.0 <= x["consensus_kept"] <= 1.0 for x in losses[card]),
                    f"consensus_kept out of [0, 1]: {losses[card]}")
            extra = (f", consensus_kept {[round(x['consensus_kept'], 6) for x in losses[card]]}"
                     f" vs {[round(x['consensus_kept'], 6) for x in losses[host]]} (tol 1e-3), "
                     f"centroid counts equal ({float(c_host.counts.sum()):.0f} in all), vectors "
                     f"at {e_cent:.3f} of their tolerance")
        what = "tiny HRNet+OCR semiseg" if hrnet else "layers=(1,1,1,1)"
        print(f"{stage} gpu-vs-cpu {what} crop 64x128 f32 tf32=off {TRAIN_STEPS} "
              f"steps: losses {[round(x['loss'], 6) for x in losses[card]]} vs "
              f"{[round(x['loss'], 6) for x in losses[host]]} (tol 1e-4 rel), params "
              f"max_abs_err {e_param:.3e} (tol 1e-5), running stats at {e_stat:.3f} of their "
              f"tolerance (1e-4 + 1e-3 x |value|){extra}", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def phase_train_main_path(work: str) -> tuple[dict, dict]:
    """train_warm_up at full width; returns (launch counts, the fixtures' data paths)."""
    t0 = time.perf_counter()
    gta_root, city_root = os.path.join(work, "gta"), os.path.join(work, "city_train")
    gta_list = synthetic.make_gta5_fixture(gta_root, n=3, h=1052, w=1914)
    img_list, lbl_list = synthetic.make_cityscapes_fixture(city_root, n=3, h=1024, w=2048,
                                                           split="train")
    wd = os.path.join(work, "warmup")
    print(f"train path setup (GTA5 + Cityscapes fixtures): {time.perf_counter() - t0:.1f} s",
          flush=True)
    argv = ["--preset", PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS),
            "--source_root", gta_root, "--source_list", gta_list,
            "--target_root", city_root, "--target_img_list", img_list,
            "--target_lbl_list", lbl_list]
    result, counts = run_path("train_warm_up", train_warm_up.main, argv,
                              kernel_counts(TRAIN_STEPS, 6 * TRAIN_STEPS),
                              (torch.bfloat16, DISTILL_SHAPE))
    check_train_run("train_warm_up", wd, result, ("loss", "loss_semseg", "loss_distil"))
    return counts, {"source_root": gta_root, "source_list": gta_list, "target_root": city_root,
                    "target_img_list": img_list, "target_lbl_list": lbl_list}


def step_ms(state, step, batch, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profile_step(stage: str, state, step, batch, ms: float, profile_dir: str) -> dict:
    """Device time of one step by op (torch.profiler) and its busy share of
    the unprofiled ``ms``/step; table and trace into ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step_ms(state, step, batch, 1)
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=60)
    by_shape = prof.key_averages(group_by_input_shape=True).table(
        sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(profile_dir, f"{stage}_step_profile.txt"), "w") as f:
        f.write(table + "\n" + by_shape)
    prof.export_chrome_trace(os.path.join(profile_dir, f"{stage}_step_trace.json"))
    dev_ms = device_time_us(avgs) / 1e3
    print(f"profile: one {stage} step, device time {dev_ms:.2f} ms; busy share "
          f"{dev_ms / ms:.3f} of {ms:.2f} ms/step; table and trace in {profile_dir}", flush=True)
    print("\n".join(table.splitlines()[:40]))
    print("\n".join(by_shape.splitlines()[:16]))
    return {"device_ms_per_step": dev_ms, "busy_share": dev_ms / ms}


def phase_train_timing(preset: str, data_paths: dict, card: str, profile_dir: str | None,
                       **build_kw) -> dict:
    """ms/step of ``preset``'s step on one batch on the card, in turns with
    the distillation kernels and with the plain PyTorch distillation under
    autograd (``ops/losses.py``); source imgs/s, peak memory, optional
    profile.  ``build_kw`` goes to ``build_experiment`` (weights, centroids)."""
    base = get_preset(preset)
    cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, **data_paths))
    state, step, _ = build_experiment(cfg, DEVICE, **build_kw)
    it, loaders = make_train_iterator(cfg, with_target=wants_target(cfg))
    try:
        batch = to_device(next(it), DEVICE)
    finally:
        for ld in loaders:
            ld.stop()
    batch.pop("t_lbl", None)
    n_src = batch["s_img"].shape[0]
    first = {k: float(v) for k, v in step(state, batch).items()}  # from the built state
    step_ms(state, step, batch, 2)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    kernel_fn = D.distillation_loss
    for variant in ("kernel", "plain", "plain", "kernel"):
        D.distillation_loss = kernel_fn if variant == "kernel" else plain_distillation_loss
        try:
            times[variant].append(step_ms(state, step, batch, 5))
        finally:
            D.distillation_loss = kernel_fn
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    k, p = (float(np.mean(times[v])) for v in ("kernel", "plain"))
    metric = f"{preset}_train_imgs_per_sec_per_chip"
    out = {"ms_per_step": k, "ms_per_step_plain_distill": p, "peak_mem_GiB": peak_gb,
           metric: n_src / (k / 1e3), "first_step": first}
    n_tgt = batch["t_img"].shape[0] if "t_img" in batch else 0
    hrnet = cfg.extra.get("model") == "hrnet_ocr"
    print(f"train {cfg.stage} step {'HRNet-W48+OCR' if hrnet else 'R101'} bf16 source {n_src} + "
          f"target {n_tgt} imgs crop "
          f"{tuple(batch['s_img'].shape[1:3])}: ms/step distill=kernel {k:.2f} "
          f"{times['kernel']} distill=plain {p:.2f} {times['plain']} source imgs/s "
          f"{out[metric]:.2f} peak_mem_GiB={peak_gb:.2f} | card={card}", flush=True)
    if profile_dir:
        out.update(profile_step(f"semiseg_{cfg.stage}" if hrnet else cfg.stage, state, step,
                                batch, k, profile_dir))
    print(json.dumps({"metric": metric, "value": out[metric], "unit": "imgs/sec",
                      "ms_per_step": k, "peak_mem_GiB": peak_gb, "card": card}), flush=True)
    return out


def run_path(name: str, fn, argv: list, want: dict | None, distill_site: tuple | None = None,
             gn_sites: set | None = None):
    """Drive one CLI inside ``device_launches``: a train path replays its
    model calls as CUDA graphs, whose kernels launch without their wrappers,
    so the wrappers' tallies (``launches``) count a graphed call once, at
    its capture, and the card's records count every run.  Require the
    card's launches of the port's kernels to be ``want`` (None: a CLI that
    runs a profiler of its own, counted by its caller), on a train path every B1a call at
    ``distill_site`` = (dtype, shape), and with ``gn_sites`` the GroupNorm
    calls at exactly those NHWC shapes (the calls that reach the wrappers:
    eager calls and captures)."""
    sites, gn_seen = [], []
    kernel, gn_kernel = D.distillation_loss_kernel, resnet_deeplab.group_norm

    def recorded(t, s, scale):
        sites.append((t.dtype, tuple(t.shape)))
        return kernel(t, s, scale)

    def gn_recorded(x, *args, **kw):
        gn_seen.append(tuple(x.shape))
        return gn_kernel(x, *args, **kw)

    D.distillation_loss_kernel = recorded
    resnet_deeplab.group_norm = gn_recorded
    try:
        t0 = time.perf_counter()
        with (span_recorder.device_launches() if want is not None
              else contextlib.nullcontext({})) as counts:
            result = fn([*argv, "--device", DEVICE.type])
            torch.cuda.synchronize()
    finally:
        D.distillation_loss_kernel = kernel
        resnet_deeplab.group_norm = gn_kernel
    print(f"main path: {name} in {time.perf_counter() - t0:.1f} s (set-up and data loading "
          f"included)" + (f"; launches={counts}" if want is not None else "")
          + (f"; B1a at {sorted(set(sites))}" if sites else "")
          + (f"; B2 at {sorted(set(gn_seen))}" if gn_sites is not None else ""), flush=True)
    require(want is None or counts == want,
            f"kernel launches on the {name} path {counts}, expected {want}")
    require(distill_site is None or set(sites) == {distill_site},
            f"B1a on the {name} path at {sorted(set(sites))}, expected {distill_site}")
    require(gn_sites is None or set(gn_seen) == gn_sites,
            f"B2 on the {name} path at {sorted(set(gn_seen))}, expected {sorted(gn_sites or ())}")
    return result, counts


def world1_train_timing(preset: str, data_paths: dict, card: str) -> dict:
    """``preset``'s step built and timed as in ``phase_train_timing`` but in a
    world of one rank (NCCL, in this process): the synced BN and the flat
    gradient all-reduce on every step.  The first step's metrics from the
    built state, ms/step over 2 x 5 steps, peak memory."""
    def run() -> dict:
        base = get_preset(preset)
        cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, **data_paths))
        device = dist.local_device(DEVICE.type)
        state, step, _ = build_experiment(cfg, device)
        n_sync = sum(isinstance(m, SyncBatchNorm2d) for m in state.student.modules())
        it, loaders = make_train_iterator(cfg, with_target=wants_target(cfg))
        try:
            batch = to_device(next(it), device)
        finally:
            for ld in loaders:
                ld.stop()
        batch.pop("t_lbl", None)
        first = {k: float(v) for k, v in step(state, batch).items()}
        step_ms(state, step, batch, 2)
        torch.cuda.reset_peak_memory_stats()
        times = [step_ms(state, step, batch, 5) for _ in range(2)]
        return {"backend": dist.backend(), "world": dist.world(), "sync_bns": n_sync,
                "first_step": first, "times": times,
                "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30}

    return dist.launch(run, 1, DEVICE.type)


def phase_parallel(work: str, data_paths: dict, card: str, plain: dict) -> dict:
    """8e: data-parallel training over processes.  ``train_warm_up --n_devices
    1`` (an NCCL world of one rank: the synced BN and the gradient
    all-reduce) against the no-flag run; the world-1 step timed against
    ``plain`` (phase 6's no-flag timing); ``dryrun_multichip`` over every
    card; with 2 cards or more, the 2-rank tiny warm-up against the 1-rank
    one on the same global batch."""
    counts = {}
    wd = os.path.join(work, "warmup_n_devices")
    argv = ["--preset", PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS),
            *data_args(data_paths), "--n_devices", "1"]
    seen = {}
    close = dist.close_group

    def recorded_close():
        seen.update(backend=dist.backend(), world=dist.world())
        close()

    dist.close_group = recorded_close
    try:
        result, counts["n_devices train_warm_up"] = run_path(
            "n_devices train_warm_up", train_warm_up.main, argv,
            kernel_counts(TRAIN_STEPS, 6 * TRAIN_STEPS), (torch.bfloat16, DISTILL_SHAPE))
    finally:
        dist.close_group = close
    print(f"train_warm_up --n_devices 1: backend {seen.get('backend')}, world "
          f"{seen.get('world')}", flush=True)
    require(seen == {"backend": dist.backend_for(DEVICE.type), "world": 1},
            f"the --n_devices 1 world was {seen}")
    require(not dist.active(), "a process group outlived the CLI")
    check_train_run("n_devices train_warm_up", wd, result, ("loss", "loss_semseg", "loss_distil"))
    recs = {}
    for name, d in (("plain", os.path.join(work, "warmup")), ("world1", wd)):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs[name] = json.loads(f.readline())
    for k in ("loss", "loss_semseg", "loss_distil"):
        a, b = recs["world1"][k], recs["plain"][k]
        print(f"step 0 {k}: --n_devices 1 {a:.6f}, no flag {b:.6f}, rel {abs(a - b) / abs(b):.2e}",
              flush=True)
        require(abs(a - b) <= PARALLEL_LOSS_RTOL * abs(b),
                f"step 0 {k}: --n_devices 1 {a} against the no-flag run's {b}")

    w1 = world1_train_timing(PRESET, data_paths, card)
    require(w1["backend"] == dist.backend_for(DEVICE.type) and w1["world"] == 1
            and w1["sync_bns"] > 0, f"world: {w1}")
    ms = float(np.mean(w1["times"]))
    for k, b in plain["first_step"].items():
        a = w1["first_step"][k]
        require(abs(a - b) <= PARALLEL_LOSS_RTOL * abs(b),
                f"first timed step {k}: world of one {a} against no group {b}")
    print(f"train warmup step R101 bf16, a world of one rank ({w1['backend']}, {w1['sync_bns']} synced "
          f"BNs, the gradient all-reduce): ms/step {ms:.2f} {w1['times']} against "
          f"{plain['ms_per_step']:.2f} with no group (phase 6, same call); first step "
          f"{w1['first_step']} against {plain['first_step']}; peak_mem_GiB="
          f"{w1['peak_mem_GiB']:.2f} | card={card}", flush=True)
    print(json.dumps({"metric": "gta2city_warmup_world1_ms_per_step", "value": ms,
                      "no_group_ms_per_step": plain["ms_per_step"], "card": card}), flush=True)

    n = torch.cuda.device_count() if DEVICE.type == "cuda" else 1
    reset_launches()
    t0 = time.perf_counter()
    out = dryrun_multichip(n, DEVICE.type)
    c = launches()
    require(set(out) and all(math.isfinite(v) for v in out.values()), f"dryrun: {out}")
    print(f"dryrun_multichip({n}) in {time.perf_counter() - t0:.1f} s: {out}; "
          f"launches={c}", flush=True)
    if n == 1:  # one rank, in this process: its launches are counted here
        counts["dryrun_multichip"] = c
    else:
        print(f"dryrun_multichip({n}): its ranks are processes of their own; their launches "
              "are not counted here", flush=True)
    if n >= 2:
        two, one = warmup_world(2), warmup_world(1)
        print(f"tiny warm-up, 2 ranks against 1 on the same global batch: losses "
              f"{two['losses']} against {one['losses']}", flush=True)
        for a, b in zip(two["losses"] + two["param_sums"], one["losses"] + one["param_sums"]):
            require(abs(a - b) <= PARALLEL_WORLD_RTOL * max(abs(b), 1.0),
                    f"2 ranks {a} against 1 rank {b}")
    else:
        print("one card: the 2-rank run against the 1-rank run on the global batch needs 2 "
              "cards and was not run (the CPU tests hold it over gloo)", flush=True)
    return counts


def spatial_update(eval_apply, img: np.ndarray, lbl: np.ndarray, shard) -> tuple:
    """One image through the height-sharded evaluator on ``shard`` (every
    shard is given the whole image): (its confusion, its prediction rows)."""
    ev = TwoScaleEvaluator(eval_apply, 19, OUT_HW, DS_HW, DEVICE, shard="spatial",
                           spatial=shard)
    pred = ev.update(img, lbl)
    return ev.score.confusion, pred


def spatial_logits(eval_apply, img: np.ndarray, shard) -> torch.Tensor:
    with torch.inference_mode(), shard.active():
        x = shard.slice_rows(torch.from_numpy(img)).to(DEVICE)
        return two_scale_logits(eval_apply, x, OUT_HW, DS_HW)


def spatial_ms_per_img(eval_apply, img: np.ndarray, lbl: np.ndarray, shards, iters: int) -> float:
    """ms/img of the evaluator on one host image: height-sharded over the
    ``shards`` (a ``LocalShards``), over the process group's ranks
    (``"group"``), or unsharded (None); host clock to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        if shards == "group":
            spatial_update(eval_apply, img, lbl, spatial.group_shard())
        elif shards is None:
            TwoScaleEvaluator(eval_apply, 19, OUT_HW, DS_HW, DEVICE).update(img, lbl)
        else:
            shards.run(lambda s: spatial_update(eval_apply, img, lbl, s))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def margin_ulps(logits: torch.Tensor) -> torch.Tensor:
    """Each pixel's top-two logit margin in bf16 ulps of its top logit."""
    top2 = logits.float().topk(2, dim=-1).values
    _, e = torch.frexp(top2[..., 0])  # |top| = m·2^e, m in [0.5, 1): its bf16 ulp is 2^(e-8)
    return (top2[..., 0] - top2[..., 1]) * torch.exp2(8.0 - e.float())


def decided_disagreement(pred: torch.Tensor, ref_pred: torch.Tensor, margins: torch.Tensor,
                         dtype: torch.dtype) -> tuple[float, float, str]:
    """(the gated disagreement, the share of pixels it is over, a line of
    the disagreement by margin): over every pixel in f32, over the pixels
    whose unsharded margin exceeds ``SPATIAL_MARGIN_ULPS`` in bf16."""
    diff = pred != ref_pred
    by_margin = []
    for u in (0, 1, 2, 4, 8):
        over = margins > u
        by_margin.append(f">{u}: {float((diff & over).sum()) / max(int(over.sum()), 1):.3e} "
                         f"of {float(over.float().mean()):.4f}")
    line = "disagreement by unsharded margin in bf16 ulps (of the share): " + ", ".join(by_margin)
    if dtype == torch.float32:
        return float(diff.float().mean()), 1.0, line
    decided = margins > SPATIAL_MARGIN_ULPS
    return (float((diff & decided).sum()) / max(int(decided.sum()), 1),
            float(decided.float().mean()), line)


def require_decided(name: str, rate: float, share: float) -> None:
    require(rate <= SPATIAL_GATE, f"{name}: pixel disagreement {rate} > {SPATIAL_GATE}")
    require(share >= SPATIAL_DECIDED_MIN,
            f"{name}: the gate's pixels are {share} of the image, under {SPATIAL_DECIDED_MIN}")


@contextlib.contextmanager
def recorded_gn_shapes():
    """The NHWC shapes at which the sharded GroupNorm calls B2a and B2b."""
    seen = {"stats": [], "apply": []}
    stats, apply = spatial_ops.group_norm_stats, spatial_ops.group_norm_apply

    def rec_stats(x, *args):
        seen["stats"].append(tuple(x.shape))
        return stats(x, *args)

    def rec_apply(x, *args):
        seen["apply"].append(tuple(x.shape))
        return apply(x, *args)

    spatial_ops.group_norm_stats, spatial_ops.group_norm_apply = rec_stats, rec_apply
    try:
        yield seen
    finally:
        spatial_ops.group_norm_stats, spatial_ops.group_norm_apply = stats, apply


def spatial_against(name: str, eval_apply, img: np.ndarray, lbl: np.ndarray,
                    shards: spatial.LocalShards, ref: dict, gn: int) -> dict:
    """The height-sharded eval of one image over the local ``shards`` against
    the unsharded ``ref``: the launch counts (B2 ``gn`` each) with B2a and
    B2b at exactly the shards' rows of the eval's sites
    (``gn_slab_sites``), every shard's confusion equal, the scored pixels
    equal; the pixel disagreement within ``SPATIAL_GATE`` (``decided_
    disagreement``), printed beside the share of pixels whose unsharded top
    two logits tie exactly and by margin; the logits' largest difference
    and the mIoU difference printed."""
    reset_launches()
    t0 = time.perf_counter()
    with recorded_gn_shapes() as seen:
        out = shards.run(lambda s: spatial_update(eval_apply, img, lbl, s))
        torch.cuda.synchronize()
    counts = launches()
    secs = time.perf_counter() - t0
    require(counts == kernel_counts(0, gn), f"{name}: launches {counts}, expected B2 {gn}")
    want_sites = gn_slab_sites(shards.n) if gn else set()
    for kernel, shapes in seen.items():
        require(set(shapes) == want_sites, f"{name}: B2 {kernel} at {sorted(set(shapes))}, "
                                           f"expected {sorted(want_sites)}")
    require(all(torch.equal(o[0], out[0][0]) for o in out), f"{name}: shards' confusions differ")
    pred = torch.cat([o[1] for o in out], 1)
    require(pred.shape == ref["pred"].shape, f"{name}: prediction {tuple(pred.shape)}")
    disagree = float((pred != ref["pred"]).float().mean())
    logits = torch.cat(shards.run(lambda s: spatial_logits(eval_apply, img, s)), 1)
    require(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
    d_logit = float((logits.float() - ref["logits"].float()).abs().max())
    rate, share, by_margin = decided_disagreement(pred, ref["pred"], ref["margins"],
                                                  ref["logits"].dtype)
    miou = confusion_miou(out[0][0])
    print(f"{name}: {secs:.1f} s (the first run on these shards includes cuDNN tuning "
          f"their slab shapes); launches={counts}; B2 at {sorted(want_sites)}; "
          f"pixel disagreement with the unsharded eval {disagree:.3e} over every pixel, "
          f"{rate:.3e} over the gate's {share:.4f} of them (gate {SPATIAL_GATE}); the unsharded "
          f"top two logits tie exactly on {ref['ties']:.3e}; {by_margin}; max|logit diff| "
          f"{d_logit:.3e} of max|logit| {float(ref['logits'].float().abs().max()):.3e}; mIoU "
          f"{miou:.6f} against {ref['miou']:.6f} (diff {miou - ref['miou']:+.3e}); scored pixels "
          f"{int(out[0][0].sum())} of {int(ref['conf'].sum())}", flush=True)
    require(int(out[0][0].sum()) == int(ref["conf"].sum()), f"{name}: scored pixels differ")
    require_decided(name, rate, share)
    return counts


def confusion_miou(conf: torch.Tensor) -> float:
    from diga_tpu_torch.ops.metrics import scores_from_confusion

    return float(scores_from_confusion(conf.cpu().numpy())[0]["mean_iou"])


def unsharded_reference(eval_apply, img: np.ndarray, lbl: np.ndarray) -> dict:
    ev = TwoScaleEvaluator(eval_apply, 19, OUT_HW, DS_HW, DEVICE)
    pred = ev.update(img, lbl)
    with torch.inference_mode():
        logits = two_scale_logits(eval_apply, torch.from_numpy(img).to(DEVICE), OUT_HW, DS_HW)
    margins = margin_ulps(logits)
    return {"pred": pred, "logits": logits, "conf": ev.score.confusion,
            "miou": confusion_miou(ev.score.confusion), "margins": margins,
            "ties": float((margins == 0).float().mean())}


@contextlib.contextmanager
def f32_untuned():
    """f32 convs and matmuls without TF32 (as phase 4), from cuDNN's
    heuristics: tuning every slab shape in f32 on every shard's thread (the
    tuned plans are kept per thread) costs about 30 s a shard count."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = prev


def spatial_model_checks(label: str, preset: str, wdir: str, img: np.ndarray, lbl: np.ndarray,
                         pools: dict, bf16_shards: tuple, gn_sites: int) -> tuple[dict, tuple]:
    """``preset``'s eval model from ``wdir`` against its unsharded eval over
    local shards (``pools``: {n: LocalShards}): in f32 without TF32 over
    every pool (the disagreement gated over every pixel), then in bf16, the
    path's dtype, over ``bf16_shards`` (gated over the decided pixels).
    Returns the launch counts by run and the bf16 (eval_apply, model),
    converted (None where ``bf16_shards`` is empty)."""
    counts = {}
    cfg = get_preset(preset)
    with f32_untuned():
        apply32, model32 = build_eval(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32")), wdir, DEVICE)
        torch.backends.cudnn.benchmark = False  # build_eval turns it on
        ref = unsharded_reference(apply32, img, lbl)
        convert_spatial(model32)
        for n, shards in pools.items():
            name = f"spatial eval {label} f32 n={n}"
            counts[name] = spatial_against(f"{name} (no TF32)", apply32, img, lbl, shards, ref,
                                           gn_sites * n)
    del apply32, model32, ref
    gc.collect()
    torch.cuda.empty_cache()
    if not bf16_shards:
        return counts, None
    eval_apply, model = build_eval(cfg, wdir, DEVICE)
    ref = unsharded_reference(eval_apply, img, lbl)
    convert_spatial(model)
    for n in bf16_shards:
        name = f"spatial eval {label} bf16 n={n}"
        counts[name] = spatial_against(name, eval_apply, img, lbl, pools[n], ref, gn_sites * n)
    return counts, (eval_apply, model)


def phase_spatial(work: str, paths: dict, card: str) -> dict:
    """8f: the height-sharded two-scale eval (``--shard spatial``) at full
    width.  R101 from phase 5's student.pth on its first val image over
    ``SPATIAL_SHARDS`` local shards (one thread each on this card: NCCL puts
    no two ranks on one card) and HRNet-W48+OCR over
    ``SPATIAL_HRNET_SHARDS``, each against the unsharded eval of the same
    call (``spatial_model_checks``); the ms/img of the halo path at n = 1
    (an NCCL world of one), 2 and 4 against unsharded, bf16 (one card runs
    the shards one after another: the halo path's overhead, not a latency
    gain); then ``evaluate_val --n_devices 1 --shard spatial`` against this
    phase's unsharded bf16 eval of its images."""
    with contextlib.ExitStack() as stack:
        # threads that outlive a run keep the cuDNN plans tuned for their shapes
        pools = {n: stack.enter_context(spatial.LocalShards(n, DEVICE)) for n in SPATIAL_SHARDS}
        return spatial_phase_body(work, paths, card, pools)


def spatial_phase_body(work: str, paths: dict, card: str, pools: dict) -> dict:
    ds = cityscapes_dataset(paths["root"], paths["val_img"], paths["val_lbl"], resize_hw=OUT_HW)
    sample = ds[0]
    img, lbl = sample["image"][None], sample["label"][None].astype(np.int32)
    counts, (eval_apply, model) = spatial_model_checks(
        "R101", PRESET, paths["wdir"], img, lbl, pools, SPATIAL_SHARDS, 2 * 6)

    times = {"unsharded": [], "group n=1": [], **{f"local n={n}": [] for n in SPATIAL_TIMED_SHARDS}}

    def group_times() -> list:
        spatial_ms_per_img(eval_apply, img, lbl, "group", 1)  # the world's first call, cuDNN
        return [spatial_ms_per_img(eval_apply, img, lbl, "group", 3) for _ in range(2)]

    spatial_ms_per_img(eval_apply, img, lbl, None, 1)
    for _ in range(2):  # in turns; every shape was tuned by the runs above
        times["unsharded"].append(spatial_ms_per_img(eval_apply, img, lbl, None, 3))
        for n in SPATIAL_TIMED_SHARDS:
            times[f"local n={n}"].append(spatial_ms_per_img(eval_apply, img, lbl, pools[n], 3))
    times["group n=1"] = dist.launch(group_times, 1, DEVICE.type)
    mean = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"spatial eval R101 bf16 {OUT_HW[0]}x{OUT_HW[1]}+{DS_HW[0]}x{DS_HW[1]} ms/img: "
          + ", ".join(f"{k} {mean[k]:.2f} {times[k]}" for k in times)
          + f" (one card runs the shards in turn: the halo path's overhead) | card={card}",
          flush=True)
    print(json.dumps({"metric": "cityscapes_spatial_eval_ms_per_img", "value": mean,
                      "card": card}), flush=True)
    # the CLI's images, unsharded in bf16: its dumps are held against these below
    cli_refs = {}
    for i in range(N_IMAGES):
        with torch.inference_mode():
            lg = two_scale_logits(eval_apply, torch.from_numpy(ds[i]["image"][None]).to(DEVICE),
                                  OUT_HW, DS_HW)
        base = os.path.splitext(os.path.basename(ds[i]["name"]))[0]
        cli_refs[base + ".png"] = (lg.argmax(-1)[0].cpu(), margin_ulps(lg)[0].cpu())
        del lg
    del eval_apply, model
    gc.collect()
    torch.cuda.empty_cache()

    # HRNet-W48+OCR (no GroupNorm: no kernel on this path), gated in f32
    hdir = os.path.join(work, "spatial_hrnet")
    export_role_keyed(hdir, {"student": seeded_state_dict(HRNetOCR(19), SEED + 10)})
    hcounts, _ = spatial_model_checks("HRNet-W48+OCR", SEMISEG_SELFTRAIN_PRESET, hdir, img, lbl,
                                      {SPATIAL_HRNET_SHARDS: pools[SPATIAL_HRNET_SHARDS]}, (), 0)
    counts.update(hcounts)  # SPATIAL_HRNET_PATH
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI in a world of one NCCL rank: the group transport
    dump = os.path.join(work, "preds_spatial")
    seen = {}

    class Recorded(TwoScaleEvaluator):
        def update(self, image, label):
            pred = super().update(image, label)
            seen.update(backend=dist.backend(), world=dist.world(),
                        pixels=int(self.score.confusion.sum()))
            return pred

    evaluate_val.TwoScaleEvaluator = Recorded
    try:
        with recorded_gn_shapes() as gn_seen:
            results, counts["spatial evaluate_val n_devices=1"] = run_path(
                "evaluate_val --n_devices 1 --shard spatial", evaluate_val.main,
                ["--preset", PRESET, "--weight_dir", paths["wdir"], "--eval_limit",
                 str(N_IMAGES), "--target_root", paths["root"], "--val_img_list",
                 paths["val_img"], "--val_lbl_list", paths["val_lbl"], "--dump_preds", dump,
                 "--n_devices", "1", "--shard", "spatial"], kernel_counts(0, N_IMAGES * 2 * 6))
    finally:
        evaluate_val.TwoScaleEvaluator = TwoScaleEvaluator
    for kernel, shapes in gn_seen.items():
        require(set(shapes) == gn_slab_sites(1),
                f"spatial CLI: B2 {kernel} at {sorted(set(shapes))}, expected {GN_SITES}")
    want_pixels = sum(int(((ds[i]["label"] >= 0) & (ds[i]["label"] < 19)).sum())
                      for i in range(N_IMAGES))
    names = sorted(os.listdir(paths["dump"]))
    require(sorted(os.listdir(dump)) == names == sorted(cli_refs),
            f"spatial dumps {os.listdir(dump)} vs {names} and {sorted(cli_refs)}")
    preds = torch.stack([torch.from_numpy(np.array(Image.open(os.path.join(dump, f)))).long()
                         for f in names])
    rate, share, by_margin = decided_disagreement(
        preds, torch.stack([cli_refs[f][0] for f in names]),
        torch.stack([cli_refs[f][1] for f in names]), torch.bfloat16)
    miou, miou_ref = results["cityscapes"]["mean_iou"], paths["scores"]["mean_iou"]
    print(f"evaluate_val --n_devices 1 --shard spatial: backend {seen.get('backend')}, world "
          f"{seen.get('world')}, {seen.get('pixels')} scored pixels (the labels' valid "
          f"{want_pixels}); B2 at {GN_SITES}; dumped predictions against this phase's unsharded "
          f"bf16 eval of the same images: {rate:.3e} over the gate's {share:.4f} of the pixels "
          f"(gate {SPATIAL_GATE}); {by_margin}; mIoU {miou:.6f}, the no-flag run's of phase 5 "
          f"{miou_ref:.6f} (diff {miou - miou_ref:+.3e}, printed)", flush=True)
    require(seen.get("backend") == dist.backend_for(DEVICE.type) and seen.get("world") == 1,
            f"the spatial CLI's world was {seen}")
    require(seen.get("pixels") == want_pixels, f"scored pixels {seen.get('pixels')}, "
                                                f"expected {want_pixels}")
    require_decided("spatial CLI dumps", rate, share)
    require(not dist.active(), "a process group outlived the CLI")
    return counts


def kernel_counts(distill: int, gn: int) -> dict:
    """The launches of a DeepLab or HRNet path: no depthwise kernel."""
    return {"distill_loss": distill, "distill_grad": distill,
            "group_norm_stats": gn, "group_norm_apply": gn,
            "depthwise_fwd": 0, "depthwise_wgrad": 0}


def check_train_run(name: str, wd: str, result, keys, preset: str = PRESET,
                    steps: int = TRAIN_STEPS, extra: dict | None = None) -> None:
    """Finite losses at the first logged step (the trainer logs every 50)
    and at the last step, then ``check_ckpt_final``."""
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    require([r["step"] for r in recs] == [0], f"{name} metrics.jsonl: {recs}")
    last = {"step": steps - 1, **result.last_metrics}
    for r in (recs[0], last):
        require(all(math.isfinite(r[k]) for k in keys), f"{name}: non-finite loss: {r}")
        require(0.0 <= r.get("consensus_kept", 0.0) <= 1.0, f"{name}: consensus_kept {r}")
    check_ckpt_final(name, wd, preset, steps, extra)
    print(f"main path {name} metrics: " + json.dumps([{k: r[k] for k in ("step", *keys)}
                                                      for r in (recs[0], last)]), flush=True)


def check_ckpt_final(name: str, wd: str, preset: str, steps: int,
                     extra: dict | None = None) -> None:
    """With no eval there is no best ``weights``; the final state in
    ``ckpt_final`` is at step ``steps`` and its student.pth loads strictly
    into ``preset``'s eval model (with the run's ``--extra`` entries)."""
    require(not os.path.exists(os.path.join(wd, "weights")),
            f"{name}: a run with no eval wrote {wd}/weights")
    final = os.path.join(wd, "ckpt_final")
    st = torch.load(os.path.join(final, "state.pth"), map_location="cpu")
    require(st["step"] == steps, f"{name}: ckpt_final at step {st['step']}, expected {steps}")
    cfg = get_preset(preset)
    build_eval(dataclasses.replace(cfg, extra={**cfg.extra, **(extra or {})}), final, DEVICE)
    print(f"{name}: no weights/ (no eval), ckpt_final at step {steps}, its student.pth loads "
          "strictly into the eval model", flush=True)


def phase_chain_main_paths(work: str, data_paths: dict) -> tuple[dict, dict]:
    """The self-training chain at full width from the warm-up's last-step
    weights: pseudolabel_generator -> calc_centroids -> train_self_training,
    then train_dg; returns (launch counts by path, the chain's paths)."""
    warm = os.path.join(work, "warmup", "ckpt_final")
    city = data_paths["target_root"]
    # the chain's target set: the first N_IMAGES Cityscapes train images
    lists = {}
    for key in ("target_img_list", "target_lbl_list"):
        with open(data_paths[key]) as f:
            names = [line for line in f.read().splitlines() if line][:N_IMAGES]
        lists[key] = os.path.join(work, f"chain_{key}.txt")
        with open(lists[key], "w") as f:
            f.write("\n".join(names) + "\n")
    data = ["--source_root", data_paths["source_root"], "--source_list", data_paths["source_list"],
            "--target_root", city, "--target_img_list", lists["target_img_list"],
            "--target_lbl_list", lists["target_lbl_list"]]
    counts = {}

    pseudo = os.path.join(city, PSEUDO_DIR)
    n, counts["pseudolabel_generator"] = run_path(
        "pseudolabel_generator", pseudolabel_generator.main,
        ["--preset", PRESET, "--weight_dir", warm, "--output_dir", pseudo, *data],
        kernel_counts(0, N_IMAGES * 2 * 6))  # images x scales x ASPP GroupNorm sites
    check_pseudo_labels(pseudo, n, 19)

    cdir = os.path.join(work, "centroids")
    cents, counts["calc_centroids"] = run_path(
        "calc_centroids", calc_centroids.main,
        ["--preset", PRESET, "--weight_dir", warm, "--centroid_dir", cdir, "--epochs", "1", *data],
        kernel_counts(0, N_IMAGES * 6))
    check_centroids(cdir, cents, 19, "target")

    centroid_path = os.path.join(cdir, "feat_centroids.npy")
    wd = os.path.join(work, "selftrain")
    result, counts["train_self_training"] = run_path(
        "train_self_training", train_self_training.main,
        ["--preset", SELFTRAIN_PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS),
         "--load_weight_dir", warm, "--centroid_path", centroid_path, *data],
        kernel_counts(TRAIN_STEPS, 2 * 6 * TRAIN_STEPS),  # teacher on [source; mix] and target
        (torch.bfloat16, DISTILL_SHAPE))
    check_train_run("train_self_training", wd, result,
                    ("loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"))

    wd = os.path.join(work, "dg")
    result, counts["train_dg"] = run_path(
        "train_dg", train_dg.main,
        ["--preset", DG_PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS), *data],
        kernel_counts(TRAIN_STEPS, 6 * TRAIN_STEPS), (torch.bfloat16, DISTILL_DG_SHAPE))
    check_train_run("train_dg", wd, result, ("loss", "loss_semseg", "loss_distil"))
    return counts, {"warm": warm, "centroid_path": centroid_path,
                    "data": {**data_paths, **lists}}


def data_args(paths: dict) -> list:
    return [a for k in ("source_root", "source_list", "target_root", "target_img_list",
                        "target_lbl_list") for a in (f"--{k}", paths[k])]


def check_pseudo_labels(pseudo: str, n: int, num_classes: int) -> None:
    files = sorted(os.listdir(pseudo))
    require(n == N_IMAGES and len(files) == N_IMAGES, f"pseudo-labels: {n}, {files}")
    for name in files:
        im = Image.open(os.path.join(pseudo, name))
        a = np.array(im)
        require(im.mode == "P" and a.shape == OUT_HW and int(a.max()) < num_classes,
                f"pseudo-label {name}: mode {im.mode}, shape {a.shape}, max {a.max()}")
    print(f"pseudo-labels: {files} P-mode {OUT_HW}, classes used "
          f"{sorted(set(np.unique(np.array(Image.open(os.path.join(pseudo, files[0])))).tolist()))}",
          flush=True)


def check_centroids(cdir: str, cents, num_classes: int, what: str, feat_dim: int = 256) -> None:
    vec = np.load(os.path.join(cdir, "feat_centroids.npy"))
    require(vec.shape == (num_classes, feat_dim) and np.isfinite(vec).all()
            and float(cents.counts.sum()) > 0,
            f"{what} centroids {vec.shape}, finite {np.isfinite(vec).all()}, counts {cents.counts}")
    print(f"{what} centroids: ({num_classes}, {feat_dim}) finite, classes observed "
          f"{int((cents.counts > 0).sum())}, counts {cents.counts.tolist()}", flush=True)


def phase_synthia_chain(work: str, val_paths: dict, gta_paths: dict) -> tuple[dict, dict]:
    """SYNTHIA->Cityscapes at full width, 16 classes, through the CLIs:
    train_warm_up (synthia2city_warmup: OHEM, LR warm-up, ColorJitter p 0.7;
    source 1 + 3 at 720x1280 and 1140x1920 from 760x1280 SYNTHIA images,
    target 1 + 3; 3 steps) -> pseudolabel_generator (2 images) ->
    calc_centroids on the target and with --source on SYNTHIA (2 images
    each) -> train_self_training (synthia2city_selftrain, 3 steps) ->
    evaluate_val at 16 classes (2 val images); then a --parity warm-up
    (gta2city_warmup in f32 with the kornia chain, 2 steps).  Returns
    (launch counts by path, the SYNTHIA warm-up's data paths)."""
    t0 = time.perf_counter()
    syn_root, city = os.path.join(work, "synthia"), os.path.join(work, "city_synthia")
    syn_list = synthetic.make_synthia_fixture(syn_root, n=4, h=SYNTHIA_HW[0], w=SYNTHIA_HW[1])
    img_list, lbl_list = synthetic.make_cityscapes_fixture(city, n=N_IMAGES, h=OUT_HW[0],
                                                           w=OUT_HW[1], split="train")
    print(f"SYNTHIA path setup (SYNTHIA {SYNTHIA_HW[0]}x{SYNTHIA_HW[1]} + Cityscapes fixtures): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    paths = {"source_root": syn_root, "source_list": syn_list, "target_root": city,
             "target_img_list": img_list, "target_lbl_list": lbl_list}
    data = data_args(paths)
    counts = {}

    wd = os.path.join(work, "synthia_warmup")
    result, counts["synthia train_warm_up"] = run_path(
        "synthia train_warm_up", train_warm_up.main,
        ["--preset", SYNTHIA_PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS), *data],
        kernel_counts(TRAIN_STEPS, 6 * TRAIN_STEPS), (torch.bfloat16, DISTILL_SYNTHIA_WARMUP_SHAPE))
    check_train_run("synthia train_warm_up", wd, result, ("loss", "loss_semseg", "loss_distil"),
                    preset=SYNTHIA_PRESET)
    warm = os.path.join(wd, "ckpt_final")

    pseudo = os.path.join(city, PSEUDO_DIR)
    n, counts["synthia pseudolabel_generator"] = run_path(
        "synthia pseudolabel_generator", pseudolabel_generator.main,
        ["--preset", SYNTHIA_PRESET, "--weight_dir", warm, "--output_dir", pseudo, *data],
        kernel_counts(0, N_IMAGES * 2 * 6))
    check_pseudo_labels(pseudo, n, 16)

    centroid_path = None
    for source in (False, True):
        what = "source (SYNTHIA)" if source else "target"
        cdir = os.path.join(work, f"synthia_centroids_{'source' if source else 'target'}")
        cents, counts[f"synthia calc_centroids {what.split()[0]}"] = run_path(
            f"synthia calc_centroids {what}", calc_centroids.main,
            ["--preset", SYNTHIA_PRESET, "--weight_dir", warm, "--centroid_dir", cdir,
             "--epochs", "1", "--limit", str(N_IMAGES), *data] + (["--source"] if source else []),
            kernel_counts(0, N_IMAGES * 6))
        check_centroids(cdir, cents, 16, what)
        centroid_path = centroid_path or os.path.join(cdir, "feat_centroids.npy")

    wd = os.path.join(work, "synthia_selftrain")
    result, counts["synthia train_self_training"] = run_path(
        "synthia train_self_training", train_self_training.main,
        ["--preset", SYNTHIA_SELFTRAIN_PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS),
         "--load_weight_dir", warm, "--centroid_path", centroid_path, *data],
        kernel_counts(TRAIN_STEPS, 2 * 6 * TRAIN_STEPS),
        (torch.bfloat16, DISTILL_SYNTHIA_SELFTRAIN_SHAPE))
    check_train_run("synthia train_self_training", wd, result,
                    ("loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"),
                    preset=SYNTHIA_SELFTRAIN_PRESET)

    results, counts["synthia evaluate_val"] = run_path(
        "synthia evaluate_val", evaluate_val.main,
        ["--preset", SYNTHIA_SELFTRAIN_PRESET, "--weight_dir", os.path.join(wd, "ckpt_final"),
         "--eval_limit", str(N_IMAGES), "--target_root", val_paths["root"],
         "--val_img_list", val_paths["val_img"], "--val_lbl_list", val_paths["val_lbl"]],
        kernel_counts(0, N_IMAGES * 2 * 6))
    scores = results.get("cityscapes", {})
    require({"mean_iou", "mean_iou_13"} <= set(scores)
            and all(0.0 <= scores[k] <= 1.0 for k in ("mean_iou", "mean_iou_13")),
            f"16-class scores from evaluate_val: {results}")
    print("synthia eval scores: " + json.dumps({k: float(v) for k, v in scores.items()}),
          flush=True)

    wd = os.path.join(work, "parity_warmup")
    gta = data_args(gta_paths)
    result, counts["parity train_warm_up"] = run_path(
        "parity train_warm_up", train_warm_up.main,
        ["--preset", PRESET, "--parity", "--work_dir", wd, "--num_steps", str(PARITY_STEPS),
         "--extra", f"layers={json.dumps(PARITY_LAYERS)}", *gta],
        kernel_counts(PARITY_STEPS, 6 * PARITY_STEPS), (torch.float32, DISTILL_SHAPE))
    check_train_run("parity train_warm_up", wd, result, ("loss", "loss_semseg", "loss_distil"),
                    steps=PARITY_STEPS, extra={"layers": PARITY_LAYERS})
    return counts, paths


TRANSLATOR_LOSSES = ("loss_g", "loss_d_s2t", "loss_d_t2s", "loss_adv", "loss_cyc", "loss_edge",
                     "loss_self")


def check_translator_run(name: str, wd: str, last: dict, steps: int) -> None:
    """Finite losses at step 0 and at the last step; the six roles in
    ``weights/``; ``ckpt_final`` with the six roles and ``state.pth`` at
    ``steps`` with six Adam states."""
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    require([r["step"] for r in recs] == [0], f"{name} metrics.jsonl: {recs}")
    for r in (recs[0], last):
        require(set(TRANSLATOR_LOSSES) <= set(r) and all(math.isfinite(r[k])
                                                         for k in TRANSLATOR_LOSSES),
                f"{name}: losses {r}")
    roles = sorted(f"{r}.pth" for r in ROLES)
    require(sorted(os.listdir(os.path.join(wd, "weights"))) == roles,
            f"{name}: weights/ holds {sorted(os.listdir(os.path.join(wd, 'weights')))}")
    final = os.path.join(wd, "ckpt_final")
    require(sorted(os.listdir(final)) == sorted(roles + ["state.pth"]),
            f"{name}: ckpt_final holds {sorted(os.listdir(final))}")
    st = torch.load(os.path.join(final, "state.pth"), map_location="cpu")
    require(st["step"] == steps and sorted(st["optimizers"]) == sorted(ROLES),
            f"{name}: ckpt_final at step {st['step']} with optimizers {sorted(st['optimizers'])}")
    print(f"main path {name} losses: "
          + json.dumps([{"step": i, **{k: r[k] for k in TRANSLATOR_LOSSES}}
                        for i, r in ((0, recs[0]), (steps - 1, last))])
          + f"; weights/ holds the six roles, ckpt_final at step {steps}", flush=True)


def seeded_vgg19_file(path: str, seed: int) -> None:
    """A torchvision-layout VGG19 ``features`` state_dict from a numpy seed
    (no weights ship with the repository): He-scaled convs, small biases."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in VGG19Features().state_dict().items():
        scale = math.sqrt(2.0 / math.prod(v.shape[1:])) if v.ndim == 4 else 0.01
        sd[k] = torch.from_numpy((rng.standard_normal(v.shape) * scale).astype(np.float32))
    torch.save(sd, path)


def phase_translator(work: str, gta_paths: dict, synthia_paths: dict, card: str,
                     profile_dir: str | None) -> dict:
    """The translator stage at full width through its CLI: gta2city_translator
    (3 steps), the warm-up from its weights (1 step), the step timed fused
    and unfused, synthia2city_translator (2 steps) and a run with a seeded
    VGG19 (2 steps).  Returns the launch counts by path."""
    counts = {}
    gta = data_args(gta_paths)
    wd = os.path.join(work, "translator")
    last, counts["train_domain_translator"] = run_path(
        "train_domain_translator", train_domain_translator.main,
        ["--preset", TRANSLATOR_PRESET, "--work_dir", wd, "--num_steps", str(TRANSLATOR_STEPS),
         *gta], kernel_counts(0, 0))
    check_translator_run("train_domain_translator", wd, last, TRANSLATOR_STEPS)

    weights = os.path.join(wd, "weights")
    wu = os.path.join(work, "translated_warmup")
    result, counts["translated train_warm_up"] = run_path(
        "translated train_warm_up", train_warm_up.main,
        ["--preset", PRESET, "--work_dir", wu, "--num_steps", "1", "--load_weight_dir", weights,
         *gta], kernel_counts(1, 6), (torch.bfloat16, DISTILL_SHAPE))
    check_train_run("translated train_warm_up", wu, result, ("loss", "loss_semseg", "loss_distil"),
                    steps=1)
    for role in ("enc_s", "dec_s2t"):
        a, b = (torch.load(os.path.join(d, f"{role}.pth"), map_location="cpu")
                for d in (weights, os.path.join(wu, "ckpt_final")))
        require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
                f"the warm-up's frozen {role} is not the translator's")
    print("translated train_warm_up: its frozen enc_s/dec_s2t are the translator's weights",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_translator_timing(gta_paths, card, profile_dir)
    gc.collect()
    torch.cuda.empty_cache()

    wd = os.path.join(work, "synthia_translator")
    last, counts["synthia train_domain_translator"] = run_path(
        "synthia train_domain_translator", train_domain_translator.main,
        ["--preset", SYNTHIA_TRANSLATOR_PRESET, "--work_dir", wd, "--num_steps",
         str(TRANSLATOR_SHORT_STEPS), *data_args(synthia_paths)], kernel_counts(0, 0))
    check_translator_run("synthia train_domain_translator", wd, last, TRANSLATOR_SHORT_STEPS)

    vgg = os.path.join(work, "vgg19_seeded.pth")
    seeded_vgg19_file(vgg, SEED + 9)
    wd = os.path.join(work, "vgg_translator")
    last, counts["vgg train_domain_translator"] = run_path(
        "vgg train_domain_translator", train_domain_translator.main,
        ["--preset", TRANSLATOR_PRESET, "--work_dir", wd, "--num_steps",
         str(TRANSLATOR_SHORT_STEPS), "--vgg_weights", vgg, *gta], kernel_counts(0, 0))
    check_translator_run("vgg train_domain_translator", wd, last, TRANSLATOR_SHORT_STEPS)
    return counts


def phase_translator_timing(data_paths: dict, card: str, profile_dir: str | None) -> dict:
    """ms/step of the translator step on one batch on the card, fused and
    unfused in turns (fused, unfused, unfused, fused); source imgs/s and
    peak memory of each; a profile of the fused step under --profile."""
    base = get_preset(TRANSLATOR_PRESET)
    cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, **data_paths))
    state, fused = train_domain_translator.build_translator_experiment(cfg, DEVICE)
    tcfg = train_domain_translator.translator_config(cfg, with_vgg=False)
    steps = {"fused": fused,
             "unfused": build_translator_step(dataclasses.replace(tcfg, fuse=False),
                                              poly_schedule(cfg.train.learning_rate,
                                                            cfg.train.num_steps))}
    it, loaders = make_translator_iterator(cfg)
    try:
        batch = to_device(next(it), DEVICE)
    finally:
        for ld in loaders:
            ld.stop()
    n_src, n_tgt = batch["s_img"].shape[0], batch["t_img"].shape[0]
    for step in steps.values():
        step_ms(state, step, batch, 2)  # cuDNN autotuning, allocator
    times = {form: [] for form in steps}
    peaks = {form: 0.0 for form in steps}
    for form in ("fused", "unfused", "unfused", "fused"):
        torch.cuda.reset_peak_memory_stats()
        times[form].append(step_ms(state, steps[form], batch, 3))
        peaks[form] = max(peaks[form], torch.cuda.max_memory_allocated() / 2**30)
    out = {}
    for form in steps:
        ms = float(np.mean(times[form]))
        out[form] = {"ms_per_step": ms, "peak_mem_GiB": peaks[form],
                     "imgs_per_sec": n_src / (ms / 1e3)}
        print(f"train translator step ({form}) enc 64 / dec 256 subpixel / 3-scale PatchGAN "
              f"{cfg.train.compute_dtype} source {n_src} + target {n_tgt} imgs crop "
              f"{tuple(batch['s_img'].shape[1:3])}: "
              f"ms/step {ms:.2f} {times[form]} source imgs/s {out[form]['imgs_per_sec']:.2f} "
              f"peak_mem_GiB={peaks[form]:.2f} | card={card}", flush=True)
    if profile_dir:
        out["fused"].update(profile_step("translator", state, steps["fused"], batch,
                                         out["fused"]["ms_per_step"], profile_dir))
    metric = f"{TRANSLATOR_PRESET}_train_imgs_per_sec_per_chip"
    print(json.dumps({"metric": metric, "value": out["fused"]["imgs_per_sec"], "unit": "imgs/sec",
                      "ms_per_step": out["fused"]["ms_per_step"],
                      "ms_per_step_unfused": out["unfused"]["ms_per_step"],
                      "peak_mem_GiB": out["fused"]["peak_mem_GiB"],
                      "peak_mem_GiB_unfused": out["unfused"]["peak_mem_GiB"], "card": card}),
          flush=True)
    return out


def phase_resume(work: str, gta_paths: dict) -> dict:
    """train_warm_up for 2 steps with --save_every 1, then --resume to 3
    steps: exactly one more step, from ckpt_final at step 2 to step 3.
    Returns the launch counts by path."""
    counts = {}
    wd = os.path.join(work, "resume_warmup")
    argv = ["--preset", PRESET, "--work_dir", wd, *data_args(gta_paths)]
    keys = ("loss", "loss_semseg", "loss_distil")
    result, counts["resume train_warm_up"] = run_path(
        "resume train_warm_up", train_warm_up.main,
        [*argv, "--num_steps", "2", "--save_every", "1"], kernel_counts(2, 12),
        (torch.bfloat16, DISTILL_SHAPE))
    check_train_run("resume train_warm_up", wd, result, keys, steps=2)
    metrics = os.path.join(wd, "metrics.jsonl")
    with open(metrics) as f:
        logged = f.read()
    out = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, out)):
        result, counts["resumed train_warm_up"] = run_path(
            "resumed train_warm_up", train_warm_up.main, [*argv, "--resume", "--num_steps", "3"],
            kernel_counts(1, 6), (torch.bfloat16, DISTILL_SHAPE))
    said = f"resumed from {os.path.join(wd, 'ckpt_final')} at step 2"
    require(said in out.getvalue(), f"resumed train_warm_up never said '{said}'")
    with open(metrics) as f:  # step 2 is not a logged step (every 50)
        require(f.read() == logged, "resumed train_warm_up logged a step to metrics.jsonl")
    require(all(math.isfinite(result.last_metrics[k]) for k in keys),
            f"resumed train_warm_up: non-finite loss: {result.last_metrics}")
    check_ckpt_final("resumed train_warm_up", wd, PRESET, 3)
    print("resume: train_warm_up resumed from ckpt_final at step 2 and took one step, to 3: "
          + json.dumps({k: result.last_metrics[k] for k in keys}), flush=True)
    return counts


def phase_profile_step(work: str, card: str) -> dict:
    """profile_step at full width (gta2city_warmup: 2 warm-up, 2 timed and 2
    traced steps on a synthetic batch), the first profiler use of the
    process: its report must hold device time in the distill and group_norm
    families and name the port's distill_* and gn_* kernels, and its traced
    steps must launch B1 once and B2 6 times a step (counted from its own
    trace's kernel records: ``port_launches``).  Returns the launch counts
    by path."""
    out = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, out)):
        rep, _ = run_path(
            "profile_step", profile_step_cli.main,
            ["--preset", PRESET, "--steps", str(PROFILE_STEPS), "--components",
             "--trace_dir", os.path.join(work, "profile_step")],
            None, (torch.bfloat16, DISTILL_SHAPE), {GN_TRAIN_SITES[0]})
    text = out.getvalue()
    require(rep is not None and rep.total_s > 0, "profile_step: no device ops in its trace")
    counts = span_recorder.port_launches(rep.top_ops)
    want = kernel_counts(PROFILE_STEPS, 6 * PROFILE_STEPS)
    require(counts == want, f"profile_step's {PROFILE_STEPS} traced steps launched {counts}, "
                            f"expected {want}")
    require({"distill", "group_norm"} <= set(rep.by_category),
            f"profile_step: no distill or group_norm family in {sorted(rep.by_category)}")
    start, end = text.find("port kernels"), text.find("device ops (ms/step)")
    names = (sorted(set(re.findall(r"\b(?:distill|gn)_\w*kernel", text[start:end])))
             if 0 <= start < end else [])
    require(any(k.startswith("distill_") for k in names) and any(k.startswith("gn_")
                                                                for k in names),
            f"profile_step's table does not name the port's kernels: {names}")
    print(f"profile_step {PRESET}: device {rep.device_ms_per_step:.2f} ms/step of "
          f"{rep.step_ms:.2f} unprofiled, busy share {rep.busy_share:.3f}; families "
          + json.dumps({k: round(v[0] / PROFILE_STEPS * 1e3, 3) for k, v in
                        sorted(rep.by_category.items(), key=lambda kv: -kv[1][0])})
          + f" ms/step; port kernels named {names}; launches in the traced steps {counts} "
          f"| card={card}", flush=True)
    att = rep.components
    share = att["unmatched"] / att["total"]
    print(f"profile_step {PRESET} components, ms/step: "
          + json.dumps({k: round(v * 1e3, 3) for k, v in att["components"].items()})
          + f"; unmatched {att['unmatched'] * 1e3:.3f} ({share:.4f} of {att['total'] * 1e3:.2f}); "
          f"port kernels by component (ms/step) "
          + json.dumps({c: {f: round(t * 1e3, 4) for f, t in fam.items()}
                        for c, fam in att["port_kernels"].items()}) + f" | card={card}", flush=True)
    require(share <= 0.05, f"profile_step --components: {share:.3f} of the device time unmatched")
    require("distill" in att["port_kernels"].get("loss_resize", {}),
            f"profile_step --components: B1 not in loss_resize: {att['port_kernels']}")
    require("group_norm" in att["port_kernels"].get("model_fwd", {}),
            f"profile_step --components: B2 not in model_fwd: {att['port_kernels']}")
    return {"profile_step": counts}


def phase_prefetch(data_paths: dict, card: str) -> dict:
    """The warm-up's full-resolution streams (GTA5 1052x1914, Cityscapes
    1024x2048; source 1 + 2, target 1 + 2): host s/batch from the loader
    alone; ``to_device``'s host time per batch and its time to the copy's
    end; the warm-up step fed from batches already on the host through
    ``to_device`` (the loop before the prefetch) and through
    ``device_prefetch``, in turns (the copy's cost without the loader's);
    then ``PREFETCH_BATCHES`` batches from the loader through
    ``device_prefetch`` under real steps, each copied back to pinned host
    memory on the step's stream after its step and, after the loop,
    required equal to its host copy.  Wall ms/step and the host's wait per
    step for its batch."""
    base = get_preset(PRESET)
    cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, **data_paths))

    def loader_alone() -> tuple[float, list]:
        it, loaders = make_train_iterator(cfg, with_target=True)
        try:
            next(it)  # the worker threads' start
            t0 = time.perf_counter()
            batches = [next(it) for _ in range(6)]
            return (time.perf_counter() - t0) / len(batches), batches
        finally:
            for ld in loaders:
                ld.stop()

    # the loader with the C host ops, then with their numpy forms (one pair:
    # the two differed by less than the turns' spread, PERF.md §6)
    loader_times = {"c": [], "numpy": []}
    c_ops = host_ops.remap_u8, host_ops.normalize_bgr
    for mode in ("c", "numpy"):
        if mode == "numpy":
            host_ops.remap_u8, host_ops.normalize_bgr = label_maps.remap_labels, normalize_image
        try:
            sec, host = loader_alone()
        finally:
            host_ops.remap_u8, host_ops.normalize_bgr = c_ops
        loader_times[mode].append(sec)
    loader_s = float(np.mean(loader_times["c"]))
    loader_numpy_s = float(np.mean(loader_times["numpy"]))
    mb = sum(v.nbytes for v in host[0].values() if isinstance(v, np.ndarray)) / 1e6
    call_ms, copy_ms = [], []
    for b in host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = to_device(b, DEVICE)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        call_ms.append((t1 - t0) * 1e3)
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    del d
    state, step, _ = build_experiment(cfg, DEVICE)

    def loop(batches, n: int, staged: list | None = None) -> tuple[float, float]:
        """(wall ms/step, wait ms/step) over n steps after a first one."""
        waits = []
        for i in range(n + 1):  # the first: the loader's start, the allocator
            if i == 1:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            t0 = time.perf_counter()
            batch = next(batches)
            if i:
                waits.append(time.perf_counter() - t0)
            step(state, {k: v for k, v in batch.items() if k != "t_lbl"})
            if staged is not None:
                staged.append({k: v.to("cpu", non_blocking=True) for k, v in batch.items()})
        torch.cuda.synchronize()
        return (time.perf_counter() - t_start) / n * 1e3, float(np.mean(waits)) * 1e3

    def cycled():
        while True:
            yield from host

    times = {"to_device": [], "prefetch": []}
    for mode in ("to_device", "prefetch", "prefetch", "to_device"):
        src = cycled()
        batches = (device_prefetch(src, DEVICE) if mode == "prefetch"
                   else (to_device(b, DEVICE) for b in src))
        times[mode].append(loop(batches, 6))
    it, loaders = make_train_iterator(cfg, with_target=True)
    copies, staged = [], []

    def tee():
        for b in it:
            copies.append(b)
            yield b

    try:
        fed = loop(device_prefetch(tee(), DEVICE), PREFETCH_BATCHES, staged)
    finally:
        for ld in loaders:
            ld.stop()
    for i, (got, want) in enumerate(zip(staged, copies)):
        for k, v in want.items():
            require(np.array_equal(got[k].numpy(), v),
                    f"device_prefetch: batch {i} {k} on the card differs from its host copy")
    out = {"loader_s_per_batch": loader_s, "loader_numpy_s_per_batch": loader_numpy_s,
           "to_device_call_ms": float(np.mean(call_ms)),
           "to_device_ms": float(np.mean(copy_ms)), "loader_fed_prefetch_ms_per_step": fed[0],
           "loader_fed_prefetch_wait_ms": fed[1]}
    for mode, runs in times.items():
        out[f"{mode}_ms_per_step"] = float(np.mean([r[0] for r in runs]))
        out[f"{mode}_wait_ms"] = float(np.mean([r[1] for r in runs]))
    fmt = lambda mode: (f"{out[mode + '_ms_per_step']:.2f} {[round(r[0], 2) for r in times[mode]]}"
                        f" (wait {out[mode + '_wait_ms']:.2f})")  # noqa: E731
    print(f"prefetch {PRESET} streams ({mb:.1f} MB a batch): loader alone {loader_s:.3f} "
          f"s/batch; to_device {out['to_device_call_ms']:.2f} ms of host call, "
          f"{out['to_device_ms']:.2f} ms to the copy's end; warm-up step from host batches, "
          f"ms/step: to_device {fmt('to_device')}, device_prefetch {fmt('prefetch')}; from the "
          f"loader through device_prefetch {fed[0]:.2f} ms/step (wait {fed[1]:.2f}), "
          f"{len(staged)} of {len(staged)} prefetched batches equal to their host copies "
          f"| card={card}", flush=True)
    print(f"prefetch {PRESET} host ops: the loader alone {loader_s:.3f} s/batch with the C ops "
          f"{[round(t, 3) for t in loader_times['c']]}, {loader_numpy_s:.3f} with their numpy "
          f"forms {[round(t, 3) for t in loader_times['numpy']]} (the numpy ops, an "
          f"earlier run: {NUMPY_OPS_LOADER_S} s/batch); loader-fed {fed[0]:.2f} ms/step (the "
          f"numpy ops, an earlier run: {NUMPY_OPS_LOADER_FED_MS} ms/step) | card={card}",
          flush=True)
    return out


def phase_fused_selftrain(work: str, chain: dict) -> dict:
    """train_self_training --extra fuse_forwards=true at full width, 3 steps,
    from the warm-up's state: one teacher forward a step (6 GroupNorms, all
    at batch 9: [source; mix; target]) and one student forward; finite
    losses, consensus_kept in [0, 1].  Returns the launch counts by path."""
    wd = os.path.join(work, "selftrain_fused")
    result, counts = run_path(
        "fused train_self_training", train_self_training.main,
        ["--preset", SELFTRAIN_PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS),
         "--load_weight_dir", chain["warm"], "--centroid_path", chain["centroid_path"],
         "--extra", "fuse_forwards=true", *data_args(chain["data"])],
        kernel_counts(TRAIN_STEPS, 6 * TRAIN_STEPS), (torch.bfloat16, DISTILL_SHAPE),
        {GN_TRAIN_SITES[3]})
    check_train_run("fused train_self_training", wd, result,
                    ("loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"),
                    preset=SELFTRAIN_PRESET)
    return {"fused train_self_training": counts}


@contextlib.contextmanager
def scopes_off(calls: list):
    """Every profiler scope of the steps (``train/steps.py``,
    ``train/steps_translator.py``, ``models/translator.py``,
    ``train/graphs.py``) a no-op that
    counts its entries in ``calls[0]``, as the CPU test
    ``test_scopes_change_no_value`` switches them off."""
    def off(name):
        calls[0] += 1
        return contextlib.nullcontext()

    sites = [(steps_module, "scope"), (steps_translator_module, "scope"),
             (translator_module, "scope"), (graphs_module, "span")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in sites]
    for mod, attr in sites:
        setattr(mod, attr, off)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def scope_host_us(n: int = 20000, make=torch.profiler.record_function) -> float:
    """Host µs of one scope enter and exit with no profiler running (the
    best of 3 loops of ``n``): ``make(name)`` gives the scope, a bare
    ``record_function`` or the port's ``span``."""
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            with make("scope_cost"):
                pass
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
    return best


def phase_fused_timing(preset: str, data_paths: dict, card: str, profile_dir: str | None,
                       gn_per_step: int, unscoped: bool = False, **build_kw) -> dict:
    """ms/step of ``preset``'s self-training step on one batch on the card,
    fused (``fuse_forwards``) and unfused in turns (fused, unfused, unfused,
    fused) on one state; source imgs/s, peak memory, and under --profile
    the busy share of each.  One fused step must launch B1 once and B2
    ``gn_per_step`` times.  With ``unscoped``, the unfused step also runs
    with its profiler scopes switched off (``scopes_off``), in turns with
    the scoped one (fused, unfused, unscoped, unscoped, unfused, fused),
    beside the scopes' count per step and their host cost alone."""
    base = get_preset(preset)
    cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, **data_paths))
    state, unfused, _ = build_experiment(cfg, DEVICE, **build_kw)
    fused = build_selftrain_step(dataclasses.replace(make_step_config(cfg), fuse_forwards=True),
                                 make_schedule(cfg))
    steps = {"fused": fused, "unfused": unfused}
    it, loaders = make_train_iterator(cfg, with_target=True)
    try:
        batch = to_device(next(it), DEVICE)
    finally:
        for ld in loaders:
            ld.stop()
    batch.pop("t_lbl", None)
    n_src, n_tgt = batch["s_img"].shape[0], batch["t_img"].shape[0]
    for step in steps.values():
        step_ms(state, step, batch, 2)  # cuDNN autotuning at the batch-9 shapes, allocator
    with span_recorder.device_launches() as counts:
        step_ms(state, fused, batch, 1)
    want = kernel_counts(1, gn_per_step)
    require(counts == want, f"one fused {preset} step launched {counts}, expected {want}")
    order = ("fused", "unfused", "unscoped", "unscoped", "unfused", "fused") if unscoped \
        else ("fused", "unfused", "unfused", "fused")
    times = {form: [] for form in dict.fromkeys(order)}
    peaks = {form: 0.0 for form in times}
    calls = [0]
    for form in order:
        torch.cuda.reset_peak_memory_stats()
        with scopes_off(calls) if form == "unscoped" else contextlib.nullcontext():
            times[form].append(step_ms(state, steps.get(form, unfused), batch, 4))
        peaks[form] = max(peaks[form], torch.cuda.max_memory_allocated() / 2**30)
    hrnet = cfg.extra.get("model") == "hrnet_ocr"
    out = {}
    for form in times:
        ms = float(np.mean(times[form]))
        out[form] = {"ms_per_step": ms, "peak_mem_GiB": peaks[form],
                     "imgs_per_sec": n_src / (ms / 1e3)}
        print(f"train selftrain step ({form}) {'HRNet-W48+OCR' if hrnet else 'R101'} bf16 "
              f"source {n_src} + target {n_tgt} imgs crop {tuple(batch['s_img'].shape[1:3])}: "
              f"ms/step {ms:.2f} {times[form]} source imgs/s {out[form]['imgs_per_sec']:.2f} "
              f"peak_mem_GiB={peaks[form]:.2f} | card={card}", flush=True)
        if profile_dir and form in steps:
            tag = f"{'semiseg_' if hrnet else ''}selftrain_{form}"
            out[form].update(profile_step(tag, state, steps[form], batch, ms, profile_dir))
    scope_cost = {}
    if unscoped:
        per_step = calls[0] / (4 * len(times["unscoped"]))
        us = scope_host_us()
        span_off = scope_host_us(make=span_recorder.span)
        with span_recorder.recording():
            span_on = scope_host_us(make=span_recorder.span)
        scope_cost = {"ms_per_step_unscoped": out["unscoped"]["ms_per_step"],
                      "scopes_per_step": per_step, "scope_host_us": us,
                      "span_off_host_us": span_off, "span_on_host_us": span_on}
        print(f"the steps' profiler scopes: {per_step:.0f} a step, {us:.3f} host us each "
              f"alone ({per_step * us / 1e3:.4f} ms a step), a span {span_off:.3f} with no "
              f"recording open, {span_on:.3f} with one; unfused "
              f"{out['unfused']['ms_per_step']:.2f} ms/step {times['unfused']} with them, "
              f"{out['unscoped']['ms_per_step']:.2f} {times['unscoped']} without | card={card}",
              flush=True)
    print(json.dumps({"metric": f"{preset}_fused_train_imgs_per_sec_per_chip",
                      "value": out["fused"]["imgs_per_sec"], "unit": "imgs/sec",
                      "ms_per_step": out["fused"]["ms_per_step"],
                      "ms_per_step_unfused": out["unfused"]["ms_per_step"],
                      "peak_mem_GiB": out["fused"]["peak_mem_GiB"],
                      "peak_mem_GiB_unfused": out["unfused"]["peak_mem_GiB"],
                      **({"busy_share": out["fused"]["busy_share"],
                          "busy_share_unfused": out["unfused"]["busy_share"]}
                         if profile_dir else {}), **scope_cost, "card": card}), flush=True)
    return out


def phase_parity_check(warm: str, val_paths: dict, card: str) -> dict:
    """parity_check --vs_torch_replay at full width in f32 (R101, the
    warm-up's student.pth, 2 synthetic 1024x2048 val images): pixel
    disagreement with the replay below 1e-3, B2 launched 6 times for the
    activation input and 2 images x 2 scales x 6 for the eval; then, not
    gated, the bf16 eval's disagreement and activation difference against
    the same f32 replay.  Returns the launch counts by path."""
    val = ["--target_root", val_paths["root"], "--val_img_list", val_paths["val_img"],
           "--val_lbl_list", val_paths["val_lbl"]]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(Tee(sys.stdout, out)):
            (conf_ours, conf_torch, disagree), counts = run_path(
                "parity_check", parity_check.main,
                ["--preset", PRESET, "--weight_dir", warm, "--vs_torch_replay", "--eval_limit",
                 str(N_IMAGES), "--compute_dtype", "float32", *val],
                kernel_counts(0, 6 + N_IMAGES * 2 * 6), gn_sites={GN_PARITY_SITE, *GN_SITES})
    except SystemExit as e:  # the gate's breach
        raise SmokeFailure(f"parity_check: {e}") from e
    act = float(re.search(r"logits_torch\| = (\S+)", out.getvalue()).group(1))
    gap = int(np.abs(conf_ours - conf_torch).sum())
    require(disagree < parity_check.GATE, f"parity_check f32: disagreement {disagree}")
    base = get_preset(PRESET)
    cfg = dataclasses.replace(base, data=dataclasses.replace(
        base.data, target_root=val_paths["root"], val_img_list=val_paths["val_img"],
        val_lbl_list=val_paths["val_lbl"]))
    with parity_check.no_tf32():
        act_bf16 = parity_check.activation_parity(cfg, warm, DEVICE)
        _, _, disagree_bf16 = parity_check.eval_confusion_vs_torch(cfg, warm, DEVICE, N_IMAGES)
    print(f"parity_check R101 two-scale {OUT_HW[0]}x{OUT_HW[1]}+{DS_HW[0]}x{DS_HW[1]}, "
          f"{N_IMAGES} images, against the f32 replay: f32 activation max_abs_diff {act:.3e}, "
          f"pixel disagreement {disagree:.3e} (gate {parity_check.GATE}), confusion L1 gap "
          f"{gap} of {int(conf_ours.sum())}; bf16 (not gated) activation max_abs_diff "
          f"{act_bf16:.3e}, pixel disagreement {disagree_bf16:.3e} | card={card}", flush=True)
    return {"parity_check": counts}


def hrnet_ocr_gmacs(hw=(512, 1024)) -> float:
    """Multiply-accumulates (G) of one HRNet-W48+OCR forward on one image of
    ``hw``, counted from the code: every convolution's, by forward hooks on a
    CPU run at 1/8 of ``hw`` scaled by 64 (each branch's size divides
    exactly), plus the OCR head's three attention products at 1/4 scale
    (region representations K·P·512, similarities and their value product
    P·256·K each, P the 1/4-scale pixels)."""
    model = HRNetOCR(19).eval()
    macs = [0]

    def hook(mod, inp, out):
        macs[0] += out.numel() * (mod.in_channels // mod.groups) * math.prod(mod.kernel_size)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(torch.zeros(1, 3, hw[0] // 8, hw[1] // 8).to(memory_format=torch.channels_last))
    for h in hooks:
        h.remove()
    p = hw[0] // 4 * hw[1] // 4
    return (macs[0] * 64 + 19 * p * 512 + 2 * p * 256 * 19) / 1e9


def semiseg_floor_ms(gmacs: float, stage: str) -> float:
    """The compute floor of one semiseg step at 989 TFLOP/s dense bf16: a
    forward is ``gmacs`` per image, a forward with its backward three times
    that.  Warm-up: the teacher on 6 images, the student on 6 with its
    backward, the target-stats forward on 3 (all but the classifier):
    27 forwards.  Self-training: the teacher on 6 and 3, the student on 6 and
    3 with their backward: 36."""
    forwards = 27 if stage == "warmup" else 36
    return 2 * gmacs * 1e9 * forwards / BF16_FLOPS_PER_S * 1e3


def phase_semiseg(work: str, card: str, profile_dir: str | None) -> dict:
    """The semi-supervised Cityscapes chain at full width through the CLIs:
    HRNet-W48+OCR, bf16, from a numpy-seeded student.pth; 1024x2048
    Cityscapes fixtures split into a labeled source (2 images, their labels
    through --target_lbl_list by position) and an unlabeled target (2
    images), two val images.  train_warm_up (semiseg_1_8_warmup, 3 steps) ->
    pseudolabel_generator (2 images) -> calc_centroids (one epoch, (19, 512))
    -> train_self_training (semiseg_1_8_selftrain, 3 steps) -> evaluate_val
    (2 images); then the warm-up and self-training steps timed as in phase 6,
    and the eval's ms/img.  Returns the launch counts by path."""
    t0 = time.perf_counter()
    city, val_root = os.path.join(work, "city_semiseg"), os.path.join(work, "city_semiseg_val")
    img_list, lbl_list = synthetic.make_cityscapes_fixture(city, n=4, h=OUT_HW[0], w=OUT_HW[1],
                                                           split="train")
    val_img, val_lbl = synthetic.make_cityscapes_fixture(val_root, n=N_IMAGES, h=OUT_HW[0],
                                                         w=OUT_HW[1], split="val")
    with open(img_list) as f:
        imgs = f.read().split()
    with open(lbl_list) as f:
        lbls = f.read().split()
    lists = {}
    for key, names in (("source_list", imgs[:2]), ("target_lbl_list", lbls[:2]),
                       ("target_img_list", imgs[2:])):
        lists[key] = os.path.join(work, f"semiseg_{key}.txt")
        with open(lists[key], "w") as f:
            f.write("\n".join(names) + "\n")
    paths = {"source_root": city, "target_root": city, **lists}
    data = data_args(paths)
    init = os.path.join(work, "semiseg_init")
    export_role_keyed(init, {"student": seeded_state_dict(HRNetOCR(19), SEED + 10)})
    print(f"semiseg path setup (Cityscapes 1024x2048 fixtures, seeded HRNet-W48+OCR "
          f"student.pth): {time.perf_counter() - t0:.1f} s", flush=True)
    gmacs = hrnet_ocr_gmacs()
    print(f"semiseg compute floor: HRNet-W48+OCR forward {gmacs:.1f} GMAC per 512x1024 image; "
          f"warm-up step {semiseg_floor_ms(gmacs, 'warmup'):.2f} ms, self-training step "
          f"{semiseg_floor_ms(gmacs, 'selftrain'):.2f} ms at {BF16_FLOPS_PER_S / 1e12:.0f} "
          "TFLOP/s dense bf16", flush=True)
    counts = {}
    site = (torch.bfloat16, DISTILL_SEMISEG_SHAPE)

    wd = os.path.join(work, "semiseg_warmup")
    result, counts["semiseg train_warm_up"] = run_path(
        "semiseg train_warm_up", train_warm_up.main,
        ["--preset", SEMISEG_WARMUP_PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS),
         "--load_weight_dir", init, *data],
        kernel_counts(2 * TRAIN_STEPS, 0), site)  # the logits' and the OCR aux logits'
    check_train_run("semiseg train_warm_up", wd, result, ("loss", "loss_semseg", "loss_distil"),
                    preset=SEMISEG_WARMUP_PRESET)
    warm = os.path.join(wd, "ckpt_final")

    pseudo = os.path.join(city, PSEUDO_DIR)
    n, counts["semiseg pseudolabel_generator"] = run_path(
        "semiseg pseudolabel_generator", pseudolabel_generator.main,
        ["--preset", SEMISEG_WARMUP_PRESET, "--weight_dir", warm, "--output_dir", pseudo, *data],
        kernel_counts(0, 0))
    check_pseudo_labels(pseudo, n, 19)

    cdir = os.path.join(work, "semiseg_centroids")
    cents, counts["semiseg calc_centroids"] = run_path(
        "semiseg calc_centroids", calc_centroids.main,
        ["--preset", SEMISEG_WARMUP_PRESET, "--weight_dir", warm, "--centroid_dir", cdir,
         "--epochs", "1", *data], kernel_counts(0, 0))
    check_centroids(cdir, cents, 19, "semiseg target", feat_dim=512)
    centroid_path = os.path.join(cdir, "feat_centroids.npy")

    wd = os.path.join(work, "semiseg_selftrain")
    result, counts["semiseg train_self_training"] = run_path(
        "semiseg train_self_training", train_self_training.main,
        ["--preset", SEMISEG_SELFTRAIN_PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS),
         "--load_weight_dir", warm, "--centroid_path", centroid_path, *data],
        kernel_counts(TRAIN_STEPS, 0), site)
    check_train_run("semiseg train_self_training", wd, result,
                    ("loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"),
                    preset=SEMISEG_SELFTRAIN_PRESET)
    final = os.path.join(wd, "ckpt_final")

    dump = os.path.join(work, "semiseg_preds")
    results, counts["semiseg evaluate_val"] = run_path(
        "semiseg evaluate_val", evaluate_val.main,
        ["--preset", SEMISEG_SELFTRAIN_PRESET, "--weight_dir", final, "--eval_limit",
         str(N_IMAGES), "--target_root", val_root, "--val_img_list", val_img, "--val_lbl_list",
         val_lbl, "--dump_preds", dump], kernel_counts(0, 0))
    scores = results.get("cityscapes", {})
    require(0.0 <= scores.get("mean_iou", -1.0) <= 1.0, f"semiseg evaluate_val: {results}")
    print("semiseg eval scores: " + json.dumps({k: float(v) for k, v in scores.items()}),
          flush=True)
    eval_apply, _ = build_eval(get_preset(SEMISEG_SELFTRAIN_PRESET), final, DEVICE)
    img, lbl = check_outputs(eval_apply, {"root": val_root, "val_img": val_img,
                                          "val_lbl": val_lbl, "dump": dump})
    for _ in range(2):  # warm-up: cuDNN set-up, allocator
        eval_ms_per_img(eval_apply, img, lbl, 1)
    torch.cuda.reset_peak_memory_stats()
    times = [eval_ms_per_img(eval_apply, img, lbl, 5) for _ in range(2)]
    ms = float(np.mean(times))
    print(f"eval two-scale HRNet-W48+OCR bf16 batch 1 {OUT_HW[0]}x{OUT_HW[1]}+{DS_HW[0]}x"
          f"{DS_HW[1]}: ms/img {ms:.2f} {times} peak_mem_MiB="
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} | card={card}", flush=True)
    if profile_dir:
        phase_profile(eval_apply, img, lbl, ms, profile_dir, name="semiseg_eval")
    del eval_apply, img, lbl
    gc.collect()
    torch.cuda.empty_cache()

    for preset, kw in ((SEMISEG_WARMUP_PRESET, {"load_weight_dir": init}),
                       (SEMISEG_SELFTRAIN_PRESET, {"load_weight_dir": warm,
                                                   "centroid_path": centroid_path})):
        out = phase_train_timing(preset, paths, card, profile_dir, **kw)
        stage = get_preset(preset).stage
        floor = semiseg_floor_ms(gmacs, stage)
        print(f"semiseg {stage} step: {out['ms_per_step']:.2f} ms against its compute floor "
              f"{floor:.2f} ms ({floor / out['ms_per_step']:.3f} of it) | card={card}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    # the fused self-training step: B1 once a step, no B2 (HRNet+OCR has no GroupNorm)
    phase_fused_timing(SEMISEG_SELFTRAIN_PRESET, paths, card, profile_dir, 0, unscoped=True,
                       load_weight_dir=warm, centroid_path=centroid_path)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_make_viz(work: str, chain: dict) -> None:
    """make_viz figure over phase 7's pseudo-label PNGs (2 images): host only,
    no kernel launched; each figure is the image and the colour-rendered
    pseudo-labels side by side."""
    data = chain["data"]
    out_dir = os.path.join(work, "figures")
    reset_launches()
    t0 = time.perf_counter()
    make_viz.main(["figure", "--img_root", os.path.join(data["target_root"], "leftImg8bit", "train"),
                   "--img_list", data["target_img_list"], "--edges", "--out_dir", out_dir,
                   "--pred_dirs", os.path.join(data["target_root"], PSEUDO_DIR)])
    sec = time.perf_counter() - t0
    written = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir))
    require(all(v == 0 for v in launches().values()), f"make_viz launched kernels: {launches()}")
    shapes = [np.asarray(Image.open(f)).shape for f in written]
    require(len(written) == N_IMAGES and all(sh == (OUT_HW[0], 2 * OUT_HW[1] + 4, 3)
                                              for sh in shapes),
            f"make_viz figure: {written} {shapes}")
    print(f"make_viz figure: {len(written)} figures {shapes[0]} over the pseudo-labels in "
          f"{sec:.1f} s (host only, no launch)", flush=True)


def source_batch(preset: str) -> int:
    return sum(s.batch for s in get_preset(preset).data.source_streams)


def _fixture_soak_rate(wd: str, batch: int) -> tuple[float, float]:
    """(ms/step, source imgs/s) of a fixture soak from the loop's logged
    steps/s after the resume (the median: an eval inflates its interval)."""
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        rates = [r["steps_per_sec"] for r in map(json.loads, f) if "steps_per_sec" in r][1:]
    sps = float(np.median(rates))
    return 1e3 / sps, batch * sps


def phase_soak(work: str, card: str) -> dict:
    """Three soaks through ``soak``'s CLI: the onchip warm-up at full width
    (device-generated batches of the preset's shapes), the DG fixture soak
    at production widths on 96x160 fixtures (crop 64x128, the mid-run
    checkpoint restored into a fresh experiment, in-loop evals) and the
    onchip translator.  Each asserts its own invariants; returns the launch
    counts by path."""
    counts, rates = {}, {}
    wd = os.path.join(work, "soak_onchip_warmup")
    res, counts["soak onchip gta2city_warmup"] = run_path(
        "soak onchip gta2city_warmup", soak.main,
        ["--preset", PRESET, "--mode", "onchip", "--steps", str(SOAK_ONCHIP_STEPS),
         "--work_dir", wd],
        kernel_counts(SOAK_ONCHIP_STEPS, 6 * SOAK_ONCHIP_STEPS), (torch.bfloat16, DISTILL_SHAPE),
        {GN_TRAIN_SITES[0]})
    rates["onchip warm-up"] = (source_batch(PRESET) / res["imgs_per_sec"] * 1e3,
                               res["imgs_per_sec"], res["first"], res["last"])
    gc.collect()
    torch.cuda.empty_cache()

    n, every = SOAK_FIXTURE_STEPS, max(SOAK_FIXTURE_STEPS // 4, 1)
    evals = sum(1 for i in range(1, n) if i % every == 0)
    wd = os.path.join(work, "soak_fixtures_dg")
    res, counts["soak fixtures dg_gta5"] = run_path(
        "soak fixtures dg_gta5", soak.main,
        ["--preset", DG_PRESET, "--steps", str(n), "--work_dir", wd],
        kernel_counts(n, 6 * n + evals * 4 * 2 * 6),  # the teacher; 4 val images x 2 scales
        (torch.bfloat16, (8, 64, 128, 19)))
    rates["fixtures dg"] = (*_fixture_soak_rate(wd, source_batch(DG_PRESET)), res["head"],
                            res["tail"])
    gc.collect()
    torch.cuda.empty_cache()

    wd = os.path.join(work, "soak_onchip_translator")
    res, counts["soak onchip gta2city_translator"] = run_path(
        "soak onchip gta2city_translator", soak.main,
        ["--preset", TRANSLATOR_PRESET, "--mode", "onchip", "--steps",
         str(SOAK_TRANSLATOR_STEPS), "--work_dir", wd], kernel_counts(0, 0))
    rates["onchip translator"] = (source_batch(TRANSLATOR_PRESET) / res["imgs_per_sec"] * 1e3,
                                  res["imgs_per_sec"], res["head"], res["tail"])
    gc.collect()
    torch.cuda.empty_cache()
    print("soak: " + "; ".join(
        f"{k} {v[0]:.2f} ms/step, {v[1]:.2f} source imgs/s, loss {v[2]:.4f} -> {v[3]:.4f}"
        for k, v in rates.items())
        + f" (steps {SOAK_ONCHIP_STEPS}, {SOAK_FIXTURE_STEPS}, {SOAK_TRANSLATOR_STEPS}) "
        f"| card={card}", flush=True)
    return counts


class Tee(io.TextIOBase):
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        super().__init__()
        self.streams = streams

    def write(self, s: str) -> int:
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def phase_pseudolabel_timing(warm: str, data: dict, card: str) -> float:
    """ms/img of the pseudo-label generator's per-image work on the card:
    the two-scale forward, the argmax and the uint8 map to the host (the
    PNG encoding and the image decode are left out)."""
    eval_apply, _ = build_eval(get_preset(PRESET), warm, DEVICE)
    ds = cityscapes_dataset(data["target_root"], data["target_img_list"], data["target_lbl_list"],
                            split="train", resize_hw=OUT_HW)
    img = torch.from_numpy(ds[0]["image"][None]).to(DEVICE)

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            pseudolabel_generator.predict_labels(eval_apply, img, OUT_HW, DS_HW).cpu()
        return (time.perf_counter() - t0) / n * 1e3

    run(2)
    times = [run(5) for _ in range(2)]
    ms = float(np.mean(times))
    print(f"pseudo-labels two-scale R101 bf16 {OUT_HW[0]}x{OUT_HW[1]}+{DS_HW[0]}x{DS_HW[1]}: "
          f"ms/img {ms:.2f} {times} | card={card}", flush=True)
    return ms


def phase_distill_timing(card: str) -> dict:
    """B1a/B1b device times at the paths' shapes against their bounds and
    plain versions; a kernel's row is the warm-up's and self-training's site."""
    per_kernel = {}
    g = torch.tensor(0.5, device="cuda")
    for shape in DISTILL_SITES:
        n_buf = 2  # 2 x 2 x >= 52.3 MB of logits: more than the 50 MB L2
        pairs = [distill_inputs(shape, torch.bfloat16, seed=300 + i) for i in range(n_buf)]
        loss_args = [(t, s, 0.5) for t, s in pairs]
        grad_args = [(t, s, g, 0.5) for t, s in pairs]
        t = {
            "distill_loss": time_us(D.distillation_loss_kernel, loss_args),
            "distill_loss_plain": time_us(D.distillation_loss_plain, loss_args),
            "distill_grad": time_us(D.distillation_grad_kernel, grad_args),
            "distill_grad_plain": time_us(D.distillation_grad_plain, grad_args),
        }
        numel = math.prod(shape)
        xb = numel * 2
        # reads t and s once (and writes ds); about 8 f32 operations per element
        # for the two softmaxes and the CE terms (exp and log counted as one)
        bounds = {"distill_loss": bound_us(2 * xb + 4, 8 * 2 * numel),
                  "distill_grad": bound_us(3 * xb + 4, 8 * 2 * numel)}
        plans = dict(zip(("distill_loss", "distill_grad"), distill_plans(*pairs[0])))
        require(all(p.vec for p in plans.values()),
                f"the path's shape {shape} must take the 16-byte copies: {plans}")
        for name in ("distill_loss", "distill_grad"):
            dev, call = t[name]
            print(f"distill shape={shape} bf16 {name}: device {dev:.2f} us (call "
                  f"{call:.2f}) bound {bounds[name][0]:.2f} us by {bounds[name][1]} share "
                  f"{bounds[name][0] / dev:.2f}, plain {t[name + '_plain'][0]:.2f} us (call "
                  f"{t[name + '_plain'][1]:.2f}) | plan {plans[name].describe()} | card={card}",
                  flush=True)
            site = {"shape": list(shape), "ms": dev / 1e3,
                    "plain_ms": t[name + "_plain"][0] / 1e3,
                    "bound_ms": bounds[name][0] / 1e3, "bound_by": bounds[name][1],
                    "library_ms": None, "call_ms": call / 1e3, "plan": plans[name].describe()}
            if shape == DISTILL_SHAPE:
                per_kernel[name] = {**site, "sites": []}
            per_kernel[name]["sites"].append(site)
        del pairs, loss_args, grad_args
    return per_kernel


def _cudnn_depthwise(x, wt, d):
    return F.conv2d(x, wt, padding=d, dilation=d, groups=x.shape[1])


def _cudnn_depthwise_wgrad(x, dy, d):
    return torch.nn.grad.conv2d_weight(x, (x.shape[1], 1, 3, 3), dy, padding=d, dilation=d,
                                       groups=x.shape[1])


def _aten(fn):
    """``fn`` with cuDNN off: ATen's own depthwise kernels."""
    def call(*args):
        with torch.backends.cudnn.flags(enabled=False):
            return fn(*args)
    return call


def phase_depthwise_timing(card: str, yardsticks: bool = True) -> dict:
    """Device µs of the head's depthwise kernels at training's sites in bf16
    (the forward, the input gradient on the same kernel, the weight
    gradient with its fold) against their byte bounds (x read and y
    written; x and dy read), and with ``yardsticks`` the plain versions
    and, as yardsticks the port never calls, cuDNN's call as the path
    made it before (``cudnn.benchmark`` on) and ATen's own depthwise
    kernels (cuDNN off).  A kernel's row is the student's site, batch 6
    at dilation 18."""
    sites = {"depthwise_fwd": [], "depthwise_wgrad": []}
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for shape in DEPTHWISE_TRAIN_SHAPES:
            for d in DEPTHWISE_DILATIONS:
                sets = [depthwise_inputs(shape, torch.bfloat16, seed=500 + i) for i in range(2)]
                fwd_args = [(x, wt, d) for x, wt, _ in sets]
                dgrad_args = [(dy, wt, d, True) for _, wt, dy in sets]
                wgrad_args = [(x, dy, d) for x, _, dy in sets]
                t = {"depthwise_fwd": time_us(DW.depthwise_conv3x3_kernel, fwd_args),
                     "depthwise_dgrad": time_us(DW.depthwise_conv3x3_kernel, dgrad_args),
                     "depthwise_wgrad": time_us(DW.depthwise_wgrad_kernel, wgrad_args)}
                if yardsticks:
                    t.update({
                        "depthwise_fwd_plain": time_us(DW.depthwise_conv3x3_plain, fwd_args, 20),
                        "depthwise_wgrad_plain": time_us(DW.depthwise_wgrad_plain, wgrad_args, 20),
                        "depthwise_fwd_cudnn": time_us(_cudnn_depthwise, fwd_args, 20),
                        "depthwise_wgrad_cudnn": time_us(_cudnn_depthwise_wgrad, wgrad_args, 20),
                        "depthwise_fwd_aten": time_us(_aten(_cudnn_depthwise), fwd_args, 20),
                        "depthwise_wgrad_aten": time_us(_aten(_cudnn_depthwise_wgrad),
                                                        wgrad_args, 20)})
                numel = math.prod(shape)
                xb = numel * 2
                # 9 multiply-adds an element; bytes: each map once
                bound = bound_us(2 * xb, 18 * numel)
                plan = depthwise_plan(shape, d, torch.bfloat16)
                for name, kernel in (("depthwise_fwd", "depthwise_fwd"),
                                     ("depthwise_dgrad", "depthwise_fwd"),
                                     ("depthwise_wgrad", "depthwise_wgrad")):
                    dev, call = t[name]
                    yard = {k: t.get(f"{kernel}_{k}", (None, None))[0]
                            for k in ("plain", "cudnn", "aten")}
                    extra = " ".join(f"{k} {v:.2f} us" for k, v in yard.items() if v is not None)
                    print(f"depthwise shape={shape} d={d} bf16 {name}: device {dev:.2f} us (call "
                          f"{call:.2f}) bound {bound[0]:.2f} us by {bound[1]} share "
                          f"{bound[0] / dev:.2f} | {extra} | plan {plan.describe()} | "
                          f"card={card}", flush=True)
                    if name == "depthwise_dgrad":
                        continue
                    site = {"shape": list(shape), "dilation": d, "ms": dev / 1e3,
                            "bound_ms": bound[0] / 1e3, "bound_by": bound[1],
                            "plain_ms": yard["plain"] and yard["plain"] / 1e3,
                            "library_ms": yard["cudnn"] and yard["cudnn"] / 1e3,
                            "aten_ms": yard["aten"] and yard["aten"] / 1e3,
                            "call_ms": call / 1e3, "plan": plan.describe()}
                    sites[name].append(site)
                del sets, fwd_args, dgrad_args, wgrad_args
    finally:
        torch.backends.cudnn.benchmark = prev
    row = (list(DEPTHWISE_TRAIN_SHAPES[0]), 18)
    return {name: {**next(s for s in ss if (s["shape"], s["dilation"]) == row), "sites": ss}
            for name, ss in sites.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=str, default=None,
                    help="directory for torch.profiler tables and traces of one eval and "
                         "one warm-up, self-training, DG and translator step, of the "
                         "semiseg eval, warm-up and self-training step, and of the fused "
                         "and unfused self-training steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    # 2. build, and the C host ops against their numpy forms
    phase_build()
    phase_host_ops(card)
    lap("2 build")
    # 3. kernels against their plain versions
    errs = {**phase_kernels_vs_plain(), **phase_distill_vs_plain(), **phase_depthwise_vs_plain()}
    lap("3 checks")
    # 4. tiny models on the card against the CPU
    phase_model_gpu_vs_cpu()
    for stage in ("warmup", "dg", "selftrain"):
        phase_steps_gpu_vs_cpu(stage)
    for stage in ("warmup", "selftrain"):
        phase_steps_gpu_vs_cpu(stage, hrnet=True)
    lap("4 tiny card vs CPU")
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # 4b. profile_step on the warm-up, the process's first profiler use
        counts.update(phase_profile_step(work, card))
        gc.collect()
        torch.cuda.empty_cache()
        lap("4b profile_step")
        # 5. main path: the eval
        counts["evaluate_val"], paths = phase_main_path(work)
        eval_apply, eval_model = build_eval(get_preset(PRESET), paths["wdir"],
                                            torch.device("cuda"))
        img, lbl = check_outputs(eval_apply, paths)
        ms_per_img = phase_eval_timing(eval_apply, img, lbl, card)
        if args.profile:
            phase_profile(eval_apply, img, lbl, ms_per_img, args.profile)
        del eval_apply, eval_model, img, lbl
        gc.collect()
        torch.cuda.empty_cache()
        lap("5 eval")
        # 6. main path: the warm-up train step
        counts["train_warm_up"], data_paths = phase_train_main_path(work)
        gc.collect()
        torch.cuda.empty_cache()
        warm_timing = phase_train_timing(PRESET, data_paths, card, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
        lap("6 warm-up")
        # 6b. the loader alone, to_device, and the loop through device_prefetch
        phase_prefetch(data_paths, card)
        gc.collect()
        torch.cuda.empty_cache()
        lap("6b prefetch")
        # 7. main paths: the self-training chain and DG
        chain_counts, chain = phase_chain_main_paths(work, data_paths)
        counts.update(chain_counts)
        gc.collect()
        torch.cuda.empty_cache()
        phase_pseudolabel_timing(chain["warm"], chain["data"], card)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_timing(SELFTRAIN_PRESET, chain["data"], card, args.profile,
                           load_weight_dir=chain["warm"], centroid_path=chain["centroid_path"])
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_timing(DG_PRESET, chain["data"], card, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
        phase_make_viz(work, chain)
        lap("7 self-training chain, DG, make_viz")
        # 7b. fused self-training (CLI and timing), parity_check against the replay
        counts.update(phase_fused_selftrain(work, chain))
        gc.collect()
        torch.cuda.empty_cache()
        phase_fused_timing(SELFTRAIN_PRESET, chain["data"], card, args.profile, 6,
                           load_weight_dir=chain["warm"], centroid_path=chain["centroid_path"])
        gc.collect()
        torch.cuda.empty_cache()
        counts.update(phase_parity_check(chain["warm"], paths, card))
        gc.collect()
        torch.cuda.empty_cache()
        lap("7b fused self-training, parity_check")
        # 8. main paths: SYNTHIA->Cityscapes and a --parity warm-up
        synthia_counts, synthia_paths = phase_synthia_chain(work, paths, data_paths)
        counts.update(synthia_counts)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_timing(SYNTHIA_PRESET, synthia_paths, card, None)
        gc.collect()
        torch.cuda.empty_cache()
        lap("8 SYNTHIA, --parity")
        # 8b. main paths: the translator stage and the resume
        counts.update(phase_translator(work, data_paths, synthia_paths, card, args.profile))
        gc.collect()
        torch.cuda.empty_cache()
        counts.update(phase_resume(work, data_paths))
        gc.collect()
        torch.cuda.empty_cache()
        lap("8b translator, resume")
        # 8c. main paths: the semi-supervised Cityscapes chain (HRNet-W48+OCR)
        counts.update(phase_semiseg(work, card, args.profile))
        lap("8c semiseg")
        # 8d. the soaks: onchip warm-up, DG on fixtures, onchip translator
        counts.update(phase_soak(work, card))
        gc.collect()
        torch.cuda.empty_cache()
        lap("8d soaks")
        # 8e. data-parallel training: a world of one NCCL rank, the dryrun twin
        counts.update(phase_parallel(work, data_paths, card, warm_timing))
        gc.collect()
        torch.cuda.empty_cache()
        lap("8e data-parallel")
        # 8f. the height-sharded eval: local shards on this card, the CLI's world of one
        counts.update(phase_spatial(work, paths, card))
        gc.collect()
        torch.cuda.empty_cache()
        lap("8f height-sharded eval")
    gc.collect()
    torch.cuda.empty_cache()
    # 9. kernel timing and the record lines
    per_kernel = {**phase_gn_timing(card), **phase_distill_timing(card),
                  **phase_depthwise_timing(card)}
    lap("9 kernel timing")
    for path, c in counts.items():
        # no TPU kernel on the translator stage, nor on HRNet+OCR's eval
        # paths (run_path holds them at 0)
        if path in TRANSLATOR_PATHS + SEMISEG_EVAL_PATHS + (SPATIAL_HRNET_PATH,):
            continue
        used = [k for k, (_, src, _) in TPU_KERNELS.items()
                if (src.endswith("distill.cu") and path in TRAIN_PATHS + SEMISEG_TRAIN_PATHS)
                or (src.endswith("group_norm.cu") and path not in SEMISEG_TRAIN_PATHS)]
        require(all(c[k] > 0 for k in used), f"a kernel of the {path} path never launched: {c}")
    kernels = []
    for kname, (kid, source, replaces) in TPU_KERNELS.items():
        kernels.append({"name": kname, "id": kid, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(c[kname] for c in counts.values()),
                        "launches_by_path": {p: c[kname] for p, c in counts.items()},
                        "max_abs_err": errs[kname], **per_kernel[kname]})
    for kname, (kid, source, serves) in PORT_ONLY_KERNELS.items():
        kernels.append({"name": kname, "id": kid, "route": "cuda", "source": source,
                        "replaces": None, "serves": serves,
                        "launches": sum(c.get(kname, 0) for c in counts.values()),
                        "max_abs_err": errs[kname], **per_kernel[kname]})
    print(f"total chip_smoke time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
