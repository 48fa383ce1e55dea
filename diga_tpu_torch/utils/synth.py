"""Synthetic batches shaped like a preset's real loader output.

Counterpart of ``diga_tpu/utils/synth.py``, for ``cli/profile_step.py``:
the batch a preset's train step reads, with no dataset.  NHWC f32 images
in the normalized range and labels in [0, num_classes), uint8 as the
port's loaders emit them, drawn from the same numpy seed as the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch


def synth_batch(cfg, device: torch.device | str, seed: int = 0) -> dict:
    """A random batch of ``cfg``'s stream shapes on ``device``: ``s_img``,
    ``s_lbl``, and ``t_img`` where the step reads it, ``t_pseudo`` for
    self-training."""
    from ..train.build import wants_target

    rr = np.random.default_rng(seed)
    h, w = cfg.train.crop_hw
    bs = sum(s.batch for s in cfg.data.source_streams)
    bt = sum(s.batch for s in cfg.data.target_streams)
    ncls = cfg.train.num_classes
    batch = {"s_img": rr.normal(size=(bs, h, w, 3)).astype(np.float32) * 0.5,
             "s_lbl": rr.integers(0, ncls, size=(bs, h, w)).astype(np.uint8)}
    if wants_target(cfg):
        batch["t_img"] = rr.normal(size=(bt, h, w, 3)).astype(np.float32) * 0.5
    if cfg.stage == "selftrain":
        batch["t_pseudo"] = rr.integers(0, ncls, size=(bt, h, w)).astype(np.uint8)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
