"""diga_tpu_torch: the PyTorch/CUDA port of diga_tpu for NVIDIA Hopper (H100).

The JAX package ``diga_tpu`` is the reference; this package computes the
same functions with PyTorch tensor code and, where the reference had a
Pallas kernel, a hand-written CUDA kernel (sources under ``csrc/``).  It
imports nothing of JAX and nothing of ``diga_tpu``.

Layout conventions:
  * at the public functions (``two_scale_logits``, ``TwoScaleEvaluator``,
    ``resize_bilinear``, ``group_norm``, ``distillation_loss``, the
    photometric and mixing ops, the train step's batch) tensors keep the
    reference layout: images are NHWC float, BGR, mean-subtracted and
    divided by 128; labels are (B, H, W) trainIds with 255 = ignore;
    logits are NHWC;
  * inside the model tensors are NCHW in ``torch.channels_last`` memory
    format, so a contiguous NHWC tensor permuted to NCHW is a view with
    no copy, and the kernels read it as it lies.

Entry points run on the CUDA device unless the caller asks for the CPU;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

MEMORY_FORMAT = torch.channels_last  # model-internal NCHW tensors


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; raises if CUDA is asked for and absent.

    Nothing falls back to the CPU: a caller that wants the CPU says so.
    """
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    return device
