"""Streaming segmentation metrics with an on-device confusion matrix.

Counterpart of ``diga_tpu/ops/metrics.py``.  The histogram update is one
``bincount`` on the device; only the final (n, n) matrix goes to the host
for scoring.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_update(conf: torch.Tensor, label_true: torch.Tensor,
                     label_pred: torch.Tensor, n_class: int) -> torch.Tensor:
    """Add this batch's confusion counts (valid = 0 <= gt < n_class).

    As in the JAX form, a prediction outside [0, n_class) counts nowhere.
    Equivalent to the reference _fast_hist (util/metrics.py:32-37).
    """
    lt = label_true.reshape(-1).to(torch.int64)
    lp = label_pred.reshape(-1).to(torch.int64)
    valid = (lt >= 0) & (lt < n_class) & (lp >= 0) & (lp < n_class)
    # invalid pixels land in one extra bin that is dropped
    idx = torch.where(valid, lt * n_class + lp, n_class * n_class)
    hist = torch.bincount(idx, minlength=n_class * n_class + 1)[: n_class * n_class]
    return conf + hist.reshape(n_class, n_class).to(conf.dtype)


def scores_from_confusion(hist: np.ndarray) -> tuple[dict, dict]:
    """Overall/mean acc, fwavacc, per-class IoU, mIoU (mIoU13 for 16 classes).

    Mirrors runningScore.get_scores (util/metrics.py:43-65) including
    nan-mean over absent classes.
    """
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        mean_iu = np.nanmean(iu)
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    cls_iu = dict(zip(range(len(iu)), iu))
    scores = {
        "overall_acc": acc,
        "mean_acc": acc_cls,
        "fwavacc": fwavacc,
        "mean_iou": mean_iu,
    }
    if len(iu) == 16:
        # SYNTHIA protocol also reports mIoU over 13 classes, excluding
        # wall(3)/fence(4)/pole(5)
        keep = [i for i in range(16) if i not in (3, 4, 5)]
        scores["mean_iou_13"] = float(np.nanmean(iu[keep]))
    return scores, cls_iu


class RunningScore:
    """Streaming confusion-matrix scorer; the update stays on the device."""

    def __init__(self, n_classes: int = 19, device: torch.device | str = "cpu"):
        self.n_classes = n_classes
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        self.confusion = torch.zeros((self.n_classes, self.n_classes),
                                     dtype=torch.int64, device=self.device)

    def update(self, label_true: torch.Tensor, label_pred: torch.Tensor) -> None:
        self.confusion = confusion_update(
            self.confusion, torch.as_tensor(label_true, device=self.device),
            torch.as_tensor(label_pred, device=self.device), self.n_classes)

    def get_scores(self) -> tuple[dict, dict]:
        return scores_from_confusion(self.confusion.cpu().numpy())
