"""Structured metric logging: JSONL, a stdout mirror and the curve PNGs.

The port's own copy of ``diga_tpu/utils/logging.py::MetricLogger``
(:17-70): every logged value is also kept in ``history``, and ``plot()``
renders each series with at least two points as
``<log_dir>/<key>.png`` (``val/miou`` as ``val_miou.png``), the
reference's loss and mIoU curves.  Where matplotlib is missing,
``plot()`` does nothing.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.history: dict[str, list[tuple[int, float]]] = defaultdict(list)
        self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, prefix: str = "") -> dict:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            rec[f"{prefix}{k}"] = float(v)
            self.history[f"{prefix}{k}"].append((int(step), float(v)))
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        return rec

    @staticmethod
    def print(step: int, metrics: dict) -> None:
        parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        print(f"step {step}: {parts}", flush=True)

    def plot(self) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        for key, series in self.history.items():
            if len(series) < 2:
                continue
            xs, ys = zip(*series)
            plt.figure(figsize=(6, 4))
            plt.plot(xs, ys, label=key)
            plt.grid(True)
            plt.legend()
            plt.title(key)
            plt.savefig(os.path.join(self.log_dir, f"{key.replace('/', '_')}.png"))
            plt.close()

    def close(self) -> None:
        self._file.close()
