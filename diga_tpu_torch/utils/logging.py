"""Structured metric logging: JSONL plus a stdout mirror.

The port's own copy of ``diga_tpu/utils/logging.py::MetricLogger``
(:17-70) without the matplotlib curve PNGs.
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, prefix: str = "") -> dict:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 2)}
        rec.update({f"{prefix}{k}": float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        return rec

    @staticmethod
    def print(step: int, metrics: dict) -> None:
        parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        print(f"step {step}: {parts}", flush=True)

    def close(self) -> None:
        self._file.close()
