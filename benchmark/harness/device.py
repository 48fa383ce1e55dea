"""The few device calls the cells make, so that a CPU rehearsal of a cell
(the tests) runs the same code; the benchmark itself refuses to run
without a card (``run.py``)."""

from __future__ import annotations

import gc

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
