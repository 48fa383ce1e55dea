"""Host batches to the device ahead of the step that reads them.

Counterpart of ``diga_tpu/data/pipeline.py::device_prefetch`` (:115-156)
on one device.  On the card each batch's numpy arrays are pinned and
copied on a dedicated ``torch.cuda.Stream`` while the step before runs;
the consumer's stream waits on that copy (an event) before the batch is
handed out, and every tensor is ``record_stream``'d on the consumer's
stream, so the caching allocator does not reuse its memory while a step
queued there may still read it.  The pinned host copies are released by
PyTorch's caching host allocator only once their copy has run.  On the
CPU the batches are wrapped as CPU tensors (no copy).
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def device_prefetch(iterator: Iterable[dict], device: torch.device | str,
                    buffer_size: int = 2) -> Iterator[dict]:
    """Yield the batches of ``iterator`` (dicts of numpy arrays and other
    values) with every array as a tensor on ``device``, keeping up to
    ``buffer_size`` batches in flight.  Non-array values pass through."""
    device = torch.device(device)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch: dict):
        if copy_stream is None:
            return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                    for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                out[k] = (torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                          if isinstance(v, np.ndarray) else v)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def hand_out(item) -> dict:
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
        return batch

    it = iter(iterator)
    buf: collections.deque = collections.deque()
    for _ in range(buffer_size):
        try:
            buf.append(put(next(it)))
        except StopIteration:
            break
    while buf:
        yield hand_out(buf.popleft())
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
