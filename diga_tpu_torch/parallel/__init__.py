"""Data-parallel training over processes (``dist``), the synced BatchNorm
(``sync_bn``), the one-step-per-family check over a world (``dryrun``),
and the height-sharded eval (``spatial``: the row layout and transports;
``spatial_ops``: the sharded ops)."""

from .dist import (active, all_reduce_grads, batch_segments, broadcast_module, draw_local,
                   gather_rows, is_writer, launch, mean_metrics, rank, world)
from .sync_bn import SyncBatchNorm2d, convert_sync_bn

__all__ = ["active", "all_reduce_grads", "batch_segments", "broadcast_module", "draw_local",
           "gather_rows", "is_writer", "launch", "mean_metrics", "rank", "world",
           "SyncBatchNorm2d", "convert_sync_bn"]
