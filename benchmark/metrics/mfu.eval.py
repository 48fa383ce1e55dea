"""FLOPs the unit needs (benchmark/harness/counts.py, on the reference's
architectures) x units a second of the untraced window, over the dense bf16 peak, %."""

from benchmark.harness.metrics import Context, mfu


def read(ctx: Context):
    return mfu(ctx)
