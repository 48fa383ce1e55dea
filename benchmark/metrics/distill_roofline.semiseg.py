"""B1a + B1b (csrc/distill.cu): the calls' least time over their profiled device time, %."""

from benchmark.harness.metrics import Context, kernel_roofline


def read(ctx: Context):
    return kernel_roofline(ctx, "distill")
