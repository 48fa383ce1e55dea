"""B2a + B2b (csrc/group_norm.cu) at the eval's two scales: least time over device time, %."""

from benchmark.harness.metrics import Context, kernel_roofline


def read(ctx: Context):
    return kernel_roofline(ctx, "gn")
