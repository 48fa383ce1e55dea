"""B2a + B2b (csrc/group_norm.cu) in the teacher's forward: least time over device time, %."""

from benchmark.harness.metrics import Context, kernel_roofline


def read(ctx: Context):
    return kernel_roofline(ctx, "gn")
