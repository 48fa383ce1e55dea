"""1 - the union of device-busy intervals over the traced window's wall time, %."""

from benchmark.harness.metrics import Context, idle_share


def read(ctx: Context):
    return idle_share(ctx)
