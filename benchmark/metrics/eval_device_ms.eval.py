"""Profiled device ms per image of the two-scale eval (eval/evaluator.py):
both forwards, the resizes, the merge, the argmax and the confusion counts."""

from benchmark.harness.metrics import Context


def read(ctx: Context):
    ops = ctx.trace.device_ops
    return 1e3 * sum(e - s for _, s, e in ops) / 1e6 / ctx.trace.units if ops else None
