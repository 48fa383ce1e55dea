"""Device ms a step charged to aug_mix + loss_resize + optimizer_ema + misc
(ops/photometric.py, mixing.py, losses.py, distill.py, ema.py, and the
optimizer: the spans its module names, ``PROGRAM_SPANS``)."""

from benchmark.harness.metrics import Context, component_ms


def read(ctx: Context):
    return component_ms(ctx, ("aug_mix", "loss_resize", "optimizer_ema", "misc"))
