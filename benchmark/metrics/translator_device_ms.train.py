"""Device ms a step charged to translator_fwd (models/translator.py)."""

from benchmark.harness.metrics import Context, component_ms


def read(ctx: Context):
    return component_ms(ctx, ("translator_fwd",))
