"""Device ms a step charged to model_fwd + model_bwd: the device ops under the
spans that the configuration's ``program_scope`` names (the model's class,
``models/*.py``), and their backward, by ``harness/trace.py``'s rule."""

from benchmark.harness.metrics import Context, component_ms


def read(ctx: Context):
    return component_ms(ctx, ("model_fwd", "model_bwd"))
