"""Device ms a step charged to model_fwd + model_bwd (models/resnet_deeplab.py,
models/hrnet_ocr.py), by the scope rule of utils/profiling.py."""

from benchmark.harness.metrics import Context, component_ms


def read(ctx: Context):
    return component_ms(ctx, ("model_fwd", "model_bwd"))
