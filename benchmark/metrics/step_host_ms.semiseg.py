"""Host ms of the program's ``train_step`` span (train/steps.py), per step."""

from benchmark.harness.metrics import Context


def read(ctx: Context):
    spans = ctx.trace.program_spans_s.get("train_step")
    return 1e3 * sum(spans) / len(spans) if spans else None
