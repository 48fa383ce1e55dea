"""Share of the model calls the program replayed as CUDA graphs
(train/graphs.py): its ``graph_replay`` spans over its ``graph_replay``
and ``graph_eager`` spans, in %."""

from benchmark.harness.metrics import Context


def read(ctx: Context):
    spans = ctx.trace.program_spans_s
    replayed, eager = len(spans.get("graph_replay", ())), len(spans.get("graph_eager", ()))
    return 100.0 * replayed / (replayed + eager) if replayed + eager else None
