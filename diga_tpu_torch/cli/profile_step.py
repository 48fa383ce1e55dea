"""Profile one preset's train step: the device-time table by op family.

Counterpart of ``diga_tpu/cli/profile_step.py`` (:33-113) on
``torch.profiler``, on one device (``--device``, default ``cuda``):

    python -m diga_tpu_torch.cli.profile_step --preset gta2city_warmup
    python -m diga_tpu_torch.cli.profile_step --preset gta2city_selftrain \\
        --extra fuse_forwards=true --steps 2

It builds the step a train CLI runs (``build_experiment(preset)``, random
weights from the preset's seed), feeds a synthetic batch of the preset's
shapes (``utils/synth.py``), runs two warm-up steps, times ``--steps``
steps without the profiler, traces ``--steps`` more, and prints the
device time per step by op family (convolution, gemm, batch_norm,
elementwise, copy, reduce, resize, and the port's kernels ``distill``
and ``group_norm`` by name), the port's kernels, the top-K ops and the
busy share over the unprofiled ms/step.  The trace (``trace.json``) and
the op table (``ops.txt``) go to ``--trace_dir``.  No dataset needed.  On
the CPU the trace has no device ops and the CLI says so; where the table
cannot be read it prints the profiler's raw table and the trace path.

``--components`` also prints, from the same trace, the device time per
step split into the JAX tool's seven components (``translator_fwd``,
``model_fwd``, ``model_bwd``, ``optimizer_ema``, ``aug_mix``,
``loss_resize``, ``misc``) and ``unmatched``, by the steps'
``record_function`` scopes (``utils/profiling.py::attribute_events``;
on the CPU, the CPU ops' time), with the port's kernels by component and
the largest scopes.  ``--hlo_out`` (XLA's compiled-HLO attribution, which
``--components`` replaces) has no counterpart and is refused.
"""

from __future__ import annotations

import argparse

from .. import resolve_device
from ..configs.presets import get_preset
from ..train.build import build_experiment
from ..utils.profiling import (attribute_events, profile_step, render_components,
                               report_from_events)
from ..utils.synth import synth_batch
from .common import apply_overrides


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--preset", default="gta2city_warmup")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises when no card is present) or 'cpu'")
    p.add_argument("--extra", action="append", default=[], metavar="KEY=VALUE",
                   help="preset extra override (repeatable; JSON values)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top_k", type=int, default=25)
    p.add_argument("--trace_dir", default="./work_dir/profile_step")
    p.add_argument("--components", action="store_true",
                   help="also print the device time split into the JAX tool's components, "
                        "by the steps' record_function scopes")
    p.add_argument("--hlo_out", default=None,
                   help="the JAX tool's compiled-HLO attribution: refused (no XLA here)")
    args = p.parse_args(argv)
    if args.hlo_out is not None:
        p.error("--hlo_out dumps XLA's optimized HLO for the JAX package's attribution; the "
                "port runs no XLA program, so it has no counterpart: --components splits "
                "the same trace by the steps' record_function scopes")
    device = resolve_device(args.device)
    cfg = apply_overrides(get_preset(args.preset), args)
    state, step, _ = build_experiment(cfg, device)
    batch = synth_batch(cfg, device)

    events, step_ms, table, trace = profile_step(lambda: step(state, batch), args.trace_dir,
                                                 device, n_steps=args.steps)
    try:
        rep = report_from_events(events, n_steps=args.steps, step_ms=step_ms)
    except (AttributeError, KeyError, TypeError, ValueError) as e:
        print(f"[the profiler's table could not be read ({type(e).__name__}: {e}); its raw "
              f"table follows, the trace is {args.trace_dir}/trace.json]\n{table}")
        return None
    if args.components:
        rep.components = attribute_events(trace, device.type, n_steps=args.steps)
    if rep.total_s == 0.0:
        print(f"[empty device-op report: no device ops in the trace ({device.type} run, "
              f"{step_ms:.1f} ms/step on the host clock): per-op attribution needs the card; "
              f"the raw trace is {args.trace_dir}/trace.json]")
        if args.components:
            print(f"CPU op time by component:\n{render_components(rep.components)}")
        return rep
    print(f"profile_step {cfg.name} ({cfg.stage}), {args.steps} steps on "
          f"{device.type}:\n{rep.render(top_k=args.top_k)}")
    if args.components:
        print(render_components(rep.components))
    return rep


if __name__ == "__main__":
    main()
