"""A train cell: the stage's step driven in a closed loop, then checked.

Set-up builds the one train state and step (``build_experiment``), loads
the benchmark's seeded weights into the student, its teacher copy and the
frozen translator, seeds the dropout generators, makes the traffic, and
drives the step through its first ``checked_steps`` steps with the
window's own call and feed, on batches that all differ, reading what the
comparison needs (each step's loss, the first update from the program's
optimizer state as the recipe's optimizer module reads it, each leaf's
change); then ``warmup_steps`` more.  The window runs
the same step on the same state for ``seconds``, closed loop, and ends in
a device synchronise.  After the window (and the traced sub-window, with
``--trace 1``) the peak memory is read, the program's state is freed, and
the reference runs the checked steps from the same weights and inputs.
"""

from __future__ import annotations

import time

import torch

from .. import reference
from ..reference.train import run_steps
from . import compare, counts, program, traffic as traffic_mod
from .device import free, peak_bytes, sync
from .seeds import streams
from .weights import load_exact, seeded_state, shapes_of


def _meta_shapes(build) -> dict:
    with torch.device("meta"):
        return shapes_of(build())


class Inputs:
    """The seeded weights and traffic of one run, made on the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        r = traffic["recipe"]
        self.recipe, self.sd = r, streams(seed)
        self.weights = seeded_state(_meta_shapes(lambda: reference.build_model(config)),
                                    self.sd["weights"], device, reference.weight_rule(config))
        self.translator = None
        if r["translator"]:
            self.translator = seeded_state(
                _meta_shapes(lambda: reference.build_translator(config)),
                self.sd["translator"], device)
        self.pool = traffic_mod.train_pool(traffic, r["num_classes"], self.sd["data"], device)
        self.draws = traffic_mod.train_draws(traffic, r, self.pool, self.sd["draws"], device)
        self.dropout = (self.sd["dropout_student"], self.sd["dropout_teacher"])

    def batch(self, i: int) -> dict:
        return self.pool[i % len(self.pool)]

    def kwargs(self, i: int) -> dict:
        d = self.draws[i % len(self.draws)]
        kw = {"photometric_draws": d["photometric"]}
        if self.recipe["translator"]:
            kw["selection"] = d["selection"]
        return kw


def load_program(state, inputs: Inputs) -> None:
    load_exact(state.student, inputs.weights, "the program's student")
    load_exact(state.teacher, inputs.weights, "the program's teacher")
    if inputs.translator is not None:
        load_exact(state.translator, inputs.translator, "the program's translator")
    state.gen_student_dropout.manual_seed(inputs.dropout[0])
    state.gen_teacher_dropout.manual_seed(inputs.dropout[1])


def _norms(tensors) -> list[float]:
    return torch.stack([t.float().norm() for t in tensors]).tolist() if tensors else []


def first_steps(state, step, inputs: Inputs, n: int) -> dict:
    """Drive ``step`` through its first ``n`` steps; the program's readings."""
    opt = reference.optimizer(inputs.recipe)
    named = [(k, p) for k, p in state.student.named_parameters() if p.requires_grad]
    theta0 = [p.detach().clone() for _, p in named]
    stats = [(k, b) for k, b in state.student.named_buffers()
             if k.endswith(("running_mean", "running_var"))]
    stats0 = [b.detach().clone() for _, b in stats]
    losses, first = [], {}
    for i in range(n):
        losses.append(step(state, inputs.batch(i), **inputs.kwargs(i))["loss"])
        if i == 0:
            ups = [opt.program_first_update(state.optimizer.state.get(p, {})) for _, p in named]
            have = [(k, u) for (k, _), u in zip(named, ups) if u is not None]
            first = dict(zip((k for k, _ in have), _norms([u for _, u in have])))
    with torch.no_grad():
        change = _norms([p - p0 for (_, p), p0 in zip(named, theta0)])
        stats_change = _norms([b - b0 for (_, b), b0 in zip(stats, stats0)])
    return {"loss": [float(x) for x in losses], "first_update": first,
            "change": dict(zip((k for k, _ in named), change)),
            "stats_change": dict(zip((k for k, _ in stats), stats_change))}


def reference_readings(config: dict, inputs: Inputs, n: int, device,
                       precision: str = "f32") -> dict:
    """The reference's checked steps from the same weights and inputs."""
    with torch.device("meta"):
        model = reference.build_model(config)
        translator = reference.build_translator(config) if inputs.translator else None
    model = model.to_empty(device=device)
    model.load_state_dict(inputs.weights, strict=True)
    if translator is not None:
        translator = translator.to_empty(device=device)
        translator.load_state_dict(inputs.translator, strict=True)
        translator.requires_grad_(False).eval()
    out = run_steps(model, translator, inputs.recipe, [inputs.batch(i) for i in range(n)],
                    [inputs.draws[i % len(inputs.draws)] for i in range(n)], inputs.dropout,
                    precision)
    del model, translator
    return out


def kernel_sites(config: dict, traffic: dict) -> dict:
    r, b, hw = traffic["recipe"], traffic["source_batch"], traffic["crop_hw"]
    distill = [(2 * b, *hw, r["num_classes"])] * (2 if r["aux_weight"] > 0 else 1)
    # B2 runs where no gradient is taken: the teacher's forward on [source; view]
    return {"distill": distill, "gn": counts.group_norm_inputs(config, 2 * b, hw)}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    from .metrics import Context, elem_bytes, read_all
    from .peaks import for_device
    from .trace import Scopes, run_traced

    tr = cell.traffic
    n_check = tr["checked_steps"]
    state, step = program.build_train(cell.config, tr, device)
    inputs = Inputs(cell.config, tr, seed, device)
    load_program(state, inputs)
    prog = first_steps(state, step, inputs, n_check)
    i = n_check
    for _ in range(tr["warmup_steps"]):
        step(state, inputs.batch(i), **inputs.kwargs(i))
        i += 1
    sync(device)
    setup_s = time.perf_counter() - t0

    losses, n = [], 0
    start = time.perf_counter()
    while True:
        losses.append(step(state, inputs.batch(i), **inputs.kwargs(i))["loss"])
        i += 1
        n += 1
        if time.perf_counter() - start >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - start
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    steps_per_s = n / window_s

    out = {"attempted": n, "failed": failed, "window_s": window_s,
           "end_to_end": {tr["rate_metric"]: tr["source_batch"] * steps_per_s,
                          "setup_s": setup_s}}
    if trace:
        base = i
        t = run_traced(lambda j: step(state, inputs.batch(base + j), **inputs.kwargs(base + j)),
                       tr["trace_steps"], device,
                       Scopes.of(cell.config, reference.optimizer(tr["recipe"])))
        ctx = Context(trace=t, units_per_s=steps_per_s,
                      unit_flops=counts.train_step_flops(cell.config, tr),
                      peaks=for_device(torch.cuda.get_device_name(device)),
                      kernel_sites=kernel_sites(cell.config, tr),
                      elem_bytes=elem_bytes(cell.config))
        out["per_layer"] = read_all(cell.per_layer, ctx)
        out["trace"] = t
    out["memory_peak_bytes"] = peak_bytes(device)
    del state, step, losses
    free(device)
    t_ref = time.perf_counter()
    ref = reference_readings(cell.config, inputs, n_check, device)
    out["reference_s"] = time.perf_counter() - t_ref
    out["readings"] = compare.train_readings(prog, ref)
    return out
