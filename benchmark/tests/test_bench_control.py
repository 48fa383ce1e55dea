"""The comparison that decides ``correct`` fails its control and its faults.

At a tiny size on the CPU, with each cell's own limits (its traffic
file's ``limits``): the control (the reference computed in fp8, the
precision below the configurations' bf16, put in the program's place) is
not correct; a sound f32 run of the program is; and a whole run of the
cell with the timed path broken underneath comes out not correct, once
for each fault the cell can have (train: a step that leaves its state
unchanged, half of every batch left out; eval: answers altered where they
are produced, the confusion counts never updated).  The same comparisons
at the cells' own sizes on the card are ``benchmark/readings.py``'s.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import compare, eval_cell, faults, program, train_cell
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
TRAIN = ["r101_gta2city_warmup", "hrnet_semiseg_warmup", "r101_gta5_dg"]
SEED = 2**31 + 21


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _judge(cell, readings) -> bool:
    return compare.judge(readings, cell.traffic["limits"])[0]


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_is_not_correct_and_the_program_is(name):
    cell = tiny_cell(name)
    inputs = train_cell.Inputs(cell.config, cell.traffic, SEED, CPU)
    n = cell.traffic["checked_steps"]
    ref = train_cell.reference_readings(cell.config, inputs, n, CPU)
    low = train_cell.reference_readings(cell.config, inputs, n, CPU, precision="fp8")
    assert not _judge(cell, compare.train_readings(low, ref))
    state, step = program.build_train(cell.config, cell.traffic, CPU)
    train_cell.load_program(state, inputs)
    sound = train_cell.first_steps(state, step, inputs, n)
    assert _judge(cell, compare.train_readings(sound, ref))


def test_eval_control_is_not_correct():
    cell = tiny_cell("r101_cityscapes_eval")
    weights, pool, _ = eval_cell.inputs(cell.config, cell.traffic, SEED, CPU)
    ref = eval_cell.reference_model(cell.config, weights, CPU)
    images = list(range(len(pool)))
    from benchmark.reference.evaluate import two_scale_logits

    tr = cell.traffic
    low = [two_scale_logits(ref, torch.from_numpy(pool[i]["image"]), tr["out_hw"], tr["ds_hw"],
                            "fp8").argmax(-1) for i in images]
    gap = max(eval_cell.gaps(ref, tr, pool, images, low, CPU))
    assert not _judge(cell, {"logit_gap": gap, "confusion_diff": 0.0})


def _halve(v):
    if isinstance(v, dict):
        return {k: _halve(x) for k, x in v.items()}
    return v[: max(1, v.shape[0] // 2)]


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_train_run_with_a_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    build = program.build_train

    def broken(config, traffic, device):
        state, step = build(config, traffic, device)
        if fault == "frozen":
            faults.frozen(state)
            return state, step
        return state, lambda st, batch, **kw: step(st, _halve(batch), **_halve(kw))

    monkeypatch.setattr(program, "build_train", broken)
    out = train_cell.run(cell, SEED, 0.2, False, CPU, time.perf_counter())
    assert not (_judge(cell, out["readings"]) and out["failed"] == 0)


@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_an_eval_run_with_a_fault_is_not_correct(fault, monkeypatch):
    cell = tiny_cell("r101_cityscapes_eval")
    build = program.build_eval

    def broken(config, traffic, device):
        evaluator, model = build(config, traffic, device)
        getattr(faults, fault)(evaluator)
        return evaluator, model

    monkeypatch.setattr(program, "build_eval", broken)
    out = eval_cell.run(cell, SEED, 0.3, False, CPU, time.perf_counter())
    assert not (_judge(cell, out["readings"]) and out["failed"] == 0)


def test_a_sound_eval_run_is_correct():
    cell = tiny_cell("r101_cityscapes_eval")
    out = eval_cell.run(cell, SEED, 0.3, False, CPU, time.perf_counter())
    assert _judge(cell, out["readings"]) and out["failed"] == 0
