"""The manifest, the files it names, and the contract's result line."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import run
from benchmark.harness import manifest
from benchmark.harness.trace import Trace

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = manifest.resolve(name, M)
    assert cell.config["name"] == next(w["config"] for w in M["workloads"] if w["name"] == name)
    assert cell.traffic["kind"] in ("train", "eval")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert os.path.exists(os.path.join(manifest.METRICS_DIR, f"{m['name']}.py"))
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_config_files_lie_under_paths_and_are_distinct():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in M["paths"])
        assert os.path.exists(os.path.join(manifest.ROOT, f))


def test_unknown_workload_is_refused():
    with pytest.raises(manifest.ManifestError, match="unknown workload"):
        manifest.resolve("no_such_cell", M)


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    rc = run.main(["--workload", CELLS[0], "--seed", str(2**31 + 5), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no result" in out.err


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    cell = manifest.resolve(CELLS[0], M)
    t = Trace(units=2, window_s=1.0, busy_s=0.9, device_ops=[], components={},
              program_spans_s={}, top_ops=[["k", 0.5]],
              idle_gaps=[["cudaStreamSynchronize", 0.1]])
    out = {"attempted": 10, "failed": 0, "memory_peak_bytes": 123,
           "end_to_end": {"train_imgs_per_s": 15.0, "setup_s": 20.0},
           "per_layer": {"mfu.train": {"value": 11.0, "unit": "%"}}, "trace": t}
    checks = {"loss_gap": {"value": 1e-3, "limit": 1e-2}}
    line = run.result_line(cell, out, True, checks, trace, "NVIDIA H100 80GB HBM3", "700 W")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert line["device"]["busy_s"] == 0.9 and line["device"]["window_s"] == 1.0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"train_imgs_per_s", "setup_s"}
    json.dumps(line)


def test_bounds_and_names_keep_to_the_contract():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for m in M["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in M[group]]
        assert len(set(names)) == len(names) and all(name.match(n) for n in names)
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) < 64 * 1024
