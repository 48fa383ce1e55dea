"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's file is the entry of ``configs`` with that name,
the traffic mix is ``benchmark/traffic/<traffic>.json``, and a per-layer
metric is ``benchmark/metrics/<metric>.py``.  Adding a cell, a
configuration, a traffic mix, a metric, a family or an optimizer
(``benchmark/reference/__init__.py``) adds files and entries and edits
none.
"""

from __future__ import annotations

import dataclasses
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
METRICS_DIR = os.path.join(HERE, "metrics")


class ManifestError(ValueError):
    pass


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    chips: int
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        raise ManifestError(f"{os.path.relpath(path, ROOT)} does not exist")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def resolve(name: str, manifest: dict, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise ManifestError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    if w["config"] not in configs:
        raise ManifestError(f"workload {name!r} names an unknown config {w['config']!r}")
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])
