"""The cells' families and optimizers, found by name, and the reference's
readings through them unchanged.

``aggregates`` runs the reference's first 2 steps of a tiny cell
(``tiny.py``) on the CPU with one torch thread, seed 2**31 + 41, and
reduces each of ``first_update``, ``change`` and ``stats_change`` to the
number of leaves, their sum, least and largest.  ``BEFORE`` holds what it
gave on the tree before the registries, whose ``run_steps`` had the SGD
loop inline and built the two families by name in ``build_model``.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import reference
from benchmark.harness import manifest

SEED = 2**31 + 41
FIELDS = ("first_update", "change", "stats_change")
BEFORE = {
    "r101_gta2city_warmup": {
        "loss": [5.743461608886719, 5.625271797180176],
        "first_update": [46, 64.98916964232922, 0.08625245094299316, 15.750703811645508],
        "change": [46, 0.24483079877973069, 0.00010182503319811076, 0.0717567726969719],
        "stats_change": [34, 136.94434043765068, 0.32630154490470886, 10.773785591125488],
    },
    "hrnet_semiseg_warmup": {
        "loss": [6.577901840209961, 6.412387371063232],
        "first_update": [190, 79.13395203649998, 0.005280544515699148, 6.42338752746582],
        "change": [190, 0.17333254260938702, 1.132701709138928e-05, 0.013970063999295235],
        "stats_change": [124, 144.30984553694725, 0.11935526132583618, 6.422943115234375],
    },
}


def aggregates(name: str) -> dict:
    from benchmark.harness import train_cell
    from benchmark.tests.tiny import tiny_cell

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = tiny_cell(name)
        cpu = torch.device("cpu")
        inputs = train_cell.Inputs(cell.config, cell.traffic, SEED, cpu)
        ref = train_cell.reference_readings(cell.config, inputs, 2, cpu)
    finally:
        torch.set_num_threads(threads)
    out = {"loss": ref["loss"]}
    for f in FIELDS:
        v = list(ref[f].values())
        out[f] = [len(v), sum(v), min(v), max(v)]
    return out


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_readings_hold_through_the_registries(name):
    got, want = aggregates(name), BEFORE[name]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    for f in FIELDS:
        assert got[f][0] == want[f][0], f
        assert got[f][1:] == pytest.approx(want[f][1:], rel=1e-6), f


@pytest.mark.parametrize("name", [w["name"] for w in manifest.load()["workloads"]])
def test_every_cell_names_its_family_scope_and_optimizer(name):
    cell = manifest.resolve(name, manifest.load())
    assert callable(reference.family(cell.config).build)
    assert cell.config["program_scope"]
    if cell.traffic["kind"] == "train":
        opt = reference.optimizer(cell.traffic["recipe"])
        assert opt.PROGRAM_SPANS and opt.PRESET_KEYS


def test_a_recipe_without_an_optimizer_is_refused():
    recipe = dict(manifest.resolve("r101_gta5_dg", manifest.load()).traffic["recipe"])
    assert reference.optimizer(recipe).__name__.endswith(".sgd")
    del recipe["optimizer"]
    with pytest.raises(ValueError, match="names no optimizer"):
        reference.optimizer(recipe)


@pytest.mark.parametrize("model, why", [("no_such_family", "no module"),
                                        ("../deeplab", "expected a module name"),
                                        (None, "expected a module name")])
def test_an_unknown_family_is_refused(model, why):
    with pytest.raises(ValueError, match=why):
        reference.build_model({"model": model})
