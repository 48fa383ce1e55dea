"""The port's evaluate_val CLI against the JAX package's, and the port's imports.

Both CLIs score the same synthetic Cityscapes fixture with the same
``student.pth``, written from a JAX init through ``segmodel_to_torch``;
the tiny preset is registered in both preset registries.  The port runs
with ``--device cpu`` (its plain PyTorch path) and JAX on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import diga_tpu.cli.evaluate_val as jax_cli
from diga_tpu.configs import presets as jax_presets
from diga_tpu.data import synthetic
from diga_tpu.models.convert import segmodel_to_torch
from diga_tpu.utils.checkpoint import export_role_keyed
import diga_tpu_torch.cli.evaluate_val as port_cli
from diga_tpu_torch.configs import presets as port_presets

from _torch_port_common import LAYERS, jax_tiny_deeplab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_HW, DS_HW = (40, 72), (20, 36)


def _tiny(presets):
    base = presets.get_preset("gta2city_warmup")
    return dataclasses.replace(
        base,
        train=dataclasses.replace(base.train, crop_hw=(32, 64),
                                  compute_dtype="float32", remat=False),
        eval=presets.EvalConfig(out_hw=OUT_HW, ds_hw=DS_HW),
        extra={"layers": LAYERS},
    )


@pytest.fixture()
def fixture_args(tmp_path, monkeypatch):
    root = str(tmp_path / "city")
    val_img, val_lbl = synthetic.make_cityscapes_fixture(
        root, n=2, h=OUT_HW[0], w=OUT_HW[1], split="val")
    _, params, stats = jax_tiny_deeplab(seed=21, hw=OUT_HW)
    wdir = str(tmp_path / "weights")
    export_role_keyed(wdir, {"student": segmodel_to_torch(params, stats, LAYERS)})
    monkeypatch.setitem(jax_presets.PRESETS, "tiny_eval", _tiny(jax_presets))
    monkeypatch.setitem(port_presets.PRESETS, "tiny_eval", _tiny(port_presets))
    return ["--preset", "tiny_eval", "--weight_dir", wdir, "--eval_limit", "2",
            "--target_root", root, "--val_img_list", val_img, "--val_lbl_list", val_lbl]


def test_evaluate_val_matches_jax_cli(fixture_args, tmp_path):
    dump_port, dump_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    ours = port_cli.main([*fixture_args, "--device", "cpu", "--dump_preds", dump_port])
    ref = jax_cli.main([*fixture_args, "--dump_preds", dump_jax])
    assert set(ours) == set(ref) == {"cityscapes"}
    assert set(ours["cityscapes"]) == set(ref["cityscapes"])
    for k, v in ref["cityscapes"].items():
        np.testing.assert_allclose(ours["cityscapes"][k], v, rtol=1e-6, err_msg=k)
    names = sorted(os.listdir(dump_jax))
    assert sorted(os.listdir(dump_port)) == names and len(names) == 2
    for n in names:
        a = np.array(Image.open(os.path.join(dump_port, n)))
        b = np.array(Image.open(os.path.join(dump_jax, n)))
        assert a.shape == b.shape == OUT_HW
        assert (a != b).mean() < 1e-3


def test_evaluate_val_defaults_to_the_card(fixture_args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(fixture_args)


@pytest.mark.parametrize("flags", [["--n_devices", "0"], ["--multihost"],
                                   ["--shard", "spatial"]])
def test_multi_device_flags_are_refused(fixture_args, flags, capsys):
    """A world of no rank, ``--multihost`` outside torchrun's environment
    and the height-sharded eval (ROADMAP A15b) are refused; ``--n_devices
    2`` runs (tests/test_torch_port_parallel_cli.py)."""
    with pytest.raises(SystemExit):
        port_cli.main([*fixture_args, "--device", "cpu", *flags])
    assert {"--n_devices": "at least 1", "--multihost": "torchrun",
            "--shard": "A15b"}[flags[0]] in capsys.readouterr().err


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diga_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(diga_tpu_torch.__path__, 'diga_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0].startswith('jax')"
        " or m.split('.')[0] in ('flax', 'optax', 'orbax')"
        " or m == 'diga_tpu' or m.startswith('diga_tpu.'))\n"
        "new = {'diga_tpu_torch.ops.subpixel', 'diga_tpu_torch.models.vgg',"
        " 'diga_tpu_torch.train.steps_translator', 'diga_tpu_torch.cli.train_domain_translator',"
        " 'diga_tpu_torch.data.prefetch', 'diga_tpu_torch.utils.visualize',"
        " 'diga_tpu_torch.utils.synth', 'diga_tpu_torch.utils.profiling',"
        " 'diga_tpu_torch.cli.profile_step', 'diga_tpu_torch.models.torch_replay',"
        " 'diga_tpu_torch.cli.parity_check', 'diga_tpu_torch.cli.make_lists',"
        " 'diga_tpu_torch.utils.native', 'diga_tpu_torch.ops.extras',"
        " 'diga_tpu_torch.cli.soak', 'diga_tpu_torch.cli.make_viz',"
        " 'diga_tpu_torch.parallel.dist', 'diga_tpu_torch.parallel.sync_bn',"
        " 'diga_tpu_torch.parallel.dryrun'}\n"
        "print(len(mods), bad, sorted(new - set(mods)))\n"
        "sys.exit(1 if bad or new - set(mods) or len(mods) < 50 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
