"""The plain reference against the port at a tiny size on the CPU, in f32.

The reference is written apart from the port (its own modules, the
published up-block form of the translator's decoder, ``F.group_norm`` and
``F.instance_norm``), so f32 rounding in another order is all that may
differ.  Tolerances: logits 1e-4 of their largest magnitude; in a run of
a tiny cell, loss 1e-5 relative; the worst leaf's update and change 1e-2
of the larger of its norm and the median leaf's (a leaf's gradient sums
thousands of products whose order differs); BN statistics 1e-4.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import reference
from benchmark.harness import eval_cell, train_cell
from benchmark.harness.weights import load_exact, seeded_state, shapes_of
from benchmark.tests.tiny import TINY_HRNET, tiny_cell

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _program_model(kind: str):
    from diga_tpu_torch.models.hrnet_ocr import HRNetOCR
    from diga_tpu_torch.models.resnet_deeplab import DeepLabV2

    if kind == "deeplabv2":
        return DeepLabV2(19, (1, 1, 1, 1))
    return HRNetOCR(19, {**TINY_HRNET, "stages": [(m, b, tuple(c))
                                                 for m, b, c in TINY_HRNET["stages"]]})


@pytest.mark.parametrize("name", ["r101_gta2city_warmup", "hrnet_semiseg_warmup"])
def test_models_agree_in_eval_mode(name):
    cfg = tiny_cell(name).config
    ref = reference.build_model(cfg).eval()
    prog = _program_model(cfg["model"]).eval()
    weights = seeded_state(shapes_of(ref), 7, CPU)
    ref.load_state_dict(weights)
    load_exact(prog, weights, "the port's model")
    x = torch.randn(2, 3, 40, 72, generator=torch.Generator().manual_seed(1)) * 0.5
    with torch.no_grad():
        want = ref(x)[2]
        got = prog(x.contiguous(memory_format=torch.channels_last))[2]
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_translator_agrees_with_the_subpixel_form():
    from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder, translate

    cfg = tiny_cell("r101_gta2city_warmup").config
    ref = reference.build_translator(cfg).eval()
    prog = torch.nn.ModuleDict({"enc_s": ImgEncoder(), "dec_s2t": ImgDecoder(subpixel_up=True)})
    weights = seeded_state(shapes_of(ref), 3, CPU)
    ref.load_state_dict(weights)
    load_exact(prog, weights, "the port's translator")
    x = torch.randn(2, 32, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = translate(prog, x)
    assert (got - want).abs().max() <= 1e-4


@pytest.mark.parametrize("name", ["r101_gta2city_warmup", "hrnet_semiseg_warmup",
                                  "r101_gta5_dg"])
def test_train_cell_runs_and_agrees(name):
    cell = tiny_cell(name)
    out = train_cell.run(cell, 2**31 + 11, 0.5, False, CPU, time.perf_counter())
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["end_to_end"][cell.traffic["rate_metric"]] > 0 and out["end_to_end"]["setup_s"] > 0
    r = out["readings"]
    assert r["loss_gap"] <= 1e-5, r
    assert r["update_gap"] <= 1e-2 and r["change_gap"] <= 1e-2, r
    assert r["stats_gap"] <= 1e-4, r


def test_eval_cell_runs_and_agrees():
    cell = tiny_cell("r101_cityscapes_eval")
    out = eval_cell.run(cell, 2**31 + 13, 0.5, False, CPU, time.perf_counter())
    assert out["attempted"] >= 1
    assert out["readings"]["confusion_diff"] == 0
    assert out["readings"]["logit_gap"] <= 1e-5


def test_same_seed_same_inputs():
    cell = tiny_cell("r101_gta2city_warmup")
    a = train_cell.Inputs(cell.config, cell.traffic, 2**31 + 99, CPU)
    b = train_cell.Inputs(cell.config, cell.traffic, 2**31 + 99, CPU)
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert torch.equal(a.batch(1)["s_img"], b.batch(1)["s_img"])
    assert torch.equal(a.draws[5]["selection"], b.draws[5]["selection"])
    c = train_cell.Inputs(cell.config, cell.traffic, 2**31 + 98, CPU)
    assert not torch.equal(a.batch(0)["s_img"], c.batch(0)["s_img"])
    # four distinct batches: the checked steps see rows that all differ
    imgs = [a.batch(i)["s_img"] for i in range(4)]
    assert all(not torch.equal(imgs[i], imgs[j]) for i in range(4) for j in range(i))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["r101_gta2city_warmup", "r101_cityscapes_eval"])
def test_tiny_cells_on_the_card(name):
    """The same agreement with the port's CUDA kernels (B1, B2) launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    cell = tiny_cell(name)
    runner = train_cell if cell.traffic["kind"] == "train" else eval_cell
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False  # f32 as f32
    try:
        out = runner.run(cell, 2**31 + 17, 0.5, False, torch.device("cuda", 0),
                         time.perf_counter())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    r = out["readings"]
    if cell.traffic["kind"] == "train":
        assert r["loss_gap"] <= 1e-4 and r["update_gap"] <= 1e-2, r
    else:
        assert r["confusion_diff"] == 0 and r["logit_gap"] <= 1e-4, r
