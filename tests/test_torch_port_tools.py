"""The port's checking and profiling tools and the loop's extras (CPU).

* ``models/torch_replay.py`` is the JAX package's replay oracle: the same
  ops on a seeded tiny state_dict give equal tensors;
* ``cli/parity_check.py`` on a tiny DeepLabV2 preset and synthetic val
  images: the activation difference below 1e-4, no pixel disagreement and
  no confusion gap against the replay, a perturbed weight breaks the gate
  (``SystemExit``), an HRNet preset is refused with its reason, and
  without ``--device cpu`` it raises here;
* ``cli/make_lists.py`` writes the JAX CLI's lists for every dataset kind;
* ``utils/profiling.op_category`` maps CUDA kernel names into families,
  the port's kernels by name, and a report renders them; ``cli/profile_step``
  prints the no-device-ops line on the CPU and refuses ``--hlo_out``;
* ``run_training``'s ``viz_every`` grids are ``diga_tpu.utils.visualize``'s
  for the same batch, ``profile_steps`` writes a trace under
  ``<work_dir>/profile``, the loss curves are PNGs beside
  ``metrics.jsonl``, and a new best mIoU with no ``on_best`` writes no
  ``weights/`` (the CLI's ``on_best`` writes ``weights/`` and
  ``ckpt_best/``: ``tests/test_torch_port_train_cli.py``).
"""

import dataclasses
import filecmp
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

import diga_tpu.cli.make_lists as jax_make_lists
from diga_tpu.models.torch_replay import segmodel_forward_torch as jax_replay
from diga_tpu.utils import visualize as jax_visualize
import diga_tpu_torch.cli.make_lists as make_lists
import diga_tpu_torch.cli.parity_check as parity_check
import diga_tpu_torch.cli.profile_step as profile_step
from diga_tpu_torch.cli.common import apply_overrides, base_parser
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.models.torch_replay import segmodel_forward_torch
from diga_tpu_torch.train import loop
from diga_tpu_torch.train.build import build_experiment
from diga_tpu_torch.train.state import reference_state_dict
from diga_tpu_torch.utils import visualize
from diga_tpu_torch.utils.checkpoint import export_role_keyed
from diga_tpu_torch.utils.logging import MetricLogger
from diga_tpu_torch.utils.profiling import op_category, report_from_events

CPU = torch.device("cpu")
HW = (40, 72)
LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    these small models' many small ops only contend across more."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the replay oracle and parity_check
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def student_dir(tmp_path_factory):
    """A tiny reference-layout student.pth: a seeded init with every 1-D
    tensor (BN/GN affine, BN statistics) moved off its init value."""
    rng = np.random.default_rng(41)
    torch.manual_seed(41)
    sd = {}
    for k, v in reference_state_dict(DeepLabV2(19, LAYERS)).items():
        if v.ndim == 1:
            v = v + torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)) * 0.1
            v = v.abs() if "running_var" in k else v
        sd[k] = v
    wdir = str(tmp_path_factory.mktemp("parity") / "weights")
    export_role_keyed(wdir, {"student": sd})
    return wdir


def test_replay_copy_equals_the_jax_packages(student_dir):
    sd = torch.load(os.path.join(student_dir, "student.pth"))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 3, *HW)).astype(np.float32))
    with torch.no_grad():
        ours, theirs = segmodel_forward_torch(sd, x, LAYERS), jax_replay(sd, x, LAYERS)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    train_sd = {k: v.clone() for k, v in sd.items()}
    ref_sd = {k: v.clone() for k, v in sd.items()}
    with torch.no_grad():
        a = segmodel_forward_torch(train_sd, x, LAYERS, training=True)[0]
        b = jax_replay(ref_sd, x, LAYERS, training=True)[0]
    assert torch.equal(a, b)
    assert all(torch.equal(train_sd[k], ref_sd[k]) for k in sd)
    assert not torch.equal(train_sd["layer0.1.running_mean"], sd["layer0.1.running_mean"])


@pytest.fixture(scope="module")
def parity_argv(tmp_path_factory, student_dir):
    root = str(tmp_path_factory.mktemp("parity_val"))
    val_img, val_lbl = synthetic.make_cityscapes_fixture(root, n=2, h=HW[0], w=HW[1],
                                                         split="val")
    base = presets.get_preset("gta2city_warmup")
    tiny = dataclasses.replace(
        base, train=dataclasses.replace(base.train, compute_dtype="float32"),
        eval=presets.EvalConfig(out_hw=HW, ds_hw=(20, 36)), extra={"layers": LAYERS})
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(presets.PRESETS, "tiny_parity", tiny)
        yield ["--preset", "tiny_parity", "--weight_dir", student_dir, "--target_root", root,
               "--val_img_list", val_img, "--val_lbl_list", val_lbl, "--eval_limit", "2"]


def test_activation_parity_below_1e4(parity_argv, student_dir):
    cfg = presets.get_preset("tiny_parity")
    assert parity_check.activation_parity(cfg, student_dir, CPU) < 1e-4


def test_two_scale_eval_agrees_with_the_replay(parity_argv, capsys):
    conf_ours, conf_torch, disagree = parity_check.main(
        [*parity_argv, "--vs_torch_replay", "--device", "cpu"])
    assert disagree == 0.0
    assert np.array_equal(conf_ours, conf_torch) and conf_ours.sum() == 2 * HW[0] * HW[1]
    out = capsys.readouterr().out
    assert "activation parity: max |logits_port - logits_torch|" in out
    assert "pixel disagreement vs torch replay = 0.00e+00" in out


def test_a_perturbed_weight_breaks_the_gate(parity_argv, monkeypatch):
    build = parity_check.build_eval

    def perturbed(*a, **kw):
        eval_apply, model = build(*a, **kw)
        with torch.no_grad():
            model.final.head[-1].weight.mul_(-1.0)  # the classifier: every argmax moves
        return eval_apply, model

    monkeypatch.setattr(parity_check, "build_eval", perturbed)
    with pytest.raises(SystemExit, match="gate-1 FAILED"):
        parity_check.main([*parity_argv, "--vs_torch_replay", "--device", "cpu"])


def test_skip_eval_and_the_evaluate_val_path(parity_argv):
    assert parity_check.main([*parity_argv, "--skip_eval", "--device", "cpu"]) is None
    scores = parity_check.main([*parity_argv, "--device", "cpu"])["cityscapes"]
    assert 0.0 <= scores["mean_iou"] <= 1.0


def test_hrnet_presets_are_refused_with_the_reason(student_dir, capsys):
    with pytest.raises(SystemExit):
        parity_check.main(["--preset", "semiseg_1_8_warmup", "--weight_dir", student_dir,
                           "--device", "cpu", "--skip_eval"])
    assert "covers DeepLabV2 only" in capsys.readouterr().err


def test_parity_check_defaults_to_the_card(parity_argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        parity_check.main([*parity_argv, "--skip_eval"])


# ---------------------------------------------------------------------------
# make_lists
# ---------------------------------------------------------------------------

TREES = {
    "cityscapes": ["leftImg8bit/train/aachen/a_000001_leftImg8bit.png",
                   "leftImg8bit/train/bochum/b_000002_leftImg8bit.png",
                   "leftImg8bit/train/aachen/a_000000_leftImg8bit.png",
                   "leftImg8bit/val/frankfurt/f_000003_leftImg8bit.png",
                   "leftImg8bit/val/frankfurt/notes.txt"],
    "gta5": ["images/00002.png", "images/00001.png", "images/sub/00003.jpg", "images/x.txt"],
    "synthia": ["RGB/0000002.png", "RGB/0000001.png"],
    "bdd100k": ["images/val/b2.jpg", "images/val/b1.jpg", "images/val/b3.png"],
    "mapillary": ["validation/images/m1.jpg", "validation/images/m0.jpg"],
}


@pytest.mark.parametrize("dataset", sorted(TREES))
def test_make_lists_writes_the_jax_lists(tmp_path, dataset):
    root = tmp_path / "data"
    for rel in TREES[dataset]:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(b"")
    make_lists.main([dataset, "--root", str(root), "--out", str(tmp_path / "ours")])
    jax_make_lists.main([dataset, "--root", str(root), "--out", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names and sorted(os.listdir(tmp_path / "ours")) == names
    for n in names:
        assert filecmp.cmp(tmp_path / "ours" / n, tmp_path / "jax" / n, shallow=False), n


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

KERNEL_NAMES = {
    "void distill_partial_kernel<__nv_bfloat16>(__nv_bfloat16 const*, long long, int)": "distill",
    "distill_fold_kernel(float const*, int, float, float, float*)": "distill",
    "void distill_grad_kernel<__nv_bfloat16>(...)": "distill",
    "void gn_stats_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int, int, int)": "group_norm",
    "void gn_apply_kernel<__nv_bfloat16>(...)": "group_norm",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64":
        "convolution",
    "sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": "convolution",
    "void cudnn::engines_precompiled::wgrad_alg0_engine_NHWC<__nv_bfloat16, 128>": "convolution",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": "convolution",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm",
    "void gemmSN_TN_kernel<float, 128, 16, 2, 4, 4, 4, true>": "gemm",
    "ampere_sgemm_128x64_nn": "gemm",
    "void cudnn::bn_fw_tr_1C11_singleread<__nv_bfloat16, 512, true, 1, 2, 0>": "batch_norm",
    "void at::native::batch_norm_collect_statistics_channels_last_kernel<float>": "batch_norm",
    "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>":
        "elementwise",
    "void at::native::elementwise_kernel<128, 2, at::native::direct_copy_kernel_cuda>": "copy",
    "Memcpy HtoD (Pinned -> Device)": "copy",
    "Memset (Device)": "copy",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>": "reduce",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>": "reduce",
    "void at::native::upsample_bilinear2d_out_frame<float, float>": "resize",
    "some_unknown_kernel": "other",
}


def test_op_category_maps_cuda_kernel_names():
    got = {name: op_category(name) for name in KERNEL_NAMES}
    assert got == KERNEL_NAMES


def test_report_renders_the_families_and_the_port_kernels():
    from torch.autograd import DeviceType

    def ev(name, us, count, device=DeviceType.CUDA):
        return types.SimpleNamespace(key=name, device_type=device, count=count,
                                     self_device_time_total=us)

    events = [ev("void gn_stats_kernel<__nv_bfloat16>(...)", 30.0, 12),
              ev("void distill_grad_kernel<float>(...)", 240.0, 2),
              ev("sm90_xmma_fprop_implicit_gemm_bf16", 1600.0, 40),
              ev("aten::convolution", 9999.0, 40, DeviceType.CPU)]
    rep = report_from_events(events, n_steps=2, step_ms=1.0)
    assert rep.total_s == pytest.approx(1870e-6)
    assert rep.by_category == {"group_norm": (pytest.approx(30e-6), 12),
                               "distill": (pytest.approx(240e-6), 2),
                               "convolution": (pytest.approx(1600e-6), 40)}
    out = rep.render(top_k=5)
    assert "device op time: 0.94 ms/step (over 2 steps)" in out
    assert "busy share 0.935" in out
    assert "gn_stats_kernel" in out and "distill_grad_kernel" in out
    assert out.index("port kernels") < out.index("top 5 device ops")


@pytest.fixture(scope="module")
def tiny_warmup():
    base = presets.get_preset("gta2city_warmup")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, num_workers=1,
            source_streams=(presets.LoaderSpec("gta5", HW, 1),
                            presets.LoaderSpec("gta5", (48, 80), 1)),
            target_streams=(presets.LoaderSpec("cityscapes", HW, 1),
                            presets.LoaderSpec("cityscapes", (48, 80), 1))),
        train=dataclasses.replace(base.train, crop_hw=(32, 64), compute_dtype="float32",
                                  num_steps=3, eval_every=0),
        eval=presets.EvalConfig(out_hw=HW, ds_hw=(20, 36)), extra={"layers": LAYERS})
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(presets.PRESETS, "tiny_tools_warmup", cfg)
        yield cfg


def test_profile_step_prints_the_no_device_ops_line_on_the_cpu(tiny_warmup, tmp_path, capsys):
    trace_dir = str(tmp_path / "prof")
    rep = profile_step.main(["--preset", "tiny_tools_warmup", "--device", "cpu", "--steps", "1",
                             "--trace_dir", trace_dir])
    assert rep is not None and rep.total_s == 0.0
    assert "no device ops" in capsys.readouterr().out
    assert os.path.exists(os.path.join(trace_dir, "trace.json"))
    assert os.path.getsize(os.path.join(trace_dir, "ops.txt")) > 0


@pytest.mark.parametrize("raw,want", [("true", True), ("False", False), ("TRUE", True),
                                      ("0", 0), ("kornia", "kornia")])
def test_extra_values_parse_capitalised_booleans_as_booleans(raw, want):
    args = base_parser("t").parse_args(["--preset", "gta2city_selftrain",
                                        "--extra", f"fuse_forwards={raw}"])
    assert apply_overrides(presets.get_preset("gta2city_selftrain"), args).extra[
        "fuse_forwards"] == want


def test_profile_step_refuses_hlo_out(tiny_warmup, capsys):
    with pytest.raises(SystemExit):
        profile_step.main(["--preset", "tiny_tools_warmup", "--device", "cpu",
                           "--hlo_out", "x.hlo"])
    assert "--hlo_out" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the loop's extras
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_run(tiny_warmup, tmp_path_factory):
    """3 steps with an eval after each (mIoU fixed at 0.5, then 0.7), grids
    every step, a trace of steps 1-2, no on_best; the grids' inputs recorded."""
    tmp_path = tmp_path_factory.mktemp("loop")
    gta = synthetic.make_gta5_fixture(str(tmp_path / "gta"), n=2, h=HW[0], w=HW[1])
    img, lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=2, h=HW[0], w=HW[1],
                                                 split="train")
    val_img, val_lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=1, h=HW[0],
                                                         w=HW[1], split="val")
    cfg = dataclasses.replace(
        tiny_warmup,
        data=dataclasses.replace(tiny_warmup.data, source_root=str(tmp_path / "gta"),
                                 source_list=gta, target_root=str(tmp_path / "city"),
                                 target_img_list=img, target_lbl_list=lbl,
                                 val_img_list=val_img, val_lbl_list=val_lbl),
        train=dataclasses.replace(tiny_warmup.train, eval_every=1))
    scores = iter([0.5, 0.7])

    class FixedScores(loop.TwoScaleEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            real = self.score.get_scores
            self.score.get_scores = lambda: ({**real()[0], "mean_iou": next(scores)},
                                             real()[1])

    views = []
    dump = loop.dump_train_views

    def recording_dump(out_dir, step, images, labels):
        views.append((step, images, labels))
        dump(out_dir, step, images, labels)

    state, step, eval_apply = build_experiment(cfg, CPU)
    wd = tmp_path / "wd"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "TwoScaleEvaluator", FixedScores)
        mp.setattr(loop, "dump_train_views", recording_dump)
        result = loop.run_training(cfg, state, step, eval_apply, str(wd), CPU, eval_limit=1,
                                   log_every=1, viz_every=1, profile_steps=(1, 2))
    return {"wd": wd, "views": views, "result": result, "tmp": tmp_path}


def test_viz_grids_are_the_jax_packages(loop_run):
    wd, views = loop_run["wd"], loop_run["views"]
    assert [v[0] for v in views] == [0, 1, 2]
    assert sorted(os.listdir(wd / "views")) == [f"{i:05d}_views.jpg" for i in range(3)]
    for step_i, images, labels in views:
        assert images["source"].shape == (2, 32, 64, 3) and labels["label"].shape == (2, 32, 64)
        rows = [visualize.image_unit_rgb(images["source"]), visualize.label_rgb(labels["label"])]
        ref_rows = [jax_visualize.image_unit_rgb(images["source"]),
                    jax_visualize.label_rgb(labels["label"])]
        np.testing.assert_array_equal(visualize.make_grid(rows), jax_visualize.make_grid(ref_rows))
        ref_dir = str(loop_run["tmp"] / "jax_views")
        jax_visualize.dump_train_views(ref_dir, step_i, images, labels)
        name = f"{step_i:05d}_views.jpg"
        assert filecmp.cmp(wd / "views" / name, os.path.join(ref_dir, name), shallow=False)
        assert Image.open(wd / "views" / name).size == (2 * (64 + 4), 2 * (32 + 4))


def test_profile_steps_write_a_trace(loop_run):
    prof = loop_run["wd"] / "profile"
    assert os.path.getsize(prof / "trace.json") > 0 and os.path.getsize(prof / "ops.txt") > 0


def test_loss_and_miou_curves_are_written(loop_run):
    pytest.importorskip("matplotlib")
    pngs = set(os.listdir(loop_run["wd"]))
    assert {"loss.png", "loss_semseg.png", "loss_distil.png", "val_miou.png"} <= pngs


def test_no_on_best_writes_no_weights(loop_run):
    assert loop_run["result"].best_miou == 0.7 and loop_run["result"].best_step == 2
    assert not os.path.exists(loop_run["wd"] / "weights")
    assert not os.path.exists(loop_run["wd"] / "ckpt_best")


def test_plot_without_matplotlib_does_nothing(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib here")
        return real_import(name, *a, **kw)

    logger = MetricLogger(str(tmp_path))
    logger.log(0, {"loss": 1.0})
    logger.log(1, {"loss": 0.5})
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    logger.plot()
    logger.close()
    assert sorted(os.listdir(tmp_path)) == ["metrics.jsonl"]
    assert logger.history["loss"] == [(0, 1.0), (1, 0.5)]
