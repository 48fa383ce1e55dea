"""The port's full-state checkpoints, resume and backbone init (CPU).

* N = 3 segmentation steps straight against k = 1 step, a save, a fresh
  ``build_experiment``, ``restore_train_state`` and N − k steps: every
  loss, the student and teacher (BN statistics included), the SGD
  momentum, the step, the generators' states and (self-training) the
  centroids bit for bit equal, for the warm-up (saved in the background
  while the saved state keeps training) and the self-training step (all
  six generators: photometric source and target, CrDoMix, DACS, both
  dropouts);
* ``train_warm_up --resume`` continues from ``<work_dir>/ckpt_final`` with
  one more step, and starts afresh where there is none; ``--save_every``
  saves in the background at every i > 0 divisible by it;
* ``--pretrained_backbone``: a ``ResNetMulti``-layout (Caffe) and a
  ``SegModel``-layout state_dict from seeded numpy arrays laid over a fresh
  model equal JAX's ``segmodel_from_torch`` + ``merge_pretrained_backbone``
  on every key the JAX overlay writes; a head of another class count
  stays at its fresh init; the CLI reads the file.
"""

import dataclasses
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.models.convert import merge_pretrained_backbone, segmodel_from_torch
from diga_tpu.models.resnet_deeplab import DeepLabV2 as JaxDeepLabV2
import diga_tpu_torch.cli.train_seg as train_seg
import diga_tpu_torch.cli.train_warm_up as cli
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.models.convert import state_dict_from_jax
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.train import loop
from diga_tpu_torch.train.build import build_experiment
from diga_tpu_torch.train.state import reference_state_dict
from diga_tpu_torch.utils.checkpoint import (restore_train_state, save_train_state,
                                             wait_for_checkpoints)

LAYERS = (1, 1, 1, 1)
CROP = (32, 64)
K = 19
N, KSTEPS = 3, 1
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the test run has several workers on one host,
    and more threads per worker only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: the checkpoints these
    tests write at the reference translator widths take hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tiny(name, **train):
    base = presets.get_preset(name)
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, num_workers=1,
            source_streams=(presets.LoaderSpec("gta5", (40, 72), 1),
                            presets.LoaderSpec("gta5", (48, 80), 1)),
            target_streams=tuple(dataclasses.replace(s, resize_hw=hw, batch=1) for s, hw in
                                 zip(base.data.target_streams, ((40, 72), (48, 80))))),
        train=dataclasses.replace(base.train, crop_hw=CROP, compute_dtype="float32",
                                  eval_every=0, **train),
        eval=presets.EvalConfig(out_hw=(40, 72), ds_hw=(20, 36)),
        extra={"layers": LAYERS})


def _batch(i, stage):
    rr = np.random.default_rng(50 + i)
    lbl = rr.choice(rr.choice(K, size=6, replace=False), size=(2, *CROP)).astype(np.int32)
    lbl[:, :3] = 255
    b = {"s_img": (rr.normal(size=(2, *CROP, 3)) * 0.5).astype(np.float32), "s_lbl": lbl,
         "t_img": (rr.normal(size=(2, *CROP, 3)) * 0.5).astype(np.float32)}
    if stage == "selftrain":
        pseudo = rr.choice(rr.choice(K, size=4, replace=False), size=(2, *CROP)).astype(np.int32)
        pseudo[:, :, :5] = 255
        b["t_pseudo"] = pseudo
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _snapshot(state) -> dict:
    st = state.state_dict()
    out = {f"{r}|{k}": v.clone() for r in ("student", "teacher")
           for k, v in st["roles"][r].items()}
    out.update({f"gen|{k}": v for k, v in st["state"]["generators"].items()})
    out.update({f"momentum|{i}": v["momentum_buffer"].clone()
                for i, v in st["state"]["optimizer"]["state"].items()})
    if state.centroids is not None:
        out["centroids|vectors"] = state.centroids.vectors.clone()
        out["centroids|counts"] = state.centroids.counts.clone()
    out["step"] = torch.tensor(state.step)
    return out


@pytest.mark.parametrize("stage", ["warmup", "selftrain"])
def test_save_restore_continues_bit_for_bit(stage, tmp_path):
    name = "gta2city_warmup" if stage == "warmup" else "gta2city_selftrain"
    cfg = _tiny(name, num_steps=N)
    centroids = None
    if stage == "selftrain":
        centroids = str(tmp_path / "cents.npy")
        np.save(centroids, np.random.default_rng(3).normal(size=(K, 256)).astype(np.float32))
    state, step, _ = build_experiment(cfg, CPU, centroid_path=centroids)
    assert state.step == 0 and (state.centroids is not None) == (stage == "selftrain")
    ckpt = str(tmp_path / "ckpt")
    straight = []
    for i in range(N):
        if i == KSTEPS:
            # warm-up: written in the background while the state trains on
            save_train_state(ckpt, state, background=stage == "warmup")
            at_save = _snapshot(state)
        straight.append({k: float(v) for k, v in step(state, _batch(i, stage)).items()})
    wait_for_checkpoints()
    assert sorted(os.listdir(ckpt)) == ["dec_s2t.pth", "enc_s.pth", "state.pth", "student.pth",
                                        "teacher.pth"]
    fresh, fresh_step, _ = build_experiment(cfg, CPU, centroid_path=centroids)
    restore_train_state(ckpt, fresh)
    restored = _snapshot(fresh)
    assert restored.keys() == at_save.keys()
    assert all(torch.equal(restored[k], v) for k, v in at_save.items()), "restore != save"
    assert fresh.student.final.head[0].generator is fresh.gen_student_dropout
    assert fresh.teacher.final.head[0].generator is fresh.gen_teacher_dropout
    resumed = [{k: float(v) for k, v in fresh_step(fresh, _batch(i, stage)).items()}
               for i in range(KSTEPS, N)]
    assert resumed == straight[KSTEPS:]
    a, b = _snapshot(state), _snapshot(fresh)
    assert a.keys() == b.keys() and int(b["step"]) == N
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]


@pytest.fixture()
def argv(tmp_path, monkeypatch):
    gta = synthetic.make_gta5_fixture(str(tmp_path / "gta"), n=2, h=40, w=72)
    img, lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=2, h=40, w=72,
                                                 split="train")
    monkeypatch.setitem(presets.PRESETS, "tiny_warmup", _tiny("gta2city_warmup", num_steps=2))
    return ["--preset", "tiny_warmup", "--work_dir", str(tmp_path / "wd"), "--device", "cpu",
            "--source_root", str(tmp_path / "gta"), "--source_list", gta,
            "--target_root", str(tmp_path / "city"), "--target_img_list", img,
            "--target_lbl_list", lbl]


def _count_steps(monkeypatch) -> list:
    """Record each step the CLI takes by the state's counter before it."""
    taken = []
    build = train_seg.build_experiment

    def recording_build(*a, **kw):
        state, step, eval_apply = build(*a, **kw)

        def counted(state, batch):
            taken.append(state.step)
            return step(state, batch)

        return state, counted, eval_apply

    monkeypatch.setattr(train_seg, "build_experiment", recording_build)
    return taken


def test_resume_continues_from_ckpt_final(argv, tmp_path, monkeypatch, capsys):
    taken = _count_steps(monkeypatch)
    final = tmp_path / "wd" / "ckpt_final"
    cli.main([*argv, "--resume"])  # no ckpt_final yet: starts at step 0
    assert taken == [0, 1] and torch.load(final / "state.pth")["step"] == 2
    assert "resumed" not in capsys.readouterr().out
    before = torch.load(final / "student.pth")
    cli.main([*argv, "--resume", "--num_steps", "3"])
    out = capsys.readouterr().out
    assert f"resumed from {final} at step 2" in out
    assert taken == [0, 1, 2]
    assert torch.load(final / "state.pth")["step"] == 3
    after = torch.load(final / "student.pth")
    assert any(not torch.equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize("save_every,saves",
                         [(2, [(3, True)]), (1, [(2, True), (3, True)]), (0, [])])
def test_save_every_saves_in_the_background(argv, monkeypatch, save_every, saves):
    recorded = []
    real = loop.save_train_state

    def recording(path, state, background=False):
        recorded.append((state.step, background))
        assert path.endswith("ckpt_final")
        real(path, state, background=background)

    monkeypatch.setattr(loop, "save_train_state", recording)
    cli.main([*argv, "--num_steps", "3", "--save_every", str(save_every)])
    assert recorded == saves


# ----------------------------------------------------------- backbone init

@pytest.fixture(scope="module")
def jax_fresh():
    """A fresh JAX DeepLabV2 at tiny depth (jitted init)."""
    model = JaxDeepLabV2(num_classes=K, layers=LAYERS, s2b=False)
    k = jax.random.PRNGKey(7)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": k, "dropout": k}, jnp.zeros((1, *CROP, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, v["params"]), \
        jax.tree_util.tree_map(np.asarray, v["batch_stats"])


def _seeded_file(layout: str, num_classes: int, seed: int) -> dict[str, torch.Tensor]:
    """A reference state_dict in ``layout`` from seeded normals: the port's
    keys at layers (2, 1, 1, 1) (one block deeper than the model in layer1,
    which the overlay skips), BN variances positive, BN batch counters; the
    raw ``ResNetMulti`` layout renames the stem and carries the Caffe file's
    own ASPP head (``layer5.conv2d_list.{i}``, another module), the
    ``SegModel`` layout the model's ASPP head at ``num_classes``."""
    rng = np.random.default_rng(seed)
    src = DeepLabV2(num_classes=num_classes, layers=(2, 1, 1, 1)).state_dict()
    sd = {}
    for k, v in src.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(5)
            continue
        a = rng.normal(size=v.shape).astype(np.float32) * 0.1
        sd[k] = torch.from_numpy(np.abs(a) + 0.5 if k.endswith("running_var") else a)
    if layout == "resnetmulti":
        sd = {k.replace("layer0.0.", "conv1.").replace("layer0.1.", "bn1."): v
              for k, v in sd.items() if not k.startswith("final.")}
        for i in range(4):
            sd[f"layer5.conv2d_list.{i}.weight"] = torch.zeros(num_classes, 2048, 3, 3)
            sd[f"layer5.conv2d_list.{i}.bias"] = torch.zeros(num_classes)
    return sd


def _port_student(tmp_path, sd, num_classes=K):
    path = str(tmp_path / "backbone.pth")
    torch.save({"state_dict": sd}, path)  # the wrapped form (SimCLRv2/ProDA checkpoints)
    cfg = _tiny("gta2city_warmup", num_steps=1)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_classes=num_classes))
    state, _, _ = build_experiment(cfg, CPU, pretrained_backbone=path)
    fresh, _, _ = build_experiment(cfg, CPU)
    return state, reference_state_dict(fresh.student)


@pytest.mark.parametrize("layout", ["resnetmulti", "segmodel"])
def test_pretrained_backbone_matches_the_jax_overlay(layout, tmp_path, jax_fresh):
    sd = _seeded_file(layout, K, seed=21)
    state, fresh = _port_student(tmp_path, sd)
    params, stats = jax_fresh
    p_bb, s_bb = segmodel_from_torch({k: v.numpy() for k, v in sd.items()}, LAYERS)
    assert ("head" in p_bb) == (layout == "segmodel")  # the Caffe head is another module
    merged = state_dict_from_jax(*merge_pretrained_backbone(params, stats, p_bb, s_bb), LAYERS)
    ours = reference_state_dict(state.student)
    assert set(ours) == set(merged)
    for k in merged:
        if "head" in p_bb or not k.startswith("final."):
            assert torch.equal(ours[k], merged[k]), k  # what the JAX overlay writes
        else:
            assert torch.equal(ours[k], fresh[k]), k  # both keep their fresh head
    teacher = reference_state_dict(state.teacher)
    assert all(torch.equal(teacher[k], v) for k, v in ours.items())


def test_pretrained_head_of_another_class_count_stays_fresh(tmp_path):
    sd = _seeded_file("segmodel", 16, seed=22)
    state, fresh = _port_student(tmp_path, sd)
    ours = reference_state_dict(state.student)
    for k, v in ours.items():
        if k.startswith("final."):
            assert torch.equal(v, fresh[k]), k
        else:
            assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError, match="lacks"):
        _port_student(tmp_path, {k: v for k, v in sd.items() if not k.startswith("layer4.")})


def test_pretrained_backbone_through_the_cli(argv, tmp_path):
    sd = _seeded_file("resnetmulti", K, seed=23)
    path = str(tmp_path / "DeepLab_resnet_pretrained_init.pth")
    torch.save(sd, path)
    cli.main([*argv, "--pretrained_backbone", path, "--num_steps", "0"])
    student = torch.load(tmp_path / "wd" / "ckpt_final" / "student.pth")
    renamed = {re.sub(r"^conv1\.", "layer0.0.", re.sub(r"^bn1\.", "layer0.1.", k)): v
               for k, v in sd.items()}
    for k, v in student.items():
        if not k.startswith("final."):
            assert torch.equal(v, renamed[k]), k
    with pytest.raises(FileNotFoundError):
        cli.main([*argv, "--pretrained_backbone", str(tmp_path / "missing.pth")])
