"""The height-sharded two-scale eval (``--shard spatial``) against the
one-process eval and against JAX's ``shard="spatial"``.

* Each sharded op (``parallel/spatial_ops.py``) against its one-device
  form through the local transport at n = 2, 3, 4 and 8 (uneven splits,
  shards with no rows, the dilation-24 halo deeper than a shard): f32, at
  1e-5 (the convs' reassociation over other slab shapes), the max pool
  exactly; the same cases over a gloo world of 3 ranks (the group
  transport's point-to-point halos).
* The whole eval of a tiny DeepLabV2 and a tiny HRNet+OCR on 32x64 at n =
  2, 4 and 8: the confusion matrix equal to the one-process eval's
  exactly (as ``tests/test_train_steps.py:332-333`` holds JAX's), the
  logits within atol 1e-5 / rtol 1e-4.
* The tiny DeepLabV2, through the weight converter, against ``diga_tpu``'s
  ``TwoScaleEvaluator(mesh=make_mesh(2), shard="spatial")``: equal
  confusion matrices.
* ``evaluate_val --device cpu --n_devices 2 --shard spatial`` (a spawned
  gloo world) gives the no-flag run's scores and dumped predictions; the
  refusals; the sharded GroupNorm's fold at n = 1 equal to the fused
  plain form; the launch counters under threads; a shard that raises.

torch runs on one intra-op thread in this file (and in the ranks it spawns).
"""

import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.eval.evaluator import TwoScaleEvaluator as JaxTwoScaleEvaluator
from diga_tpu.models.resnet_deeplab import DeepLabV2 as JaxDeepLabV2
from diga_tpu.parallel import make_mesh
from diga_tpu_torch.cli import evaluate_val
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.eval.evaluator import TwoScaleEvaluator, two_scale_logits
from diga_tpu_torch.models.convert import state_dict_from_jax
from diga_tpu_torch.models.hrnet_ocr import HRNetOCR
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.ops import group_norm as G
from diga_tpu_torch.parallel import dist, spatial, spatial_ops
from diga_tpu_torch.train.build import _eval_apply, seeded

import _torch_port_parallel_sub as parallel_sub
import _torch_port_spatial_sub as sub

HW, DS_HW, K = (32, 64), (16, 32), 19
TINY_HRNET = parallel_sub.TINY_HRNET
OP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def timeouts(monkeypatch):
    monkeypatch.setenv(dist.PG_TIMEOUT_ENV, "120")
    monkeypatch.setenv(dist.JOIN_TIMEOUT_ENV, "300")
    for k in dist.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


def _image(seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, *HW, 3)).astype(np.float32),
            rng.integers(0, K, size=(1, *HW)).astype(np.int32))


# ---------------------------------------------------------------------------
# the sharded ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("case", list(sub.CASES))
def test_sharded_op_matches_one_device(case, n):
    errs = spatial.run_local(n, lambda s: sub.run_case(case, s))
    assert max(errs) <= (0.0 if case == "max_pool" else OP_TOL), errs


def test_sharded_ops_over_a_gloo_world_of_three():
    errs = dist.launch(sub.group_ops, 3, "cpu")
    assert set(errs) == set(sub.CASES)
    assert errs["max_pool"] == 0.0 and max(errs.values()) <= OP_TOL, errs


def test_sharded_group_norm_fold_at_one_shard_is_the_fused_plain_form():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 5, 7, 64)).astype(np.float32) * 2 + 1)
    w = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    want = G.group_norm_plain(x, w, b)
    got = spatial.run_local(1, lambda s: spatial_ops.group_norm(s, x, w, b, 32, 1e-5))[0]
    assert torch.equal(got, want)
    s_c, s2_c, mul, add = G.group_norm_stats_plain(x, w, b)
    fold = G.fold_group_stats(s_c, s2_c, float(5 * 7 * 2), w, b, 32, 1e-5, x.dtype)
    assert torch.equal(fold[0], mul) and torch.equal(fold[1], add)


# ---------------------------------------------------------------------------
# the whole eval
# ---------------------------------------------------------------------------

def _model(kind: str) -> torch.nn.Module:
    with seeded(3):
        model = (DeepLabV2(K, layers=parallel_sub.LAYERS) if kind == "deeplab"
                 else HRNetOCR(K, TINY_HRNET))
    with torch.no_grad():  # BN statistics away from their init
        gen = torch.Generator().manual_seed(5)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return model.eval()


@pytest.fixture(scope="module")
def unsharded():
    """{kind: (apply, image, label, one-process confusion, logits)}."""
    out = {}
    for i, kind in enumerate(("deeplab", "hrnet")):
        model = _model(kind)
        apply = _eval_apply(model, kind == "hrnet", None)
        img, lbl = _image(10 + i)
        ev = TwoScaleEvaluator(apply, K, HW, DS_HW, "cpu")
        ev.update(img, lbl)
        with torch.inference_mode():
            logits = two_scale_logits(apply, torch.from_numpy(img), HW, DS_HW)
        spatial_ops.convert_spatial(model)  # the sharded forms; unchanged outside a shard
        out[kind] = (apply, img, lbl, ev.score.confusion, logits)
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", ["deeplab", "hrnet"])
def test_spatial_eval_equals_one_process(unsharded, kind, n):
    apply, img, lbl, conf, logits = unsharded[kind]

    def shard_run(s):
        ev = TwoScaleEvaluator(apply, K, HW, DS_HW, "cpu", shard="spatial", spatial=s)
        pred = ev.update(img, lbl)
        with torch.inference_mode(), s.active():
            rows = two_scale_logits(apply, s.slice_rows(torch.from_numpy(img)), HW, DS_HW)
        return ev.score.confusion, pred, rows

    out = spatial.run_local(n, shard_run)
    for c, _, _ in out:  # every shard holds the one-process matrix
        assert torch.equal(c, conf)
    assert int(conf.sum()) == HW[0] * HW[1]
    torch.testing.assert_close(torch.cat([o[2] for o in out], 1), logits, atol=1e-5, rtol=1e-4)
    pred = torch.cat([o[1] for o in out], 1)
    assert torch.equal(pred, logits.argmax(-1))


def test_spatial_eval_matches_jax_over_a_mesh_of_two():
    """The tiny DeepLabV2 from one JAX init (BN/GN 1-D leaves moved off
    their init) through ``state_dict_from_jax``."""
    jmodel = JaxDeepLabV2(num_classes=K, layers=parallel_sub.LAYERS, s2b=False)
    key = jax.random.PRNGKey(8)
    variables = jax.jit(lambda: jmodel.init({"params": key, "dropout": key},
                                            jnp.zeros((1, *HW, 3)), train=False))()
    rng = np.random.default_rng(8)

    def perturb(a, positive):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        a = a + rng.normal(size=a.shape).astype(np.float32) * 0.1
        return np.abs(a) if positive else a

    params = jax.tree_util.tree_map(lambda a: perturb(a, False), variables["params"])
    stats = jax.tree_util.tree_map(lambda a: perturb(a, True), variables["batch_stats"])
    img, lbl = _image(12)
    jev = JaxTwoScaleEvaluator(
        lambda im: jmodel.apply({"params": params, "batch_stats": stats}, im, train=False)[2],
        num_classes=K, out_hw=HW, ds_hw=DS_HW, mesh=make_mesh(2), shard="spatial")
    jev.update(img, lbl)

    model = DeepLabV2(K, layers=parallel_sub.LAYERS)
    model.load_state_dict(state_dict_from_jax(params, stats, parallel_sub.LAYERS), strict=True)
    apply = _eval_apply(spatial_ops.convert_spatial(model.eval()), False, None)
    confs = spatial.run_local(2, lambda s: (lambda ev: (ev.update(img, lbl), ev.score.confusion)[1])(
        TwoScaleEvaluator(apply, K, HW, DS_HW, "cpu", shard="spatial", spatial=s)))
    np.testing.assert_array_equal(confs[0].numpy(), np.asarray(jev.score.confusion))
    np.testing.assert_array_equal(confs[1].numpy(), confs[0].numpy())


# ---------------------------------------------------------------------------
# the CLI over a world of processes, and the refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_args(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_cli")
    val_img, val_lbl = synthetic.make_cityscapes_fixture(str(root / "city"), n=2, h=40, w=72,
                                                         split="val")
    return root, ["--preset", "tiny_dg", "--target_root", str(root / "city"),
                  "--val_img_list", val_img, "--val_lbl_list", val_lbl, "--device", "cpu"]


def test_evaluate_val_n_devices_two_spatial_equals_no_flag(cli_args, monkeypatch):
    from PIL import Image

    root, args = cli_args
    monkeypatch.setitem(presets.PRESETS, "tiny_dg", parallel_sub.tiny_dg_preset())
    one = evaluate_val.main([*args, "--dump_preds", str(root / "one")])
    two = evaluate_val.main([*args, "--dump_preds", str(root / "two"), "--n_devices", "2",
                             "--shard", "spatial"])
    assert one == two and math.isfinite(one["cityscapes"]["mean_iou"])
    names = sorted(os.listdir(root / "one"))
    assert len(names) == 2 and sorted(os.listdir(root / "two")) == names
    for name in names:
        np.testing.assert_array_equal(np.array(Image.open(root / "one" / name)),
                                      np.array(Image.open(root / "two" / name)))


@pytest.mark.parametrize("flags,message", [
    (["--n_devices", "2", "--eval_batch", "2"], "single-image batches"),
    (["--n_devices", "3"], "does not divide by the 3 ranks"),
], ids=["eval_batch", "height"])
def test_spatial_refusals(cli_args, monkeypatch, capsys, flags, message):
    _, args = cli_args
    monkeypatch.setitem(presets.PRESETS, "tiny_dg", parallel_sub.tiny_dg_preset())
    with pytest.raises(SystemExit):
        evaluate_val.main([*args, "--shard", "spatial", *flags])
    assert message in capsys.readouterr().err


def test_spatial_evaluator_needs_a_world_and_a_dividing_height():
    with pytest.raises(RuntimeError, match="process group"):
        TwoScaleEvaluator(lambda x: x, K, HW, DS_HW, "cpu", shard="spatial")
    with pytest.raises(RuntimeError, match="does not divide"):
        spatial.run_local(3, lambda s: TwoScaleEvaluator(lambda x: x, K, HW, DS_HW, "cpu",
                                                         shard="spatial", spatial=s))


def test_a_shard_that_raises_makes_its_peers_raise():
    def body(s):
        if s.r == 1:
            raise ValueError("shard 1 fails")
        s.all_reduce(torch.zeros(3))  # its peers wait here until the barrier breaks

    with pytest.raises(RuntimeError, match="shard 1 fails"):
        spatial.run_local(4, body, timeout_s=60)


def test_launch_counters_under_threads():
    """The B2 launch counts are a locked read-modify-write: no increment is
    lost with many threads switching often."""
    interval = sys.getswitchinterval()
    G.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [G.count_launch("group_norm_stats",
                                                                   "group_norm_apply")
                                                    for _ in range(2000)]) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert G.launches == {"group_norm_stats": 64000, "group_norm_apply": 64000}
    finally:
        sys.setswitchinterval(interval)
        G.reset_launches()
