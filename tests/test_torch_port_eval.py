"""The port's resize, metrics and two-scale evaluation against the JAX package.

Same numpy-seeded inputs through ``diga_tpu`` (JAX on the CPU) and
``diga_tpu_torch`` (plain PyTorch on the CPU).  Resize at 1e-5 (both
interpolate in f32); confusion counts exact; two-scale logits at 1e-4
with the tiny f32 DeepLabV2; predictions equal except where the JAX
top-2 margin is below 1e-4 (a float reassociation can flip those).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.eval.evaluator import TwoScaleEvaluator as JaxTwoScaleEvaluator
from diga_tpu.eval.evaluator import two_scale_logits as jax_two_scale_logits
from diga_tpu.ops.metrics import confusion_update as jax_confusion_update
from diga_tpu.ops.metrics import scores_from_confusion as jax_scores_from_confusion
from diga_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from diga_tpu_torch.eval.evaluator import TwoScaleEvaluator, two_scale_logits
from diga_tpu_torch.models.convert import state_dict_from_jax
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.ops.metrics import RunningScore, confusion_update, scores_from_confusion
from diga_tpu_torch.ops.resize import resize_bilinear

from _torch_port_common import LAYERS, jax_tiny_deeplab

OUT_HW, DS_HW = (40, 72), (20, 36)


@pytest.mark.parametrize("out_hw", [(17, 29), (5, 7), (9, 13), (9, 40)])
def test_resize_bilinear_matches_jax(out_hw):
    x = np.random.default_rng(0).normal(size=(2, 9, 13, 5)).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), out_hw))
    out = resize_bilinear(torch.from_numpy(x), out_hw)
    assert tuple(out.shape) == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_resize_bilinear_keeps_dtype_and_hwc():
    x = np.random.default_rng(1).normal(size=(9, 13, 3)).astype(np.float32)
    out = resize_bilinear(torch.from_numpy(x).bfloat16(), (17, 25))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (17, 25, 3)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x, jnp.bfloat16), (17, 25)), np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("n_class", [19, 16])
def test_confusion_and_scores_match_jax(n_class):
    rng = np.random.default_rng(n_class)
    gt = rng.integers(0, n_class, size=(2, 31, 47)).astype(np.int32)
    gt[rng.random(gt.shape) < 0.2] = 255  # ignored
    pred = rng.integers(0, n_class, size=gt.shape).astype(np.int32)
    conf0 = rng.integers(0, 5, size=(n_class, n_class)).astype(np.int32)
    ref = np.asarray(jax_confusion_update(jnp.asarray(conf0), jnp.asarray(gt),
                                          jnp.asarray(pred), n_class))
    ours = confusion_update(torch.from_numpy(conf0).long(), torch.from_numpy(gt),
                            torch.from_numpy(pred), n_class)
    np.testing.assert_array_equal(ours.numpy(), ref)
    valid = gt.reshape(-1) != 255
    hist = np.bincount(n_class * gt.reshape(-1)[valid] + pred.reshape(-1)[valid],
                       minlength=n_class * n_class).reshape(n_class, n_class)
    np.testing.assert_array_equal(ours.numpy() - conf0, hist)

    # one absent class exercises the nan-mean
    hist[3, :] = 0
    hist[:, 3] = 0
    s_ours, iu_ours = scores_from_confusion(hist)
    s_ref, iu_ref = jax_scores_from_confusion(hist)
    assert set(s_ours) == set(s_ref)
    if n_class == 16:
        assert "mean_iou_13" in s_ours
    for k in s_ref:
        np.testing.assert_allclose(s_ours[k], s_ref[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose([iu_ours[i] for i in range(n_class)],
                               [iu_ref[i] for i in range(n_class)], rtol=1e-12)


@pytest.fixture(scope="module")
def tiny_pair():
    jmodel, params, stats = jax_tiny_deeplab(seed=9, hw=OUT_HW)

    @jax.jit
    def jax_apply(img):
        return jmodel.apply({"params": params, "batch_stats": stats}, img, train=False)[2]

    model = DeepLabV2(num_classes=19, layers=LAYERS)
    model.load_state_dict(state_dict_from_jax(params, stats, LAYERS), strict=True)
    model.eval()

    def torch_apply(img):
        return model(img.permute(0, 3, 1, 2))[2].permute(0, 2, 3, 1)

    return jax_apply, torch_apply


def _images(seed, n=1):
    return np.random.default_rng(seed).normal(size=(n, *OUT_HW, 3)).astype(np.float32)


def test_two_scale_logits_match_jax(tiny_pair):
    jax_apply, torch_apply = tiny_pair
    x = _images(10)
    ref = np.asarray(jax_two_scale_logits(jax_apply, jnp.asarray(x), OUT_HW, DS_HW))
    with torch.inference_mode():
        ours = two_scale_logits(torch_apply, torch.from_numpy(x), OUT_HW, DS_HW)
    assert tuple(ours.shape) == ref.shape == (1, *OUT_HW, 19)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)

    # predictions: equal wherever the JAX top-2 margin is not a near-tie
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= 1e-4
    pred_ref = ref.argmax(-1)
    pred = ours.argmax(-1).numpy()
    np.testing.assert_array_equal(pred[decided], pred_ref[decided])


def test_evaluator_confusion_matches_jax(tiny_pair):
    jax_apply, torch_apply = tiny_pair
    x = _images(11, n=2)
    labels = np.random.default_rng(12).integers(0, 19, size=(2, *OUT_HW)).astype(np.int32)
    labels[:, :5] = 255
    jev = JaxTwoScaleEvaluator(jax_apply, num_classes=19, out_hw=OUT_HW, ds_hw=DS_HW)
    ev = TwoScaleEvaluator(torch_apply, num_classes=19, out_hw=OUT_HW, ds_hw=DS_HW,
                           device="cpu")
    for i in range(2):
        jev.update(x[i:i + 1], labels[i:i + 1])
        pred = ev.update(x[i:i + 1], labels[i:i + 1])
        assert tuple(pred.shape) == (1, *OUT_HW)
    conf_ref = np.asarray(jev.score.confusion)
    conf = ev.score.confusion.numpy()
    assert conf.sum() == conf_ref.sum() == 2 * (OUT_HW[0] - 5) * OUT_HW[1]
    # only near-tie pixels may move between cells (each move changes 2 cells)
    assert np.abs(conf - conf_ref).sum() <= 2 * max(1, int(conf.sum() * 1e-3))


def test_running_score_on_cpu():
    rs = RunningScore(16, "cpu")
    lbl = torch.arange(16).repeat(3)
    rs.update(lbl, lbl)
    scores, cls_iu = rs.get_scores()
    assert scores["mean_iou"] == scores["mean_iou_13"] == 1.0
    assert len(cls_iu) == 16


def test_build_eval_rgb_input_flips_channels():
    """``extra['rgb_input']`` feeds the model RGB (the semiseg protocol);
    with no weight_dir both models draw the same init from the seed."""
    import dataclasses

    from diga_tpu_torch.configs.presets import get_preset
    from diga_tpu_torch.train.build import build_eval

    base = get_preset("gta2city_warmup")
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, compute_dtype="float32"),
                              extra={"layers": LAYERS})
    cfg_rgb = dataclasses.replace(cfg, extra={"layers": LAYERS, "rgb_input": True})
    apply_bgr, _ = build_eval(cfg, None, torch.device("cpu"))
    apply_rgb, _ = build_eval(cfg_rgb, None, torch.device("cpu"))
    x = torch.from_numpy(_images(13))
    with torch.inference_mode():
        torch.testing.assert_close(apply_rgb(x), apply_bgr(x.flip(-1)), rtol=0, atol=0)
