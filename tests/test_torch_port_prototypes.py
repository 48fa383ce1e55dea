"""The port's prototype ops, nearest resize and DACS mix against diga_tpu's.

``diga_tpu_torch.ops.prototypes`` (masked class means, the mean/EMA
centroid update, distance, weight, bilateral consensus), ``resize_nearest``
and ``dacs_crossmix`` on the same seeded numpy inputs as
``diga_tpu.ops.prototypes``/``resize``/``mixing`` (JAX on the CPU).
Tolerances: the f32 values at 1e-5 relative (sums in another order); the
label maps, the validity masks, the counts, the resize and the DACS labels
exact; the DACS image to 1e-6.  One case runs ``masked_class_means``
inside a bf16 autocast and must still equal the f32 JAX result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.ops import mixing as jax_mixing
from diga_tpu.ops import prototypes as jax_proto
from diga_tpu.ops.resize import resize_nearest as jax_resize_nearest
from diga_tpu_torch.ops import mixing, prototypes
from diga_tpu_torch.ops.resize import resize_nearest

K, C = 19, 256
RTOL = 1e-5


def _close(ours: torch.Tensor, ref, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _feat_logits(seed, b=2, h=9, w=14, k=K, c=C):
    rng = np.random.default_rng(seed)
    feat = np.maximum(rng.normal(size=(b, h, w, c)), 0).astype(np.float32)
    logits = (rng.normal(size=(b, h, w, k)) * 2).astype(np.float32)
    return feat, logits


def _labels(seed, b=2, hw=(33, 57), k=K):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, k, size=(b, *hw)).astype(np.int32)
    lbl[:, :5] = 255  # ignore rows
    return lbl


def _agreeing_labels(logits, seed, scale=(4, 4)):
    """Labels at ``scale`` x the logits' size that mostly agree with their
    argmax, a few changed, some ignored."""
    rng = np.random.default_rng(seed)
    lbl = np.argmax(logits, axis=-1).astype(np.int32)
    lbl = np.where(rng.random(lbl.shape) < 0.2, rng.integers(0, K, lbl.shape), lbl)
    lbl = np.repeat(np.repeat(lbl, scale[0], axis=1), scale[1], axis=2).astype(np.int32)
    lbl[:, :3] = 255
    return lbl


@pytest.mark.parametrize("with_labels", [False, True])
def test_masked_class_means_match_jax(with_labels):
    feat, logits = _feat_logits(1)
    logits[..., :4] += 3.0  # a few classes take most pixels, the rest few
    lbl = _agreeing_labels(logits, 2) if with_labels else None
    ref_v, ref_ok = jax_proto.masked_class_means(
        jnp.asarray(feat), jnp.asarray(logits), None if lbl is None else jnp.asarray(lbl))
    v, ok = prototypes.masked_class_means(
        torch.from_numpy(feat), torch.from_numpy(logits),
        None if lbl is None else torch.from_numpy(lbl))
    assert v.dtype == torch.float32 and ok.dtype == torch.bool
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    _close(v, ref_v, atol=1e-7)
    assert ok.any() and not ok.all()  # some classes fall under min_pixels


def test_a_class_just_under_min_pixels_is_invalid():
    """Class 3 predicted at exactly 4 pixels (< min_pixels 5), class 4 at 5."""
    feat, _ = _feat_logits(3, b=1, h=6, w=8)
    pred = np.zeros((1, 6, 8), np.int64)
    pred[0, 0, :4] = 3
    pred[0, 1, :5] = 4
    logits = np.eye(K, dtype=np.float32)[pred] * 5.0
    ref_v, ref_ok = jax_proto.masked_class_means(jnp.asarray(feat), jnp.asarray(logits))
    v, ok = prototypes.masked_class_means(torch.from_numpy(feat), torch.from_numpy(logits))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    assert not bool(ok[0, 3]) and bool(ok[0, 4]) and bool(ok[0, 0])
    _close(v, ref_v, atol=1e-7)


def test_masked_class_means_stay_f32_inside_bf16_autocast():
    feat, logits = _feat_logits(4)
    logits[..., :4] += 3.0
    lbl = _agreeing_labels(logits, 5)
    cents = np.random.default_rng(6).normal(size=(K, C)).astype(np.float32)
    ref_v, ref_ok = jax_proto.masked_class_means(jnp.asarray(feat), jnp.asarray(logits),
                                                 jnp.asarray(lbl))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        v, ok = prototypes.masked_class_means(torch.from_numpy(feat), torch.from_numpy(logits),
                                              torch.from_numpy(lbl))
        d = prototypes.centroid_distance(torch.from_numpy(feat), torch.from_numpy(cents))
    assert v.dtype == d.dtype == torch.float32
    assert ok.any()
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    _close(v, ref_v, atol=1e-7)
    _close(d, jax_proto.centroid_distance(jnp.asarray(feat), jnp.asarray(cents)), atol=1e-5)


@pytest.mark.parametrize("start_mean", [True, False])
@pytest.mark.parametrize("counts_at", ["zero", "around_100", "at_cap"])
def test_update_centroids_match_jax(start_mean, counts_at):
    rng = np.random.default_rng(6)
    b = 4
    vecs = rng.normal(size=(K, C)).astype(np.float32)
    counts = {"zero": np.zeros(K), "around_100": rng.integers(97, 103, size=K),
              "at_cap": np.full(K, 2999.0)}[counts_at].astype(np.float32)
    new = rng.normal(size=(b, K, C)).astype(np.float32)
    valid = rng.random(size=(b, K)) < 0.6
    valid[:, 0] = True  # class 0 observed by every image: per-image order matters
    ref = jax_proto.update_centroids(jax_proto.Centroids(jnp.asarray(vecs), jnp.asarray(counts)),
                                     jnp.asarray(new), jnp.asarray(valid), start_mean=start_mean)
    ours = prototypes.update_centroids(
        prototypes.Centroids(torch.from_numpy(vecs), torch.from_numpy(counts)),
        torch.from_numpy(new), torch.from_numpy(valid), start_mean=start_mean)
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))
    _close(ours.vectors, ref.vectors, atol=1e-6)
    if counts_at == "at_cap":
        assert float(ours.counts.max()) == 3000.0


def test_distance_weight_and_consensus_match_jax():
    feat, _ = _feat_logits(7, h=11, w=13)
    cents = np.random.default_rng(8).normal(size=(K, C)).astype(np.float32)
    ft, ct = torch.from_numpy(feat), torch.from_numpy(cents)
    fj, cj = jnp.asarray(feat), jnp.asarray(cents)
    _close(prototypes.centroid_distance(ft, ct), jax_proto.centroid_distance(fj, cj), atol=1e-5)
    w = prototypes.centroid_weight(ft, ct)
    ref_w = jax_proto.centroid_weight(fj, cj)
    _close(w, ref_w, atol=1e-7)
    pseudo = np.asarray(jnp.argmax(ref_w, axis=-1)).astype(np.int32)
    flip = np.random.default_rng(9).random(pseudo.shape) < 0.3
    pseudo = np.where(flip, (pseudo + 1) % K, pseudo).astype(np.int32)
    pseudo[:, 0] = 255
    ref = jax_proto.bilateral_consensus(jnp.asarray(pseudo), ref_w)
    ours = prototypes.bilateral_consensus(torch.from_numpy(pseudo), w)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    kept = float((ours != 255).float().mean())
    assert 0.3 < kept < 0.9


def test_consensus_argmax_ties_take_the_first_class():
    w = torch.zeros((1, 1, 3, K))
    w[0, 0, :, 4] = w[0, 0, :, 7] = 0.5
    pseudo = torch.tensor([[[4, 7, 255]]], dtype=torch.int32)
    ref = jax_proto.bilateral_consensus(jnp.asarray(pseudo.numpy()), jnp.asarray(w.numpy()))
    ours = prototypes.bilateral_consensus(pseudo, w)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.tolist() == [[[4, 255, 255]]]


@pytest.mark.parametrize("in_hw,out_hw", [((512, 896), (65, 113)), ((169, 309), (65, 129)),
                                          ((37, 23), (11, 17)), ((8, 8), (13, 5))])
def test_resize_nearest_matches_jax_exactly(in_hw, out_hw):
    lbl = np.random.default_rng(10).integers(0, 256, size=(2, *in_hw)).astype(np.int32)
    ours = resize_nearest(torch.from_numpy(lbl), out_hw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_resize_nearest(jnp.asarray(lbl),
                                                                             out_hw)))


def test_dacs_crossmix_with_injected_selection():
    rng = np.random.default_rng(11)
    b, hw = 3, (24, 40)
    t_img = rng.normal(size=(b, *hw, 3)).astype(np.float32)
    s_img = rng.normal(size=(b, *hw, 3)).astype(np.float32)
    s_lbl = _labels(12, b=b, hw=hw)
    t_pseudo = _labels(13, b=b, hw=hw)
    key = jax.random.PRNGKey(14)
    ref_img, ref_lbl = jax_mixing.dacs_crossmix(jnp.asarray(t_img), jnp.asarray(s_img),
                                                jnp.asarray(s_lbl), jnp.asarray(t_pseudo), key, K)
    sel = np.array(jax_mixing.sample_half_classes(jnp.asarray(s_lbl), key, K))
    img, lbl = mixing.dacs_crossmix(torch.from_numpy(t_img), torch.from_numpy(s_img),
                                    torch.from_numpy(s_lbl), torch.from_numpy(t_pseudo),
                                    torch.from_numpy(sel), K)
    assert lbl.dtype == torch.int32
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(ref_lbl))
    _close(img, ref_img, rtol=0, atol=1e-6)
    mask = lbl.numpy() == s_lbl
    assert 0.1 < mask.mean() < 0.95  # both sources present


def test_source_centroid_accumulation_matches_jax():
    """``calc_centroids --source``'s accumulation at the function level:
    CrDoMix of the translated and the clean source with the JAX selection
    injected, then label-masked means and mean-mode updates over 3 images."""
    rng = np.random.default_rng(15)
    hw, fhw = (40, 72), (10, 18)
    ref = jax_proto.Centroids.create(K, C)
    ours = prototypes.Centroids.create(K, C)
    key = jax.random.PRNGKey(16)
    for i in range(3):
        image = rng.normal(size=(1, *hw, 3)).astype(np.float32)
        rec = rng.normal(size=(1, *hw, 3)).astype(np.float32)
        feat, logits = _feat_logits(20 + i, b=1, h=fhw[0], w=fhw[1])
        logits[..., :4] += 3.0
        label = _agreeing_labels(logits, 17 + i)
        key, sub = jax.random.split(key)
        ref_mix = jax_mixing.crdomix(jnp.asarray(rec), jnp.asarray(image), jnp.asarray(label),
                                     sub, K)
        sel = np.array(jax_mixing.sample_half_classes(jnp.asarray(label), sub, K))
        mix = mixing.crdomix(torch.from_numpy(rec), torch.from_numpy(image),
                             torch.from_numpy(label), torch.from_numpy(sel), K)
        _close(mix, ref_mix, rtol=0, atol=1e-6)
        ref = jax_proto.update_centroids(ref, *jax_proto.masked_class_means(
            jnp.asarray(feat), jnp.asarray(logits), jnp.asarray(label)), start_mean=True)
        ours = prototypes.update_centroids(ours, *prototypes.masked_class_means(
            torch.from_numpy(feat), torch.from_numpy(logits), torch.from_numpy(label)),
            start_mean=True)
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))
    assert float(ours.counts.sum()) > 0
    _close(ours.vectors, ref.vectors, atol=1e-7)
