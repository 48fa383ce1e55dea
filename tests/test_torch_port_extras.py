"""``ops/extras.py`` and the last exported helpers against ``diga_tpu`` (CPU).

* ``label_one_hot``, ``rand_bbox`` and ``generate_block_mask`` are exact,
  with JAX's draws injected (the box centre, the coarse uniforms);
  ``calc_mean_std`` and AdaIN agree to rtol 1e-5 (the variance biased);
  ``fourier_exchange`` to atol 1e-4 on unit-scale inputs, the window
  rule's ``b == 0`` included;
* ``denormalize_image``, ``CenterCrop``, ``resize_nearest_nhwc`` (the
  float64 index rule) and ``upsample2x_nearest`` are exact,
  ``cross_entropy2d_valid_mean`` agrees to rtol 1e-6.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from diga_tpu.data import normalize as jax_normalize
from diga_tpu.data import transforms as jax_transforms
from diga_tpu.ops import extras as jax_extras
from diga_tpu.ops import losses as jax_losses
from diga_tpu.ops import resize as jax_resize
from diga_tpu_torch.data import normalize, transforms
from diga_tpu_torch.ops import extras, losses, resize


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("num_classes", [16, 19])
def test_label_one_hot_exact(num_classes):
    lbl = _rng(1).integers(0, num_classes, size=(2, 9, 13)).astype(np.int32)
    lbl[:, :2] = 255
    lbl[0, 3, :4] = num_classes + 3  # out of range: all 1e-4, as jax.nn.one_hot
    want = np.asarray(jax_extras.label_one_hot(jnp.asarray(lbl), num_classes))
    got = extras.label_one_hot(torch.from_numpy(lbl), num_classes).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,lam", [((64, 64), 0.5), ((33, 57), 0.3), ((48, 96), 0.9),
                                    ((7, 5), 0.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rand_bbox_exact_with_injected_centre(hw, lam, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_extras.rand_bbox(key, hw, lam))
    kx, ky = jax.random.split(key)
    cx = int(jax.random.randint(kx, (), 0, hw[1]))
    cy = int(jax.random.randint(ky, (), 0, hw[0]))
    got = extras.rand_bbox(hw, lam, center=(cx, cy)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rand_bbox_draws_from_a_generator():
    a = extras.rand_bbox((40, 60), 0.5, generator=torch.Generator().manual_seed(3))
    b = extras.rand_bbox((40, 60), 0.5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (40, 60)
    assert 0.0 < float(a.mean()) <= 0.5


@pytest.mark.parametrize("shape,block", [((2, 64, 64), 32), ((1, 72, 200), 64),
                                         ((3, 96, 160), 64), ((1, 20, 30), 64)])
def test_generate_block_mask_exact_with_injected_uniforms(shape, block):
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_extras.generate_block_mask(key, shape, block=block, ratio=0.5))
    grid = extras.block_grid(shape, block)
    b, h, w = shape
    assert grid == (b, max(1, round(h / block)), max(1, round(w / block)))
    uniform = np.array(jax.random.uniform(key, grid))
    got = extras.generate_block_mask(shape, block, 0.5, uniform=torch.from_numpy(uniform))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="uniform"):
        extras.generate_block_mask(shape, block, uniform=torch.zeros(1, 1, 1, 1))


def test_block_grid_rounds_half_to_even():
    assert extras.block_grid((1, 96, 160), 64) == (1, 2, 2)  # 1.5 -> 2, 2.5 -> 2
    assert extras.block_grid((1, 32, 224), 64) == (1, 1, 4)  # 0.5 -> 0 -> 1, 3.5 -> 4


def test_calc_mean_std_and_adain():
    content = (_rng(2).normal(size=(2, 11, 13, 8)) * 3 + 1).astype(np.float32)
    style = (_rng(3).normal(size=(2, 11, 13, 8)) * 0.5 - 2).astype(np.float32)
    jm, js = jax_extras.calc_mean_std(jnp.asarray(content))
    tm, ts = extras.calc_mean_std(torch.from_numpy(content))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    want = np.asarray(jax_extras.adaptive_instance_normalization(jnp.asarray(content),
                                                                 jnp.asarray(style)))
    got = extras.adaptive_instance_normalization(torch.from_numpy(content),
                                                 torch.from_numpy(style)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,L", [((1, 64, 64, 3), 0.1), ((2, 40, 72, 3), 0.05),
                                     ((1, 33, 50, 3), 0.01)])
def test_fourier_exchange_close(shape, L):
    src = _rng(4).normal(size=shape).astype(np.float32)
    trg = _rng(5).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_extras.fourier_exchange(jnp.asarray(src), jnp.asarray(trg), L=L))
    got = extras.fourier_exchange(torch.from_numpy(src), torch.from_numpy(trg), L=L).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    if int(np.floor(np.float32(min(shape[1:3]) * L))) == 0:  # no window: src back
        np.testing.assert_allclose(got, src, atol=1e-4)
    else:
        assert not np.allclose(got, src, atol=1e-3)


def test_denormalize_image_exact():
    x = (_rng(6).normal(size=(9, 17, 3)) * 1.2).astype(np.float32)
    np.testing.assert_array_equal(normalize.denormalize_image(x),
                                  jax_normalize.denormalize_image(x))
    img = _rng(7).integers(0, 256, size=(9, 17, 3), dtype=np.uint8)
    np.testing.assert_array_equal(normalize.denormalize_image(normalize.normalize_image(img)),
                                  img)


@pytest.mark.parametrize("size", [(32, 48), 30, (41, 57)])
def test_center_crop_exact(size):
    img = Image.fromarray(_rng(8).integers(0, 256, size=(41, 57, 3), dtype=np.uint8))
    lbl = Image.fromarray(_rng(9).integers(0, 19, size=(41, 57)).astype(np.uint8))
    ji, (jl,) = jax_transforms.CenterCrop(size)(img, [lbl], None)
    ti, (tl,) = transforms.CenterCrop(size)(img, [lbl], None)
    np.testing.assert_array_equal(np.array(ti), np.array(ji))
    np.testing.assert_array_equal(np.array(tl), np.array(jl))


@pytest.mark.parametrize("in_hw,out_hw", [((13, 17), (40, 72)), ((65, 129), (33, 65)),
                                          ((512, 896), (129, 225)), ((8, 8), (8, 8))])
def test_resize_nearest_nhwc_exact(in_hw, out_hw):
    x = _rng(10).normal(size=(2, *in_hw, 5)).astype(np.float32)
    want = np.asarray(jax_resize.resize_nearest_nhwc(jnp.asarray(x), out_hw))
    got = resize.resize_nearest_nhwc(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, want)


def test_upsample2x_nearest_exact():
    x = _rng(11).normal(size=(2, 7, 9, 4)).astype(np.float32)
    want = np.asarray(jax_resize.upsample2x_nearest(jnp.asarray(x)))
    got = resize.upsample2x_nearest(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = torch.nn.Upsample(scale_factor=2)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got, ref.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("ignore_frac", [0.0, 0.3, 1.0])
def test_cross_entropy2d_valid_mean(ignore_frac):
    rng = _rng(12)
    logits = (rng.normal(size=(2, 9, 13, 19)) * 2).astype(np.float32)
    lbl = rng.integers(0, 19, size=(2, 9, 13)).astype(np.int32)
    lbl[rng.random(lbl.shape) < ignore_frac] = 255
    want = float(jax_losses.cross_entropy2d_valid_mean(jnp.asarray(logits), jnp.asarray(lbl)))
    got = float(losses.cross_entropy2d_valid_mean(torch.from_numpy(logits),
                                                  torch.from_numpy(lbl)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
