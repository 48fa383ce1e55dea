"""The port's GroupNorm (diga_tpu_torch.ops.group_norm) against the JAX package.

On the CPU the wrapper runs its plain version; the same numpy-seeded
inputs go through ``FusedGroupNorm(impl="xla")`` and, in interpret mode,
``group_norm_pallas``.  Tolerances are those of
tests/test_pallas_kernels.py: 1e-5 in f32, 3e-2 in bf16 (one bf16 rounding
of the normalized output).  The CUDA kernel itself is held against the
plain version on the card (``cuda`` marker; chip_smoke.py does the same
at the eval path's shapes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diga_tpu.models.resnet_deeplab import FusedGroupNorm as JaxFusedGroupNorm
from diga_tpu.ops.pallas_gn import group_norm_pallas
from diga_tpu_torch.models.resnet_deeplab import FusedGroupNorm
from diga_tpu_torch.ops import group_norm as G

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    # per-channel offsets, as conv outputs have, so the mean term matters
    x = (rng.normal(size=shape) + rng.uniform(-2, 2, size=(c,))).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, scale, bias


def _jax_fused(x, scale, bias, dtype):
    mod = JaxFusedGroupNorm(num_groups=32, dtype=JAX_DTYPES[dtype], impl="xla")
    y = mod.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
                  jnp.asarray(x, JAX_DTYPES[dtype]))
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 17, 29, 256), (2, 8, 16, 64)])
def test_group_norm_matches_fused_groupnorm(shape, dtype):
    x, scale, bias = _inputs(shape)
    xt = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    with torch.inference_mode():
        y = G.group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert y.dtype == xt.dtype and y.shape == xt.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), _jax_fused(x, scale, bias, dtype),
                               atol=tol, rtol=tol)


def test_group_norm_matches_pallas_interpret():
    x, scale, bias = _inputs((2, 8, 16, 64), seed=1)
    ref = np.asarray(group_norm_pallas(jnp.asarray(x), jnp.asarray(scale),
                                       jnp.asarray(bias), 32))
    with torch.inference_mode():
        y = G.group_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_stats_are_channel_sums():
    """Σx and Σx² per (image, channel) at 1e-5 relative to float64 sums."""
    x, scale, bias = _inputs((2, 17, 29, 64), seed=2)
    with torch.inference_mode():
        s, s2, mul, add = G.group_norm_stats(torch.from_numpy(x), torch.from_numpy(scale),
                                             torch.from_numpy(bias))
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(s.numpy(), x64.sum(axis=(1, 2)),
                               rtol=0, atol=1e-5 * np.abs(x64).sum(axis=(1, 2)).max())
    np.testing.assert_allclose(s2.numpy(), (x64 * x64).sum(axis=(1, 2)), rtol=1e-5)
    assert mul.shape == add.shape == (2, 64) and mul.dtype == torch.float32


def test_module_site_matches_jax():
    """The model's FusedGroupNorm on a channels_last NCHW activation."""
    x, scale, bias = _inputs((1, 9, 13, 256), seed=3)
    mod = FusedGroupNorm(256)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    with torch.inference_mode():
        y = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                               _jax_fused(x, scale, bias, "float32"), atol=1e-5, rtol=1e-5)


def test_raises_on_requires_grad():
    x, scale, bias = _inputs((1, 4, 5, 64))
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        G.group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias))


@pytest.mark.parametrize("bad", ["channels", "layout", "dtype", "rank"])
def test_raises_on_unsupported_input(bad):
    x, scale, bias = _inputs((1, 4, 5, 64))
    xt, st, bt = torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias)
    if bad == "channels":  # 48 channels: not divisible by 32
        xt, st, bt = xt[..., :48].contiguous(), st[:48], bt[:48]
    elif bad == "layout":  # NCHW-contiguous memory viewed as NHWC
        xt = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif bad == "dtype":
        xt = xt.half()
    else:
        xt = xt[0]
    with torch.inference_mode(), pytest.raises((ValueError, TypeError)):
        G.group_norm(xt, st, bt)


def test_launch_counter_stays_zero_on_cpu():
    G.reset_launches()
    x, scale, bias = _inputs((1, 4, 5, 64))
    with torch.inference_mode():
        G.group_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    assert G.launches == {"group_norm_stats": 0, "group_norm_apply": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, scale, bias = _inputs((2, 17, 29, 256))
    xt = torch.from_numpy(x).to("cuda", TORCH_DTYPES[dtype])
    st, bt = torch.from_numpy(scale).cuda(), torch.from_numpy(bias).cuda()
    with torch.inference_mode():
        before = dict(G.launches)
        y = G.group_norm(xt, st, bt)
        y2 = G.group_norm(xt, st, bt)
        ref = G.group_norm_plain(xt, st, bt)
    torch.cuda.synchronize()
    assert G.launches["group_norm_stats"] == before["group_norm_stats"] + 2
    assert torch.equal(y, y2)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)
