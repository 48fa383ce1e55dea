"""The port's GroupNorm (diga_tpu_torch.ops.group_norm) against the JAX package.

On the CPU the wrapper runs its plain version; the same numpy-seeded
inputs go through ``FusedGroupNorm(impl="xla")`` and, in interpret mode,
``group_norm_pallas``.  Tolerances are those of
tests/test_pallas_kernels.py: 1e-5 in f32, 3e-2 in bf16 (one bf16 rounding
of the normalized output).  The CUDA kernel itself is held against the
plain version on the card (``cuda`` marker; chip_smoke.py does the same
at the eval path's shapes).
"""

import pathlib
import re

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


# ---------------------------------------------------------------------------
# B2a's launch plan (plain Python): what the kernel's geometry must satisfy
# ---------------------------------------------------------------------------

GROUP_NORM_CU = pathlib.Path(G.__file__).resolve().parents[1] / "csrc" / "group_norm.cu"
SMEM_PER_BLOCK = 232_448  # Hopper's dynamic shared memory of one block
PATH_HW = (33153, 8385, 7345)  # the eval's full- and half-scale sites, the teacher's


def _walk(plan):
    """Per block, the tiles it copies as (first row, rows), as
    gn_stats_kernel computes them (its even row split, then tiles of
    ``tile_rows``).  This holds the plan; that the kernel itself covers
    every row once is shown on the card (chip_smoke.py phase 3)."""
    tr = plan.tile_rows
    out = []
    for chunk in range(plan.chunks):
        r0, r1 = plan.chunk_rows(chunk)
        out.append([(r0 + i * tr, min(tr, r1 - r0 - i * tr)) for i in range(-(-(r1 - r0) // tr))])
    return out


@pytest.mark.parametrize("name,value", [("kTileBytes", G.TILE_BYTES), ("kStages", G.STAGES),
                                        ("kCluster", G.CLUSTER), ("kThreads", G.THREADS)])
def test_stats_plan_constants_match_the_kernel_source(name, value):
    src = GROUP_NORM_CU.read_text()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)


@pytest.mark.parametrize("batch", [1, 6])
@pytest.mark.parametrize("hw", [1, 31, 32, 33, *PATH_HW])
def test_chunk_walk_covers_every_row_once(hw, batch):
    for elem in (2, 4):
        for max_clusters in (1, 5, 32, 64):
            plan = G.stats_plan(batch, hw, 256, elem, max_clusters)
            assert plan.chunks % G.CLUSTER == 0 and plan.clusters >= 1
            # the clusters of the whole batch fit on the card at once where they can
            assert batch * plan.clusters <= max(max_clusters, batch)
            counts = np.zeros(hw, np.int64)
            for tiles in _walk(plan):
                for start, rows in tiles:
                    assert 1 <= rows <= plan.tile_rows
                    counts[start:start + rows] += 1
            assert (counts == 1).all(), (hw, batch, elem, max_clusters)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("c", [32, 64, 96, 256, 512, 1024])
def test_bulk_spans_are_16_byte_aligned_multiples(c, elem):
    for hw in (1, 31, 33, 8385):
        plan = G.stats_plan(6, hw, c, elem, 32)
        for tiles in _walk(plan):
            for start, rows in tiles:
                nbytes = rows * c * elem
                assert nbytes % 16 == 0 and 0 < nbytes <= G.TILE_BYTES
                for b in range(plan.batch):  # x's base is 16-byte aligned (the wrapper checks)
                    assert ((b * hw + start) * c * elem) % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_fits_shared_memory_for_every_c(dtype):
    elem = torch.tensor([], dtype=dtype).element_size()
    widest = G.THREADS * 16 // elem
    # every C the statistics kernel takes (C % 32 == 0, at most THREADS
    # vectors a row; the groups take no shared memory of their own)
    for c in range(32, widest + 1, 32):
        G.check_stats_kernel(c, elem, 32)
        plan = G.stats_plan(1, 33153, c, elem, 32)
        nv = c * elem // 16
        assert plan.threads <= G.THREADS and plan.threads % nv == 0
        assert plan.threads > G.THREADS - nv
        lanes = plan.threads // nv
        # what the ring is reused for: the lanes' rows with the receive
        # buffer, then the fold's columns; the ring holds them (group_norm.cu
        # asserts the same, so one shared-memory size serves every launch)
        scratch = G.scratch_bytes(c, elem)
        assert scratch >= 8 * lanes * c + 8 * c and scratch >= 16 * max(plan.threads, c // 16)
        assert plan.smem == G.STAGES * G.TILE_BYTES >= scratch
        assert c // G.CLUSTER <= plan.threads  # one thread per channel of a slice
        assert plan.tile_rows * c * elem <= G.TILE_BYTES
        assert plan.smem <= SMEM_PER_BLOCK, (c, plan)


@pytest.mark.parametrize("c,dtype,groups,match", [
    (4096, torch.bfloat16, 32, "too wide"),  # 512 vectors a row
    (2048, torch.float32, 32, "too wide"),  # 512 vectors a row
    (256, torch.bfloat16, 4, "multiple of 8"),
    (96, torch.float32, 12, "multiple of 8"),
])
def test_stats_kernel_refuses_what_it_cannot_take(c, dtype, groups, match):
    elem = torch.tensor([], dtype=dtype).element_size()
    with pytest.raises(ValueError, match=match):
        G.check_stats_kernel(c, elem, groups)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_path_takes_c_wider_than_the_stats_kernel(dtype):
    """C = 2048 in 32 groups: more vectors a row than B2a takes in f32, yet
    within what the wrapper accepts; the plain version matches JAX."""
    x, scale, bias = _inputs((1, 3, 5, 2048), seed=4)
    xt = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    with torch.inference_mode():
        y = G.group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), _jax_fused(x, scale, bias, dtype),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("batch,hw,clusters", [(1, 33153, 32), (1, 8385, 32), (6, 7345, 5),
                                               (1, 15, 1), (1, 512, 2), (64, 7345, 1)])
def test_plan_at_the_path_sites(batch, hw, clusters):
    """bf16, C = 256, 32 resident clusters (two blocks per SM on 128 SMs)."""
    plan = G.stats_plan(batch, hw, 256, 2, 32)
    assert plan.tile_rows == 32 and plan.threads == 256 and plan.smem == 6 * 16384
    assert plan.clusters == clusters and plan.grid == (8 * clusters, batch)
