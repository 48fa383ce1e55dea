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
@pytest.mark.parametrize("shape", [(2, 17, 29, 256), (1, 65, 129, 256), (6, 7, 13, 256),
                                   (1, 1, 1, 256), (2, 9, 11, 32)])
def test_cuda_apply_is_bitwise_the_plain_version(shape, dtype):
    """B2b, through the pair ``group_norm`` (launched under B2a's tail) and on
    its own, bitwise equal to ``group_norm_apply_plain`` on B2a's mul/add."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, scale, bias = _inputs(shape, seed=5)
    xt = torch.from_numpy(x).to("cuda", TORCH_DTYPES[dtype])
    st, bt = torch.from_numpy(scale).cuda(), torch.from_numpy(bias).cuda()
    with torch.inference_mode():
        _, _, mul, add = G.group_norm_stats(xt, st, bt)
        ref = G.group_norm_apply_plain(xt, mul, add)
        pair = G.group_norm(xt, st, bt)
        alone = G.group_norm_apply(xt, mul, add)
    torch.cuda.synchronize()
    assert torch.equal(pair, ref) and torch.equal(alone, ref)


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
PATH_HW = (33153, 8385, 7345)  # the eval's full- and half-scale sites, the teachers'


def _plan(kernel, batch, hw, c, elem, resident=32):
    """B2a's plan with ``resident`` clusters on the card, or B2b's on a card
    of ``resident`` SMs."""
    if kernel == "stats":
        return G.stats_plan(batch, hw, c, elem, resident)
    return G.apply_plan(batch, hw, c, elem, resident)


def _walk(plan):
    """Per block, the tiles it copies as (first row, rows), as
    gn_stats_kernel computes them (its even row split, then tiles of
    ``tile_rows``).  This holds the plan; that the kernels themselves cover
    every row once is shown on the card (chip_smoke.py phase 3)."""
    tr = plan.tile_rows
    out = []
    for chunk in range(plan.chunks):
        r0, r1 = plan.chunk_rows(chunk)
        out.append([(r0 + i * tr, min(tr, r1 - r0 - i * tr)) for i in range(-(-(r1 - r0) // tr))])
    return out


def _apply_walk(plan):
    """Per block, per lane, the groups of rows one thread loads before it
    stores them, as gn_apply_kernel computes them: rows r0 + lane, r0 +
    lane + lanes, ... below r1, ``APPLY_ROWS`` at a time."""
    out = []
    for chunk in range(plan.chunks):
        r0, r1 = plan.chunk_rows(chunk)
        lanes = []
        for lane in range(plan.lanes):
            rows = list(range(r0 + lane, r1, plan.lanes))
            lanes.append([rows[i:i + G.APPLY_ROWS] for i in range(0, len(rows), G.APPLY_ROWS)])
        out.append(lanes)
    return out


@pytest.mark.parametrize("name,value", [("kTileBytes", G.TILE_BYTES), ("kStages", G.STAGES),
                                        ("kCluster", G.CLUSTER), ("kThreads", G.THREADS),
                                        ("kApplyThreads", G.APPLY_THREADS),
                                        ("kApplyRows", G.APPLY_ROWS)])
def test_stats_plan_constants_match_the_kernel_source(name, value):
    src = GROUP_NORM_CU.read_text()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)


@pytest.mark.parametrize("kernel", ["stats", "apply"])
@pytest.mark.parametrize("batch", [1, 6, 3, 8])  # 3 and 8: the self-training and DG teachers
@pytest.mark.parametrize("hw", [1, 31, 32, 33, 47, 48, 49, 97, *PATH_HW])
def test_chunk_walk_covers_every_row_once(hw, batch, kernel):
    for elem in (2, 4):
        # resident clusters (B2a) or SMs (B2b): 132 is the H100's SM count
        for resident in (1, 5, 32, 64) if kernel == "stats" else (1, 5, 132):
            plan = _plan(kernel, batch, hw, 256, elem, resident)
            if kernel == "stats":
                assert plan.chunks % G.CLUSTER == 0 and plan.clusters >= 1
                # the clusters of the whole batch fit on the card at once where they can
                assert batch * plan.clusters <= max(resident, batch)
            else:
                # APPLY_BLOCKS_PER_SM blocks a SM over the batch, at least one an
                # image, and no more than give every thread a row
                most = -(-hw // plan.lanes)
                assert 1 <= plan.chunks <= most and plan.grid == (plan.chunks, batch)
                assert (batch * plan.chunks >= G.APPLY_BLOCKS_PER_SM * resident
                        or plan.chunks == most)
                assert batch * (plan.chunks - 1) < G.APPLY_BLOCKS_PER_SM * resident
            counts = np.zeros(hw, np.int64)
            if kernel == "stats":
                for tiles in _walk(plan):
                    for start, rows in tiles:
                        assert 1 <= rows <= plan.tile_rows
                        counts[start:start + rows] += 1
            else:
                for lanes in _apply_walk(plan):
                    assert max(sum(map(len, g)) for g in lanes) <= plan.rows_per_thread
                    for groups in lanes:
                        for g in groups:
                            assert 1 <= len(g) <= G.APPLY_ROWS
                            counts[g] += 1
            assert (counts == 1).all(), (hw, batch, elem, resident)


@pytest.mark.parametrize("kernel", ["stats", "apply"])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("c", [32, 64, 96, 256, 512, 1024])
def test_bulk_spans_are_16_byte_aligned_multiples(c, elem, kernel):
    """B2a's bulk copies, and B2b's 16-byte loads and stores (its block's
    span of whole rows): 16-byte multiples at 16-byte aligned offsets."""
    for hw in (1, 31, 33, 8385):
        plan = _plan(kernel, 6, hw, c, elem, 32 if kernel == "stats" else 132)
        if kernel == "stats":
            spans = [span for tiles in _walk(plan) for span in tiles]
            for start, rows in spans:
                assert 0 < rows * c * elem <= G.TILE_BYTES
        else:
            spans = [(r0, r1 - r0) for r0, r1 in map(plan.chunk_rows, range(plan.chunks))]
            assert plan.threads * 16 % (c * elem) == 0 or plan.lanes == 1
        for start, rows in spans:
            assert (rows * c * elem) % 16 == 0
            for b in range(plan.batch):  # x's and y's bases are 16-byte aligned (checked)
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


SMEM_PER_SM = 233_472  # Hopper's shared memory of one SM (228 KB)
SMEM_RESERVED = 1024  # the system's share of it for each resident block
STATIC_SMEM = 256  # at least each kernel's static shared memory (its mbarriers; ptxas -v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_plan_fits_shared_memory_for_every_c(dtype):
    """Every C that group_norm_apply takes (C % 32 == 0, up to 1024 16-byte
    vectors a row): one thread per vector of a row, at most 1024 a block,
    every thread on one fixed channel vector, and shared memory for the
    image's mul/add alone: under the 48 KB that needs no opt-in, and small
    enough to land on a SM beside two B2a blocks holding their rings."""
    elem = torch.tensor([], dtype=dtype).element_size()
    beside_b2a = SMEM_PER_SM - 2 * (G.smem_bytes(256, elem) + STATIC_SMEM + SMEM_RESERVED)
    assert beside_b2a > SMEM_RESERVED
    for c in range(32, 1024 * 16 // elem + 1, 32):
        plan = G.apply_plan(1, 33153, c, elem, 132)
        nv = c * elem // 16
        assert plan.threads % nv == 0 and plan.threads <= 1024
        assert plan.threads == max(nv, G.APPLY_THREADS // nv * nv)
        assert plan.lanes * nv == plan.threads
        assert plan.smem == 2 * c * elem <= 32 * 1024
        assert plan.smem + STATIC_SMEM <= 48 * 1024
        assert plan.smem + STATIC_SMEM + SMEM_RESERVED <= beside_b2a, (c, plan)


@pytest.mark.parametrize("batch,hw,chunks,rows", [(1, 33153, 528, 8), (1, 8385, 528, 2),
                                                  (6, 7345, 88, 11), (3, 7345, 176, 6),
                                                  (8, 7345, 66, 14), (1, 15, 2, 1)])
def test_apply_plan_at_the_path_sites(batch, hw, chunks, rows):
    """bf16, C = 256, 132 SMs: 256 threads in 8 lanes of rows, 4 blocks a SM
    over the batch where the rows give each thread one."""
    plan = G.apply_plan(batch, hw, 256, 2, 132)
    assert plan.threads == 256 and plan.lanes == 8
    assert plan.grid == (chunks, batch) and plan.rows_per_thread == rows


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
