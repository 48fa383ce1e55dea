"""The port's distillation loss (diga_tpu_torch.ops.distill) against the JAX package.

On the CPU ``distillation_loss`` runs its autograd.Function with the plain
versions; the same numpy-seeded logits go through
``diga_tpu.ops.losses.distillation_loss`` (the XLA form) and, in interpret
mode, ``distillation_loss_pallas``.  Tolerances are those of
tests/test_pallas_kernels.py: the value at rel 1e-5, the gradient at
atol 1e-5 / rtol 1e-4 (f32 sums in another order).  The CUDA kernels are
held against the plain versions on the card (``cuda`` marker; chip_smoke.py
does the same at the warm-up path's shape).
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.ops.losses import distillation_loss as jax_distill
from diga_tpu.ops.pallas_kernels import distillation_loss_pallas
from diga_tpu_torch.ops import distill as D
from diga_tpu_torch.ops.losses import distillation_loss as port_distill_autograd

# (2B, H, W, K): a 1024-aligned pixel count, a ragged one (7·13 per half),
# and K=16 (SYNTHIA)
SHAPES = [(4, 8, 32, 19), (2, 7, 13, 19), (2, 9, 11, 16)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    t = (rng.normal(size=shape) * 2).astype(np.float32)
    s = (rng.normal(size=shape) * 2).astype(np.float32)
    return t, s


def _jax_value_and_grad(fn, t, s, scale):
    val, g = jax.value_and_grad(lambda s_: fn(jnp.asarray(t), s_, scale))(jnp.asarray(s))
    return float(val), np.asarray(g)


def _port_value_and_grad(t, s, scale, loss_fn=D.distillation_loss):
    tt = torch.from_numpy(t)
    st = torch.from_numpy(s).requires_grad_(True)
    loss = loss_fn(tt, st, scale)
    loss.backward()
    return loss.detach(), st.grad


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_value_and_grad_match_jax(shape, reference):
    t, s = _inputs(shape, seed=sum(shape))
    fn = jax_distill if reference == "xla" else distillation_loss_pallas
    ref_val, ref_grad = _jax_value_and_grad(fn, t, s, 0.5)
    loss, grad = _port_value_and_grad(t, s, 0.5)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(loss) == pytest.approx(ref_val, rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-5, rtol=1e-4)


def test_channels_last_logits_are_read_as_they_lie():
    """The model's (2B, K, H, W) channels_last logits permuted to NHWC are a
    contiguous view; the loss of that view equals the loss of a copy."""
    t, s = _inputs((2, 7, 13, 19), seed=5)
    t_nchw = torch.from_numpy(t).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    s_nchw = torch.from_numpy(s).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    s_nchw.requires_grad_(True)
    t_view, s_view = t_nchw.permute(0, 2, 3, 1), s_nchw.permute(0, 2, 3, 1)
    assert t_view.is_contiguous() and s_view.is_contiguous()
    loss = D.distillation_loss(t_view, s_view, 0.5)
    loss.backward()
    loss = loss.detach()
    ref_val, ref_grad = _jax_value_and_grad(jax_distill, t, s, 0.5)
    assert float(loss) == pytest.approx(ref_val, rel=1e-5)
    np.testing.assert_allclose(s_nchw.grad.permute(0, 2, 3, 1).numpy(), ref_grad,
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_function_backward_matches_autograd_of_plain_ops(scale):
    t, s = _inputs((4, 5, 9, 19), seed=11)
    loss, grad = _port_value_and_grad(t, s, scale)
    ref_loss, ref_grad = _port_value_and_grad(t, s, scale, port_distill_autograd)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    torch.testing.assert_close(grad, ref_grad, atol=1e-6, rtol=1e-5)


def test_teacher_gets_no_gradient():
    t, s = _inputs((2, 4, 8, 19), seed=2)
    tt = torch.from_numpy(t).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    D.distillation_loss(tt, st, 0.5).backward()
    assert tt.grad is None
    assert st.grad is not None and bool(st.grad.abs().sum() > 0)


def test_bf16_grad_in_the_students_dtype():
    t, s = _inputs((2, 7, 13, 19), seed=3)
    tt = torch.from_numpy(t).bfloat16()
    st = torch.from_numpy(s).bfloat16().requires_grad_(True)
    loss = D.distillation_loss(tt, st, 0.5)
    loss.backward()
    loss = loss.detach()
    assert loss.dtype == torch.float32 and st.grad.dtype == torch.bfloat16
    ref_val, ref_grad = _jax_value_and_grad(
        jax_distill, tt.float().numpy(), st.detach().float().numpy(), 0.5)
    assert float(loss) == pytest.approx(ref_val, rel=1e-5)
    # one bf16 rounding of the gradient
    np.testing.assert_allclose(st.grad.float().numpy(), ref_grad,
                               atol=1e-2 * np.abs(ref_grad).max(), rtol=1e-2)


@pytest.mark.parametrize("bad", ["layout", "odd_batch", "dtype", "mixed_dtype", "wide"])
def test_raises_on_unsupported_input(bad):
    t, s = _inputs((2, 4, 5, 19))
    tt, st = torch.from_numpy(t), torch.from_numpy(s)
    if bad == "layout":  # NCHW-contiguous memory viewed as NHWC
        st = st.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif bad == "odd_batch":
        tt, st = tt[:1], st[:1]
    elif bad == "dtype":
        tt, st = tt.half(), st.half()
    elif bad == "mixed_dtype":
        st = st.bfloat16()
    else:  # 40 classes: more than the kernel keeps in registers
        tt, st = tt.repeat(1, 1, 1, 3)[..., :40], st.repeat(1, 1, 1, 3)[..., :40]
        tt, st = tt.contiguous(), st.contiguous()
    with pytest.raises((ValueError, TypeError)):
        D.distillation_loss(tt, st, 0.5)


def test_launch_counter_stays_zero_on_cpu():
    D.reset_launches()
    _port_value_and_grad(*_inputs((2, 4, 5, 19)), 0.5)
    assert D.launches == {"distill_loss": 0, "distill_grad": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 7, 13, 19),
                                   (6, 512, 1024, 19)])  # the semiseg warm-up/self-training site
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    t, s = _inputs(shape, seed=9)
    tt = torch.from_numpy(t).to("cuda", dtype)
    st = torch.from_numpy(s).to("cuda", dtype)
    g = torch.tensor(0.75, device="cuda")
    before = dict(D.launches)
    loss = D.distillation_loss_kernel(tt, st, 0.5)
    loss2 = D.distillation_loss_kernel(tt, st, 0.5)
    ds = D.distillation_grad_kernel(tt, st, g, 0.5)
    ds2 = D.distillation_grad_kernel(tt, st, g, 0.5)
    ref = D.distillation_loss_plain(tt, st, 0.5)
    ref_ds = D.distillation_grad_plain(tt, st, g, 0.5)
    torch.cuda.synchronize()
    assert D.launches["distill_loss"] == before["distill_loss"] + 2
    assert D.launches["distill_grad"] == before["distill_grad"] + 2
    assert torch.equal(loss, loss2) and torch.equal(ds, ds2)
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    assert ds.dtype == dtype
    scale = float(ref_ds.float().abs().max())
    # f32: 1e-5 of the largest gradient; bf16: one bf16 ulp at the largest
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** (math.floor(math.log2(scale)) - 7)
    torch.testing.assert_close(ds.float(), ref_ds.float(), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the kernels' launch plan (pure Python, ops/distill.py::launch_plan)
# ---------------------------------------------------------------------------

MAIN_NPIX = 3 * 512 * 896  # the warm-up path's (6, 512, 896, 19): pixels per view
DG_NPIX = 4 * 512 * 896  # the DG path's (8, 512, 896, 19)
SEMISEG_NPIX = 3 * 512 * 1024  # the semiseg paths' (6, 512, 1024, 19)
SMS = 132  # H100 SXM
ALIGNED = 0x7F00_0000_0000  # a 16-byte aligned device address
DISTILL_CU = pathlib.Path(D.__file__).resolve().parents[1] / "csrc" / "distill.cu"


def _plan(npix, k=19, elem=2, backward=False, ptrs=(ALIGNED,) * 3):
    return D.launch_plan(npix, k, elem, SMS, ptrs[:3 if backward else 2], backward)


def _tile_walk(npix, plan):
    """Per block, the [start, stop) pixel ranges it takes, in its order, as
    distill.cu's ``Walk`` takes them (block b: tiles b, b + grid, ...).
    This holds the plan's grid and tile count; that the kernels themselves
    cover every pixel once is shown on the card (chip_smoke.py phase 3:
    under one tile, whole tiles, ragged)."""
    r = plan.tile
    return [[(i * r, min((i + 1) * r, npix)) for i in range(b, plan.n_tiles, plan.grid)]
            for b in range(plan.grid)]


@pytest.mark.parametrize("name,value", [("kTileBytes", D.TILE_BYTES), ("kStages", D.STAGES)])
def test_plan_constants_match_the_kernel_source(name, value):
    src = DISTILL_CU.read_text()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("elem", [2, 4])
def test_tile_walk_covers_every_pixel_once(elem, backward):
    r = _plan(MAIN_NPIX, elem=elem, backward=backward).tile
    for npix in (1, 7, r - 1, r, r + 1, MAIN_NPIX, DG_NPIX, SEMISEG_NPIX):
        plan = _plan(npix, elem=elem, backward=backward)
        assert plan.tile == r and plan.n_tiles == -(-npix // r)
        walk = _tile_walk(npix, plan)
        assert len(walk) == plan.grid and all(walk)  # no block without a tile
        counts = np.zeros(npix, np.int64)
        for ranges in walk:
            assert ranges == sorted(ranges)  # each block walks forward
            for start, stop in ranges:
                assert stop - start <= r
                counts[start:stop] += 1
        assert (counts == 1).all(), npix


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("elem", [2, 4])
def test_plan_fits_shared_memory_for_every_k(elem, backward):
    for k in range(1, D.MAX_CLASSES + 1):
        plan = _plan(MAIN_NPIX, k=k, elem=elem, backward=backward)
        # the ring of STAGES input tiles (four spans each) and, backward, the ds tile
        assert plan.smem == (4 * D.STAGES + 2 * backward) * plan.tile * k * elem
        assert plan.smem <= 232_448, (k, plan)
        assert plan.tile % 8 == 0 and plan.tile % 32 == 0 and 2 * plan.tile <= 1024
        assert (plan.tile * k * elem) % 16 == 0  # every tile starts a 16-byte chunk
        assert 1 <= plan.grid <= SMS * (D.THREADS_PER_SM // plan.threads)
        per_sm = -(-plan.grid // SMS)
        assert per_sm * (plan.smem + D.SMEM_RESERVED_PER_BLOCK) <= D.SMEM_PER_SM


@pytest.mark.parametrize("npix,k,elem,offsets,backward,vec", [
    (MAIN_NPIX, 19, 2, (0, 0), False, True),  # the path's shape: aug half at byte 52,297,728
    (MAIN_NPIX, 19, 2, (0, 0, 0), True, True),
    (MAIN_NPIX, 19, 2, (2, 0), False, False),  # teacher base 2 bytes past alignment
    (MAIN_NPIX, 19, 2, (0, 8), False, False),
    (MAIN_NPIX, 19, 2, (0, 0, 2), True, False),  # ds base off alignment
    (MAIN_NPIX, 19, 2, (16, 32, 48), True, True),
    (91, 19, 2, (0, 0), False, False),  # (2, 7, 13, 19) bf16: aug half at byte 91·38
    (91, 19, 4, (0, 0, 0), True, False),  # f32: 91·76 = 6916
    (99, 16, 2, (0, 0), False, True),  # (2, 9, 11, 16): 99·32 bytes
    (4, 19, 4, (0, 0), False, True),  # 4·76 = 304 bytes
    (5, 32, 2, (0, 0, 0), True, True),  # K=32 bf16: 64-byte rows
    (1, 19, 2, (0, 0), False, False),
    (DG_NPIX, 19, 2, (0, 0), False, True),  # the DG path's shape: aug half at byte 69,730,304
    (DG_NPIX, 19, 2, (0, 0, 0), True, True),
    (SEMISEG_NPIX, 19, 2, (0, 0), False, True),  # semiseg: aug half at byte 59,768,832
    (SEMISEG_NPIX, 19, 4, (0, 0, 0), True, True),
])
def test_16_byte_path_exactly_when_spans_are_aligned(npix, k, elem, offsets, backward, vec):
    ptrs = tuple(ALIGNED + o for o in offsets)
    plan = D.launch_plan(npix, k, elem, SMS, ptrs, backward)
    assert plan.vec is vec
    assert vec == ((npix * k * elem) % 16 == 0 and all(p % 16 == 0 for p in ptrs))
