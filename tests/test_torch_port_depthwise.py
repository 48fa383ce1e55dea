"""The depthwise 3x3 conv of MiT-B5's sep-ASPP head (``diga_tpu_torch.ops.depthwise``).

The JAX package computes these convs as XLA convolutions, so the oracle
here is PyTorch's own ``F.conv2d(..., groups=C)`` and its autograd, in f32.
On the CPU the wrapper runs the plain versions:
  * the forward at dilations 1, 6, 12 and 18, maps smaller than the halo
    included, within 1e-5 (f32 sums in another order);
  * the input gradient is the forward fed dy and the weights turned by
    180°, against autograd's;
  * the weight gradient's per-block partials, folded, against autograd's
    dw within 1e-5 of Σ|dy·x| (the sums' magnitude);
  * the launch plan covers every output pixel and channel vector once at
    the head's sites, (6|3|1, 128, 224, 1024) in training and (1, 256, 512,
    1024), (1, 128, 256, 1024) in the eval, and at ragged widths; its
    constants are depthwise.cu's, read from the source;
  * the refusals, the span around a copied dy, MiT's state_dict keys.
On the card (``cuda`` marker; they skip here): the kernels against the
plain versions in bf16 and f32 at the path's shapes, three calls bitwise
equal.  chip_smoke.py repeats those checks and times the kernels.
"""

import pathlib
import re

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from diga_tpu_torch.models import mit_daformer
from diga_tpu_torch.ops import depthwise as D
from diga_tpu_torch.utils import profiling

SRC = pathlib.Path(D.__file__).resolve().parents[1] / "csrc" / "depthwise.cu"
DILATIONS = [1, 6, 12, 18]
# (b, c, h, w): a ragged map, and one smaller than the largest halo
SHAPES = [(2, 16, 9, 13), (1, 8, 5, 7)]
TINY = {"embed_dims": (32, 64, 160, 256), "num_heads": (1, 2, 5, 8), "depths": (1, 1, 1, 1),
        "sr_ratios": (8, 4, 2, 1), "mlp_ratio": 4, "drop_path_rate": 0.1, "head_channels": 64,
        "aspp_dilations": (1, 6, 12, 18)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, seed=0, dtype=torch.float32, device="cpu"):
    b, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g).contiguous(memory_format=torch.channels_last)
    wt = torch.randn((c, 1, 3, 3), generator=g)
    dy = torch.randn((b, c, h, w), generator=g).contiguous(memory_format=torch.channels_last)
    return x.to(device, dtype), wt.to(device, dtype), dy.to(device, dtype)


def _autograd(x, wt, dy, d):
    x, wt = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    y = F.conv2d(x, wt, padding=d, dilation=d, groups=x.shape[1])
    y.backward(dy)
    return y.detach(), x.grad, wt.grad


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", DILATIONS)
def test_plain_forward_matches_conv2d(shape, d):
    x, wt, dy = _inputs(shape, seed=d)
    y, _, _ = _autograd(x, wt, dy, d)
    out = D.depthwise_conv3x3_plain(x, wt, d)
    assert out.is_contiguous(memory_format=torch.channels_last) and out.dtype == x.dtype
    torch.testing.assert_close(out, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", DILATIONS)
def test_input_gradient_is_the_rotated_weight_forward(shape, d):
    x, wt, dy = _inputs(shape, seed=10 + d)
    _, dx, _ = _autograd(x, wt, dy, d)
    torch.testing.assert_close(D.depthwise_conv3x3_plain(dy, wt, d, rotate=True), dx,
                               rtol=1e-5, atol=1e-5)


def _wgrad_scale(x, dy, d):
    """Σ|dy·x| per (c, tap): the magnitude the f32 sums are taken over."""
    return D.depthwise_wgrad_plain(x.abs(), dy.abs(), d)


@pytest.mark.parametrize("shape", SHAPES + [(3, 24, 20, 30)])
@pytest.mark.parametrize("d", DILATIONS)
def test_plain_weight_gradient_folds_to_autograds(shape, d):
    x, wt, dy = _inputs(shape, seed=20 + d)
    _, _, dw = _autograd(x, wt, dy, d)
    # a few blocks of partials at this size: fold them as the kernel does
    got = D.depthwise_wgrad_plain(x, dy, d, sm_count=1)
    assert got.shape == dw.shape and got.dtype == x.dtype
    assert bool(((got - dw).abs() <= 1e-5 * _wgrad_scale(x, dy, d) + 1e-7).all())


@pytest.mark.parametrize("d", [1, 12])
def test_function_gradients_match_autograd(d):
    D.reset_launches()
    x, wt, dy = _inputs((2, 16, 9, 13), seed=30 + d)
    y_ref, dx_ref, dw_ref = _autograd(x, wt, dy, d)
    xg, wg = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    y = D.depthwise_conv3x3(xg, wg, d)
    y.backward(dy)
    torch.testing.assert_close(y.detach(), y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xg.grad, dx_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wg.grad, dw_ref, rtol=1e-5, atol=1e-4)
    assert D.launches == {"depthwise_fwd": 0, "depthwise_wgrad": 0}  # the CPU launches nothing


def test_autocast_casts_map_and_weight_and_the_f32_parameter_gets_the_gradient():
    x, wt, dy = _inputs((2, 16, 9, 13), seed=40)
    wg = wt.clone().requires_grad_(True)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = D.depthwise_conv3x3(x, wg, 6)
    assert y.dtype == torch.bfloat16
    y.backward(dy.to(torch.bfloat16))
    assert wg.grad.dtype == torch.float32
    want = D.depthwise_wgrad_plain(x.to(torch.bfloat16), dy.to(torch.bfloat16), 6)
    assert torch.equal(wg.grad, want.float())


def test_a_dy_that_is_not_channels_last_is_copied_inside_a_span():
    x, wt, dy = _inputs((2, 16, 9, 13), seed=41)
    xg = x.clone().requires_grad_(True)
    with profiling.recording() as rec:
        y = D.depthwise_conv3x3(xg, wt, 6)
        y.backward(dy.contiguous())  # NCHW
    assert rec.counts["depthwise_dy_copy"] == 1
    assert "depthwise_dy_copy" in {s[0] for s in rec.spans}
    _, dx, _ = _autograd(x, wt, dy, 6)
    torch.testing.assert_close(xg.grad, dx, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

PLAN_SITES = [(6, 128, 224, 1024), (3, 128, 224, 1024), (1, 128, 224, 1024),
              (1, 256, 512, 1024), (1, 128, 256, 1024), (2, 7, 13, 24), (1, 5, 97, 40)]


@pytest.mark.parametrize("name,value", [("kThreads", D.THREADS),
                                        ("kBlocksPerSm", D.BLOCKS_PER_SM), ("kRun", D.RUN),
                                        ("kFoldThreads", D.FOLD_THREADS), ("kTaps", D.TAPS)])
def test_plan_constants_match_the_kernel_source(name, value):
    src = SRC.read_text()
    assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)


@pytest.mark.parametrize("shape", PLAN_SITES)
def test_plan_covers_every_output_and_channel_vector_once(shape):
    b, h, w, c = shape
    for d in (1, 6, 12, 18):
        plan = D.launch_plan(shape, d, 2, 132)
        seen = torch.zeros((b, h, w), dtype=torch.int32)
        for u in range(plan.units):
            ub, uh, cols = D.unit_outputs(plan, u)
            assert len(cols) <= plan.run <= D.RUN
            seen[ub, uh, cols] += 1
        assert bool((seen == 1).all()), (shape, d)
        units = D.position_units(plan)
        for u in (0, plan.units // 2, plan.units - 1):
            ub, uh, cols = D.unit_outputs(plan, u)
            assert bool((units[ub, uh, cols] == u).all())
        for elem in (2, 4):
            p = D.launch_plan(shape, d, elem, 132)
            # the same units; a persistent grid of at most one block a unit
            assert (p.units, p.classes, p.segs, p.run) == (plan.units, plan.classes,
                                                           plan.segs, plan.run)
            assert p.blocks == min(p.units, D.BLOCKS_PER_SM * 132)
            # blocks x slices of threads take each channel vector once
            nvec = c // p.vec
            vectors = [s * p.threads + t for s in range(p.slices) for t in range(p.threads)]
            assert sorted(v for v in vectors if v < nvec) == list(range(nvec))
            assert p.threads <= D.THREADS and p.slices == -(-nvec // p.threads)


def test_the_heads_sites_take_whole_blocks_of_channels():
    for shape in PLAN_SITES[:5]:
        plan = D.launch_plan(shape, 18, 2, 132)
        assert (plan.threads, plan.slices, plan.vec) == (128, 1, 8)


# ---------------------------------------------------------------------------
# refusals and the model
# ---------------------------------------------------------------------------

def test_refusals():
    x, wt, _ = _inputs((2, 16, 9, 13))
    with pytest.raises(ValueError, match="channels_last"):
        D.depthwise_conv3x3(x.contiguous(), wt, 6)
    with pytest.raises(TypeError, match="dtype"):
        D.depthwise_conv3x3(x.half(), wt.half(), 6)
    with pytest.raises(TypeError, match="dtype"):
        D.depthwise_conv3x3(x, wt.double(), 6)
    with pytest.raises(ValueError, match="3x3"):
        D.depthwise_conv3x3(x, torch.zeros(16, 1, 5, 5), 6)
    with pytest.raises(ValueError, match="3x3"):
        D.depthwise_conv3x3(x, torch.zeros(16, 2, 3, 3), 6)
    xb = _inputs((1, 12, 4, 4), dtype=torch.bfloat16)[0]
    with pytest.raises(ValueError, match="multiples of 8"):
        D._check_kernel(xb)
    with pytest.raises(ValueError, match="depthwise 3x3 conv without bias"):
        mit_daformer.DepthwiseConv3x3(8, 8, 3, padding=1, dilation=2, groups=8, bias=False)


def test_mit_state_dict_keys_are_unchanged(monkeypatch):
    ours = mit_daformer.MiTDAFormer(19, TINY)
    convs = [m for m in ours.modules() if isinstance(m, mit_daformer.DepthwiseConv3x3)]
    assert [c.dilation for c in convs] == [(6, 6), (12, 12), (18, 18)]
    # Mix-FFN's depthwise convs keep nn.Conv2d
    assert all(type(m.dwconv) is nn.Conv2d for m in ours.modules()
               if isinstance(m, mit_daformer.DWConv))
    monkeypatch.setattr(mit_daformer, "DepthwiseConv3x3", nn.Conv2d)
    plain = mit_daformer.MiTDAFormer(19, TINY)
    want = {k: tuple(v.shape) for k, v in plain.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in ours.state_dict().items()} == want
    assert "decode_head.fuse_layer.aspp_modules.1.depthwise_conv.conv.weight" in want
    ours.load_state_dict(plain.state_dict(), strict=True)


def test_the_head_computes_what_nn_conv2d_computed(monkeypatch):
    ours = mit_daformer.MiTDAFormer(19, TINY).eval()
    monkeypatch.setattr(mit_daformer, "DepthwiseConv3x3", nn.Conv2d)
    plain = mit_daformer.MiTDAFormer(19, TINY).eval()
    plain.load_state_dict(ours.state_dict())
    x = torch.randn((1, 3, 32, 64), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got, want = ours(x)[2], plain(x)[2]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_SITES = [((6, 1024, 128, 224), 18), ((3, 1024, 128, 224), 6), ((1, 1024, 128, 256), 12),
              ((2, 40, 9, 13), 18), ((1, 1032, 5, 7), 6)]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(torch.finfo(torch.float32).tiny))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("site", CARD_SITES, ids=[str(s) for s in CARD_SITES])
def test_cuda_kernels_match_plain(site, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    (b, c, h, w), d = site
    x, wt, dy = _inputs((b, c, h, w), seed=50, dtype=dtype, device="cuda")
    ys = [D.depthwise_conv3x3_kernel(x, wt, d) for _ in range(3)]
    dxs = [D.depthwise_conv3x3_kernel(dy, wt, d, rotate=True) for _ in range(3)]
    dws = [D.depthwise_wgrad_kernel(x, dy, d) for _ in range(3)]
    torch.cuda.synchronize()
    for outs in (ys, dxs, dws):
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    for got, want in ((ys[0], D.depthwise_conv3x3_plain(x, wt, d)),
                      (dxs[0], D.depthwise_conv3x3_plain(dy, wt, d, rotate=True))):
        # f32 sums in another order (fma): 1e-5 of the largest output, and in
        # bf16 one ulp more where they straddle a rounding boundary
        err = (got.float() - want.float()).abs()
        tol = 1e-5 * want.float().abs().max()
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(want.float())
        assert bool((err <= tol).all())
    want = D.depthwise_wgrad_plain(x, dy, d).float()
    scale = D.depthwise_wgrad_plain(x.abs(), dy.abs(), d).float()
    tol = 1e-5 * scale + (_bf16_ulp(want) if dtype == torch.bfloat16 else 0)
    assert bool(((dws[0].float() - want).abs() <= tol).all())
