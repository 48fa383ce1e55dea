"""Depthwise 3x3 convolution: hand-written CUDA ``autograd.Function`` + plain version.

The dilated depthwise convs of DAFormer's sep-ASPP head
(``models/mit_daformer.py::DepthwiseSeparableConvModule``) run here, not in
cuDNN.  It replaces no TPU kernel: ``diga_tpu`` leaves convolutions to XLA.

``depthwise_conv3x3(x, weight, dilation)`` computes
``F.conv2d(x, weight, padding=dilation, dilation=dilation, groups=C)``:
stride 1, zero padding ``dilation``, no bias.  ``x`` is an NCHW map in
channels_last (NHWC in memory), ``weight`` (C, 1, 3, 3).  Under autocast
the map and the weight are cast to the autocast dtype first, as autocast
casts a conv's; autograd carries the weight's gradient back through that
cast to the f32 parameter.  On CUDA tensors it launches the kernels of
``diga_tpu_torch/csrc/depthwise.cu`` or raises; on CPU tensors it runs the
plain versions, which compute the same sums with PyTorch ops.  Either way
it raises on a map that is not channels_last, a dtype other than float32
or bfloat16, or a kernel other than 3x3.

Backward: the input gradient is the same kernel fed ``dy`` and the weights
turned by 180°; the weight gradient is per-block f32 partials over the
plan's units, folded in block order.  A ``dy`` that is not channels_last is
copied first, inside the span ``depthwise_dy_copy`` (also a tally).

Each wrapper adds one to ``launches[<name>]`` when it launches:
``depthwise_fwd`` for the forward and the input gradient,
``depthwise_wgrad`` for the weight gradient (partials, then the fold).
``launch_plan`` lays out the walk and the grid; it is plain Python, so the
CPU tests hold it, and the plain weight gradient sums over the same blocks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..utils.profiling import count, span
from . import native

launches = {"depthwise_fwd": 0, "depthwise_wgrad": 0}

# depthwise.cu's kThreads (channel vectors a block), kBlocksPerSm (the
# persistent grid's resident blocks a multiprocessor), kRun (the most
# outputs of one run along a row) and kFoldThreads
THREADS = 128
BLOCKS_PER_SM = 3
RUN = 32
FOLD_THREADS = 256
TAPS = 9
# the plain weight gradient's plan on the CPU: the H100's multiprocessors
PLAIN_SM_COUNT = 132


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("depthwise")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    walk = [ll, i, i, i, i, i, i, i, i, i, i]  # units, h, w, c, d, classes .. threads
    lib.depthwise_conv3x3.argtypes = [i, p, p, *walk, i, p, p]
    lib.depthwise_conv3x3.restype = i
    lib.depthwise_wgrad.argtypes = [i, p, p, *walk, p, p, p]
    lib.depthwise_wgrad.restype = i
    return lib


# ---------------------------------------------------------------------------
# the launch plan (plain Python: the CPU tests hold it)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    b: int
    h: int
    w: int
    c: int
    dilation: int
    vec: int        # channels in a 16-byte vector
    threads: int    # channel vectors a block
    slices: int     # blocks across the channel vectors (grid y)
    classes: int    # residues of a column mod d that hold a column
    segs: int       # runs a residue
    run: int        # outputs a run (a residue's last may be shorter)
    units: int      # b · h · classes · segs
    blocks: int     # grid x: block i takes units i, i + blocks, ...

    def walk_args(self) -> tuple:
        return (self.units, self.h, self.w, self.c, self.dilation, self.classes, self.segs,
                self.run, self.blocks, self.slices, self.threads)

    def describe(self) -> str:
        return (f"grid={self.blocks}x{self.slices} threads={self.threads} units={self.units} "
                f"residues={self.classes} runs={self.segs}x{self.run}")


def launch_plan(shape, dilation: int, elem: int, sm_count: int) -> LaunchPlan:
    """The walk and grid of the forward and the weight gradient over an
    NHWC ``shape`` (b, h, w, c) of ``elem``-byte values.

    A unit is (image, row, residue r of the column mod d, run); run s of
    residue r covers the output columns r + k·d for k in [s·run,
    (s+1)·run).  The grid is persistent, ``BLOCKS_PER_SM`` blocks a
    multiprocessor (at most one a unit), block i taking units i, i +
    blocks, ...; each weight-gradient block writes one partial."""
    b, h, w, c = shape
    vec = 16 // elem
    nvec = c // vec
    threads = min(nvec, THREADS)
    slices = -(-nvec // threads)
    classes = min(dilation, w)
    n0 = -(-w // dilation)  # columns of residue 0, the most of any
    segs = -(-n0 // RUN)
    run = -(-n0 // segs)
    units = b * h * classes * segs
    return LaunchPlan(b=b, h=h, w=w, c=c, dilation=dilation, vec=vec, threads=threads,
                      slices=slices, classes=classes, segs=segs, run=run, units=units,
                      blocks=min(units, BLOCKS_PER_SM * sm_count))


def unit_outputs(plan: LaunchPlan, u: int) -> tuple[int, int, list[int]]:
    """(image, row, output columns) of unit ``u``, as depthwise.cu decodes it."""
    s, t = u % plan.segs, u // plan.segs
    r, t = t % plan.classes, t // plan.classes
    h, b = t % plan.h, t // plan.h
    n = -(-(plan.w - r) // plan.dilation)
    return b, h, [r + k * plan.dilation for k in range(s * plan.run, min((s + 1) * plan.run, n))]


def position_units(plan: LaunchPlan, device=None) -> torch.Tensor:
    """(b, h, w) int64: the unit of each output pixel."""
    d = plan.dilation
    col = torch.arange(plan.w, device=device)
    r, s = col % d, (col // d) // plan.run
    bh = torch.arange(plan.b * plan.h, device=device).view(plan.b, plan.h, 1)
    return (bh * plan.classes + r) * plan.segs + s


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _check(x: torch.Tensor, weight: torch.Tensor, dilation: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"depthwise_conv3x3: expected an NCHW map, got {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(weight.shape) != (c, 1, 3, 3):
        raise ValueError(f"depthwise_conv3x3: takes a depthwise 3x3 weight ({c}, 1, 3, 3), "
                         f"got {tuple(weight.shape)}")
    if x.dtype not in native.DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError(f"depthwise_conv3x3: map and weight must share dtype float32 or "
                        f"bfloat16, got {x.dtype} and {weight.dtype}")
    if x.device != weight.device:
        raise ValueError(f"depthwise_conv3x3: map on {x.device}, weight on {weight.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("depthwise_conv3x3: the map must be channels_last contiguous")
    if dilation < 1 or x.numel() == 0:
        raise ValueError(f"depthwise_conv3x3: dilation {dilation} on {tuple(x.shape)}")


def _check_kernel(*maps: torch.Tensor) -> None:
    """The kernels' 16-byte vectors: C a multiple of 16 bytes, aligned maps."""
    x = maps[0]
    vec = 16 // x.element_size()
    if x.shape[1] % vec or any(m.data_ptr() % 16 for m in maps):
        raise ValueError(f"depthwise_conv3x3: the kernel takes channels in multiples of {vec} "
                         f"and 16-byte aligned maps, got {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# plain versions (PyTorch ops; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _padded_f32(x: torch.Tensor, d: int) -> torch.Tensor:
    return F.pad(_nhwc(x).float(), (0, 0, d, d, d, d))


def _tap(xp: torch.Tensor, i: int, j: int, d: int, h: int, w: int) -> torch.Tensor:
    """The padded NHWC map shifted to tap (i, j): rows h + (i - 1)·d."""
    return xp[:, i * d:i * d + h, j * d:j * d + w, :]


def depthwise_conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, dilation: int,
                            rotate: bool = False) -> torch.Tensor:
    """The 9 taps summed in f32 in tap order, rounded once to x's dtype;
    ``rotate``: the weights turned by 180° (the input gradient, x = dy)."""
    b, c, h, w = x.shape
    xp = _padded_f32(x, dilation)
    wt = weight.reshape(c, TAPS).float()
    if rotate:
        wt = wt.flip(1)
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
    for t in range(TAPS):
        acc = acc + wt[:, t] * _tap(xp, t // 3, t % 3, dilation, h, w)
    return acc.to(x.dtype).permute(0, 3, 1, 2)


def depthwise_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, dilation: int,
                          sm_count: int = PLAIN_SM_COUNT) -> torch.Tensor:
    """dw (C, 1, 3, 3) in x's dtype: each tap's products summed in f32 into
    the partial of the block (``launch_plan``) that owns the output pixel,
    then the partials summed."""
    b, c, h, w = x.shape
    plan = launch_plan((b, h, w, c), dilation, x.element_size(), sm_count)
    block = (position_units(plan, x.device) % plan.blocks).reshape(-1)
    xp, g = _padded_f32(x, dilation), _nhwc(dy).float()
    part = torch.zeros((plan.blocks, TAPS, c), dtype=torch.float32, device=x.device)
    for t in range(TAPS):
        prod = (g * _tap(xp, t // 3, t % 3, dilation, h, w)).reshape(-1, c)
        part[:, t].index_add_(0, block, prod)
    return part.sum(0).t().reshape(c, 1, 3, 3).to(x.dtype)


# ---------------------------------------------------------------------------
# kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _plan(x: torch.Tensor, dilation: int) -> LaunchPlan:
    b, c, h, w = x.shape
    return launch_plan((b, h, w, c), dilation, x.element_size(), native.sm_count(x.device.index))


def depthwise_conv3x3_kernel(x: torch.Tensor, weight: torch.Tensor, dilation: int,
                             rotate: bool = False) -> torch.Tensor:
    """The forward (``rotate``: the input gradient) on the card."""
    _check_kernel(x)
    weight = weight.contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    plan = _plan(x, dilation)
    err = native.launch(x, _lib().depthwise_conv3x3, native.DTYPE_CODES[x.dtype], x.data_ptr(),
                        weight.data_ptr(), *plan.walk_args(), int(rotate), y.data_ptr())
    if err:
        raise RuntimeError(f"depthwise_conv3x3 kernel launch failed: CUDA error {err}")
    launches["depthwise_fwd"] += 1
    return y


def depthwise_wgrad_kernel(x: torch.Tensor, dy: torch.Tensor, dilation: int) -> torch.Tensor:
    """dw (C, 1, 3, 3) in x's dtype on the card (partials, then the fold)."""
    _check_kernel(x, dy)
    b, c, h, w = x.shape
    plan = _plan(x, dilation)
    part = torch.empty((plan.blocks, TAPS, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((c, 1, 3, 3), dtype=x.dtype, device=x.device)
    err = native.launch(x, _lib().depthwise_wgrad, native.DTYPE_CODES[x.dtype], x.data_ptr(),
                        dy.data_ptr(), *plan.walk_args(), part.data_ptr(), dw.data_ptr())
    if err:
        raise RuntimeError(f"depthwise_wgrad kernel launch failed: CUDA error {err}")
    launches["depthwise_wgrad"] += 1
    return dw


class Depthwise3x3(torch.autograd.Function):
    """forward(x, weight, dilation) -> y; backward -> (dx, dw, None).
    Saves x and the weight."""

    @staticmethod
    def forward(ctx, x, weight, dilation):
        _check(x, weight, dilation)
        ctx.save_for_backward(x, weight)
        ctx.dilation = dilation
        if native.on_cpu(x):
            return depthwise_conv3x3_plain(x, weight, dilation)
        return depthwise_conv3x3_kernel(x, weight, dilation)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        d = ctx.dilation
        if not dy.is_contiguous(memory_format=torch.channels_last):
            count("depthwise_dy_copy")
            with span("depthwise_dy_copy"):
                dy = dy.contiguous(memory_format=torch.channels_last)
        dx = dw = None
        cpu = native.on_cpu(dy)
        if ctx.needs_input_grad[0]:
            dx = (depthwise_conv3x3_plain(dy, weight, d, rotate=True) if cpu
                  else depthwise_conv3x3_kernel(dy, weight, d, rotate=True))
        if ctx.needs_input_grad[1]:
            dw = depthwise_wgrad_plain(x, dy, d) if cpu else depthwise_wgrad_kernel(x, dy, d)
        return dx, dw, None


def depthwise_conv3x3(x: torch.Tensor, weight: torch.Tensor, dilation: int) -> torch.Tensor:
    """``F.conv2d(x, weight, padding=dilation, dilation=dilation, groups=C)``
    on a channels_last map, by the port's kernels on the card."""
    if torch.is_autocast_enabled(x.device.type) and x.is_floating_point():
        dtype = torch.get_autocast_dtype(x.device.type)
        x, weight = x.to(dtype), weight.to(dtype)
    return Depthwise3x3.apply(x, weight, dilation)
