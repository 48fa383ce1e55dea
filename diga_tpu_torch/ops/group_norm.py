"""GroupNorm forward over NHWC activations: hand-written CUDA kernel + plain version.

Counterpart of ``diga_tpu/ops/pallas_gn.py``, the Pallas pair
``_stats_kernel`` (B2a) and ``_norm_kernel`` (B2b).  In the port it is the
GroupNorm of the ASPP head wherever no gradient is needed: the eval
forward (six sites per scale) and the warm-up step's EMA teacher (six
sites per step).

``group_norm(x, scale, bias)`` takes the JAX layout: ``x`` is a contiguous
NHWC tensor, i.e. a channels_last NCHW activation permuted to NHWC (a view,
no copy).  On a CUDA tensor it launches the kernels of
``diga_tpu_torch/csrc/group_norm.cu`` or raises; on a CPU tensor it runs
the plain version, which repeats the kernel's arithmetic with PyTorch ops:
the FusedGroupNorm formula (E[x²] − mean², mul/add cast to x's dtype), not
``F.group_norm``'s two-pass variance.  Forward only, as in JAX: it raises
where autograd would need a backward.

Each wrapper adds one to ``launches[<name>]`` when it launches its
kernel; ``group_norm_stats`` is one launch per call (the block that draws
an image's last ticket folds it).  ``group_norm`` launches the pair from
one host call (C entry ``gn_forward``), B2b as B2a's programmatic
dependent, and adds one to both counts.  A call captured into a CUDA
graph counts once, at its capture; its replays launch without the
wrapper, and only the device's records count them
(``utils/profiling.py::port_launches``).  ``stats_plan`` and ``apply_plan``
choose the two launches' grids around the kernels' fixed tiles; they are
plain Python, so the CPU tests hold them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from . import native
from .stats import sums_and_squares

launches = {"group_norm_stats": 0, "group_norm_apply": 0}
# the height-sharded eval launches from one thread per shard (parallel/spatial.py)
_lock = threading.Lock()

_MAX_VECTORS_PER_ROW = 1024  # C / (16 bytes / element size)
_MAX_GROUP_CHANNELS = 256  # C / groups

# group_norm.cu's B2a constants (a CPU test holds them equal to the source):
# tiles of 16 KB (32 bf16 rows of 256 channels), six in flight per block,
# clusters of eight blocks, 256 threads a block where a row allows (so B2a
# takes at most THREADS 16-byte vectors a row)
TILE_BYTES = 16384
STAGES = 6
CLUSTER = 8
THREADS = 256
# and its B2b constants: 256 threads a block where a row has at most 256
# 16-byte vectors, four rows of x in flight per thread
APPLY_THREADS = 256
APPLY_ROWS = 4
# B2b's grid (plain Python only): blocks a SM, shared out over the images
APPLY_BLOCKS_PER_SM = 4


def reset_launches() -> None:
    with _lock:
        for k in launches:
            launches[k] = 0


def count_launch(*names: str) -> None:
    """One more launch of each named kernel (a read-modify-write: locked)."""
    with _lock:
        for k in names:
            launches[k] += 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("group_norm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gn_stats.argtypes = [i, p, i, i, i, i, i, f, f, p, p, p, p, p, p, p, p, p]
    lib.gn_stats.restype = i
    lib.gn_stats_max_clusters.argtypes = [i, i, ctypes.POINTER(i)]
    lib.gn_stats_max_clusters.restype = i
    lib.gn_apply.argtypes = [i, p, p, p, p, i, i, i, i, p]
    lib.gn_apply.restype = i
    lib.gn_forward.argtypes = [i, p, i, i, i, i, i, f, f, p, p, p, p, p, p, p, p, p, i, p]
    lib.gn_forward.restype = i
    return lib


def _check_x(x: torch.Tensor, num_groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"group_norm: expected NHWC x of rank 4, got shape {tuple(x.shape)}")
    if x.dtype not in native.DTYPE_CODES:
        raise TypeError(f"group_norm: dtype must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    if b * h * w == 0:
        raise ValueError(f"group_norm: empty input {tuple(x.shape)}")
    if c % 32 != 0 or c % num_groups != 0:
        raise ValueError(f"group_norm: C={c} must be divisible by 32 and by num_groups={num_groups}")
    if c * x.element_size() // 16 > _MAX_VECTORS_PER_ROW or c // num_groups > _MAX_GROUP_CHANNELS:
        raise ValueError(f"group_norm: C={c} in {num_groups} groups is too wide for the kernel")
    if not x.is_contiguous():
        raise ValueError("group_norm: x must be contiguous NHWC (a channels_last NCHW "
                         "tensor permuted to NHWC)")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("group_norm is forward-only; call it under torch.no_grad() "
                           "or torch.inference_mode()")


def _check_affine(x: torch.Tensor, *vecs: torch.Tensor) -> None:
    c = x.shape[-1]
    for v in vecs:
        if v.shape != (c,):
            raise ValueError(f"group_norm: affine vector of shape {tuple(v.shape)}, expected ({c},)")
        if v.device != x.device:
            raise ValueError(f"group_norm: affine vector on {v.device}, x on {x.device}")
        if torch.is_grad_enabled() and v.requires_grad:
            raise RuntimeError("group_norm is forward-only; call it under torch.no_grad() "
                               "or torch.inference_mode()")


def _check_aligned(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("group_norm: the CUDA kernel needs 16-byte aligned tensors")


# ---------------------------------------------------------------------------
# plain versions (PyTorch ops; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def fold_group_stats(s_c: torch.Tensor, s2_c: torch.Tensor, n: float, scale: torch.Tensor,
                     bias: torch.Tensor, num_groups: int, eps: float, dtype: torch.dtype):
    """(mul, add) [B, C] in ``dtype`` from per-channel Σx, Σx² [B, C] f32
    over ``n`` = H·W·C/G elements a group: the fold of ``group_norm_pallas``
    (``diga_tpu/ops/pallas_gn.py:140,145-151``), plain XLA there too.  The
    height-sharded GroupNorm folds its sums over every shard with it."""
    b, c = s_c.shape
    g, cg = num_groups, c // num_groups
    mu = s_c.reshape(b, g, cg).sum(-1) / n
    var = torch.clamp(s2_c.reshape(b, g, cg).sum(-1) / n - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    mu_c = mu.repeat_interleave(cg, dim=1)
    inv_s = inv.repeat_interleave(cg, dim=1) * scale.to(torch.float32)[None]
    mul = inv_s.to(dtype)
    add = (bias.to(torch.float32)[None] - mu_c * inv_s).to(dtype)
    return mul, add


def group_norm_stats_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           num_groups: int = 32, eps: float = 1e-5):
    """(Σx [B,C] f32, Σx² [B,C] f32, mul [B,C] x.dtype, add [B,C] x.dtype)."""
    _, h, w, c = x.shape
    s_c, s2_c = sums_and_squares(x.to(torch.float32), (1, 2))
    mul, add = fold_group_stats(s_c, s2_c, float(h * w * (c // num_groups)), scale, bias,
                                num_groups, eps, x.dtype)
    return s_c, s2_c, mul, add


def group_norm_apply_plain(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """y = x·mul + add in x.dtype, mul/add [B, C] broadcast over H, W."""
    return x * mul[:, None, None, :] + add[:, None, None, :]


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    _, _, mul, add = group_norm_stats_plain(x, scale, bias, num_groups, eps)
    return group_norm_apply_plain(x, mul, add)


# ---------------------------------------------------------------------------
# B2a's launch plan (plain Python; group_norm.cu repeats the formulas)
# ---------------------------------------------------------------------------

def tile_rows(c: int, elem: int) -> int:
    """Rows of one ring stage: ``TILE_BYTES`` of whole rows, at least one."""
    return max(1, TILE_BYTES // (c * elem))


def block_threads(c: int, elem: int) -> int:
    """One thread per 16-byte vector of a row (at most ``THREADS`` vectors),
    in as many lanes of rows as fit in ``THREADS``."""
    nv = c * elem // 16
    return THREADS // nv * nv


def scratch_bytes(c: int, elem: int) -> int:
    """What the ring is reused as after the last tile: the lanes' rows
    [2][lanes][C] f32 with the receive buffer [CLUSTER][2][C/CLUSTER] f32,
    later the fold's [lanes][C/16] float4."""
    threads = block_threads(c, elem)
    lanes = threads // (c * elem // 16)
    return max(8 * lanes * c + 8 * c, 16 * max(threads, c // 16))


def smem_bytes(c: int, elem: int) -> int:
    """Dynamic shared memory of one block: the ring of ``STAGES`` tiles,
    or the scratch where that is larger."""
    return max(STAGES * TILE_BYTES, scratch_bytes(c, elem))


def check_stats_kernel(c: int, elem: int, num_groups: int) -> None:
    """Raise where B2a's kernel cannot take C channels of ``elem`` bytes in
    ``num_groups`` groups (the plain version and B2b can)."""
    if c * elem // 16 > THREADS:
        raise ValueError(f"group_norm: C={c} is too wide for the statistics kernel (at most "
                         f"{THREADS} 16-byte vectors a row, one thread each)")
    if num_groups % CLUSTER:
        raise ValueError(f"group_norm: the CUDA kernel folds the groups in {CLUSTER} slices of "
                         f"C, so num_groups={num_groups} must be a multiple of {CLUSTER}")


@dataclasses.dataclass(frozen=True)
class StatsPlan:
    batch: int
    hw: int
    c: int
    elem: int
    clusters: int  # per image; chunks = CLUSTER·clusters blocks per image

    @property
    def chunks(self) -> int:
        return CLUSTER * self.clusters

    @property
    def grid(self) -> tuple[int, int]:
        return self.chunks, self.batch

    @property
    def tile_rows(self) -> int:
        return tile_rows(self.c, self.elem)

    @property
    def threads(self) -> int:
        return block_threads(self.c, self.elem)

    @property
    def smem(self) -> int:
        return smem_bytes(self.c, self.elem)

    def chunk_rows(self, chunk: int) -> tuple[int, int]:
        """[r0, r1): the rows of each image that block ``chunk`` sums (an
        even split, to a row, as the kernel computes it)."""
        return chunk * self.hw // self.chunks, (chunk + 1) * self.hw // self.chunks

    def describe(self) -> str:
        return (f"tile_rows={self.tile_rows} stages={STAGES} cluster={CLUSTER} "
                f"grid={self.grid} threads={self.threads} smem={self.smem} B")


@functools.cache
def stats_plan(batch: int, hw: int, c: int, elem: int, max_clusters: int) -> StatsPlan:
    """B2a's launch for ``batch`` images of ``hw`` rows of C channels,
    ``elem`` bytes each, where ``max_clusters`` clusters fit on the card at
    once (``gn_stats_max_clusters``).  The resident clusters are shared out
    over the images, at least one per image and at most one per ``CLUSTER``
    tiles of an image, so that no cluster idles and the fold stays short."""
    n_tiles = -(-hw // tile_rows(c, elem))
    clusters = max(1, min(max_clusters // batch, -(-n_tiles // CLUSTER)))
    return StatsPlan(batch=batch, hw=hw, c=c, elem=elem, clusters=clusters)


# ---------------------------------------------------------------------------
# B2b's launch plan (plain Python; group_norm.cu repeats the formulas)
# ---------------------------------------------------------------------------

def apply_threads(c: int, elem: int) -> int:
    """One thread per 16-byte vector of a row, in as many lanes of rows as
    fit in ``APPLY_THREADS`` (one lane where a row has more vectors)."""
    nv = c * elem // 16
    return max(APPLY_THREADS // nv, 1) * nv


def apply_smem_bytes(c: int, elem: int) -> int:
    """Dynamic shared memory of one block: its image's mul and add."""
    return 2 * c * elem


@dataclasses.dataclass(frozen=True)
class ApplyPlan:
    batch: int
    hw: int
    c: int
    elem: int
    chunks: int  # blocks per image

    @property
    def grid(self) -> tuple[int, int]:
        return self.chunks, self.batch

    @property
    def threads(self) -> int:
        return apply_threads(self.c, self.elem)

    @property
    def smem(self) -> int:
        return apply_smem_bytes(self.c, self.elem)

    @property
    def lanes(self) -> int:
        """Threads on one channel vector: they take every lanes-th row."""
        return self.threads // (self.c * self.elem // 16)

    def chunk_rows(self, chunk: int) -> tuple[int, int]:
        """[r0, r1): the rows of each image that block ``chunk`` writes (an
        even split, to a row, as the kernel computes it)."""
        return chunk * self.hw // self.chunks, (chunk + 1) * self.hw // self.chunks

    @property
    def rows_per_thread(self) -> int:
        """The most rows one thread writes (``APPLY_ROWS`` of them in flight)."""
        most = -(-self.hw // self.chunks)  # rows of the largest block
        return -(-most // self.lanes)

    def describe(self) -> str:
        return (f"grid={self.grid} threads={self.threads} rows/thread<={self.rows_per_thread} "
                f"in flight {APPLY_ROWS} smem={self.smem} B")


@functools.cache
def apply_plan(batch: int, hw: int, c: int, elem: int, sm_count: int) -> ApplyPlan:
    """B2b's launch for ``batch`` images of ``hw`` rows of C channels,
    ``elem`` bytes each, on a card of ``sm_count`` SMs: ``APPLY_BLOCKS_PER_SM``
    blocks a SM shared out over the images, at least one per image and at
    most one per ``lanes`` rows (a row for every thread)."""
    lanes = apply_threads(c, elem) // (c * elem // 16)
    chunks = max(1, min(-(-hw // lanes), -(-APPLY_BLOCKS_PER_SM * sm_count // batch)))
    return ApplyPlan(batch=batch, hw=hw, c=c, elem=elem, chunks=chunks)


@functools.cache
def max_clusters(device_index: int, dtype: torch.dtype, c: int) -> int:
    """Clusters of B2a's blocks for C channels that fit on the card at once.
    The C entry also allows the kernel its shared memory on the device, so
    this runs before B2a's first launch there."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().gn_stats_max_clusters(native.DTYPE_CODES[dtype], c, ctypes.byref(out))
    if err or out.value < 1:
        raise RuntimeError(f"gn_stats: cluster occupancy query failed (CUDA error {err}, "
                           f"{out.value} clusters)")
    return out.value


# zeroed tickets, CLUSTER per image (one per slice of the channels), for
# each (device, stream); the kernel leaves them zeroed, so two calls on one
# stream reuse them and two streams never share them.  A workspace that a
# larger one replaces stays allocated: a CUDA graph captured on the stream
# (train/graphs.py) keeps using its address.
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_retired: list[torch.Tensor] = []


def ticket_workspace(device: torch.device, n: int = 0, stream: int | None = None) -> torch.Tensor:
    """The int32 tickets of ``stream`` (by default ``device``'s current
    stream), at least ``n`` of them."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    with _lock:  # check-then-set; threads on one stream share its tickets in stream order
        t = _tickets.get(key)
        if t is None or t.numel() < n:
            if t is not None:
                _retired.append(t)
            t = torch.zeros(max(n, 8 * CLUSTER), device=device, dtype=torch.int32)
            _tickets[key] = t
    return t


# ---------------------------------------------------------------------------
# wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def _stats_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int,
                eps: float, extra_bytes: int = 0):
    """B2a's plan, its C entry's arguments up to ``mul``/``add``, and its
    outputs (Σx, Σx², mul, add), all in one new byte buffer; the buffer's
    first ``extra_bytes`` (a multiple of 16) are left for the caller."""
    b, h, w, c = x.shape
    hw = h * w
    check_stats_kernel(c, x.element_size(), num_groups)
    plan = stats_plan(b, hw, c, x.element_size(), max_clusters(x.device.index, x.dtype, c))
    # after the caller's bytes: mul [b, c], add [b, c] in x.dtype, then f32
    # cluster rows [b, clusters, 2, c], Σx [b, c], Σx² [b, c] (every piece
    # 16-byte aligned: C % 32 == 0)
    n_small = 2 * b * c * x.element_size()
    n_part = 2 * b * plan.clusters * c
    buf = torch.empty(extra_bytes + n_small + 4 * (n_part + 2 * b * c), device=x.device,
                      dtype=torch.uint8)
    mul, add = buf[extra_bytes:extra_bytes + n_small].view(x.dtype).view(2, b, c).unbind(0)
    f32 = buf[extra_bytes + n_small:].view(torch.float32)
    sums, sumsq = f32[n_part:].view(2, b, c).unbind(0)
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tickets = ticket_workspace(x.device, b * CLUSTER, stream)
    _check_aligned(x)
    args = (native.DTYPE_CODES[x.dtype], x.data_ptr(), b, hw, c, num_groups, plan.chunks,
            float(hw * (c // num_groups)), eps, scale.data_ptr(), bias.data_ptr(),
            f32.data_ptr(), tickets.data_ptr(), sums.data_ptr(), sumsq.data_ptr(),
            mul.data_ptr(), add.data_ptr())
    # scale and bias stay referenced until the launch
    return buf, args, (sums, sumsq, mul, add), (scale, bias), stream


def group_norm_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5):
    """B2a: per-channel sums and the folded per-(image, channel) mul/add."""
    _check_x(x, num_groups)
    _check_affine(x, scale, bias)
    if native.on_cpu(x):
        return group_norm_stats_plain(x, scale, bias, num_groups, eps)
    _, args, out, _affine, stream = _stats_args(x, scale, bias, num_groups, eps)
    err = native.launch(x, _lib().gn_stats, *args, stream=stream)
    if err:
        raise RuntimeError(f"gn_stats kernel launch failed: CUDA error {err}")
    count_launch("group_norm_stats")
    return out


def _check_mul_add(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> None:
    b, _, _, c = x.shape
    for v in (mul, add):
        if v.shape != (b, c) or v.dtype != x.dtype or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"group_norm_apply: mul/add must be contiguous ({b}, {c}) "
                             f"{x.dtype} on {x.device}")


def group_norm_apply(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """B2b: y = x·mul + add in x.dtype.  Launched in stream order: it may
    follow the kernel that wrote x."""
    _check_x(x, 32)
    _check_mul_add(x, mul, add)
    if native.on_cpu(x):
        return group_norm_apply_plain(x, mul, add)
    b, h, w, c = x.shape
    plan = apply_plan(b, h * w, c, x.element_size(), native.sm_count(x.device.index))
    y = torch.empty_like(x)
    _check_aligned(x, mul, add, y)
    err = native.launch(x, _lib().gn_apply, native.DTYPE_CODES[x.dtype], x.data_ptr(),
                        mul.data_ptr(), add.data_ptr(), y.data_ptr(), b, h * w, c, plan.chunks)
    if err:
        raise RuntimeError(f"gn_apply kernel launch failed: CUDA error {err}")
    count_launch("group_norm_apply")
    return y


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NHWC ``x`` with f32 per-channel ``scale``/``bias``.

    Same function as ``diga_tpu.ops.pallas_gn.group_norm_pallas`` and
    ``FusedGroupNorm``: stats in f32, normalization in x.dtype.  On the card
    one host call launches B2a and then B2b, which starts under B2a's tail
    (B2a only reads x), and one allocation holds y and every other buffer.
    """
    _check_x(x, num_groups)
    _check_affine(x, scale, bias)
    if native.on_cpu(x):
        return group_norm_plain(x, scale, bias, num_groups, eps)
    b, h, w, c = x.shape
    plan = apply_plan(b, h * w, c, x.element_size(), native.sm_count(x.device.index))
    n_y = x.numel() * x.element_size()  # a multiple of 64 bytes: C % 32 == 0
    buf, args, _, _affine, stream = _stats_args(x, scale, bias, num_groups, eps, n_y)
    y = buf[:n_y].view(x.dtype).view(x.shape)
    err = native.launch(x, _lib().gn_forward, *args, y.data_ptr(), plan.chunks, stream=stream)
    if err:
        raise RuntimeError(f"gn_forward (B2a + B2b) kernel launch failed: CUDA error {err}")
    count_launch("group_norm_stats", "group_norm_apply")
    return y
