"""Height-sharded eval: the row layout, the shard context and its transports.

The counterpart of ``diga_tpu/parallel/mesh.py::spatial_sharding``
(``P(None, 'data')``).  There GSPMD splits one image's height over the
mesh and writes every conv's halo exchange itself; here each sharded op
does it by hand (``parallel/spatial_ops.py``), on this layout, decided once:

  * every tensor of height h is held as the balanced split of h over the n
    shards: shard r owns rows [⌊r·h/n⌋, ⌊(r+1)·h/n⌋), a range that may be
    empty (``rows``);
  * every sharded op computes the rows it owns of its output; the input
    rows it needs that other shards own, it fetches (``Shard.fetch``);
    rows outside [0, h) are the op's padding (zeros for a conv, −inf for a
    max pool), and only those;
  * so residual adds, channel concats and HRNet's branch fusions line up
    with no special case: their operands have one height and one split;
  * the input image and its label are split by the same rule over
    ``out_hw[0]``; a height that does not divide by n is refused, as JAX's
    ``device_put`` refuses it;
  * a tensor's height is not in its local shape: every shard gives its own
    and the op sums them (``Shard.height``), so every op, a shard with no
    rows included, takes part in every exchange, in the same order.

A ``Shard`` is the context the model's modules consult (``current()``,
set by ``Shard.active()``, the idiom of ``dist.draw_local``); with none
active every sharded op is the one-device op.  Two transports move the
rows behind one interface (``heights``, ``fetch_rows``, ``all_reduce``,
``gather_rows``):

  * ``GroupTransport``: one shard per rank of the ``parallel/dist.py``
    world (NCCL or gloo).  Each rank sends each peer exactly the rows that
    peer needs, both sides computing the ranges from the layout, with
    point-to-point sends, so a halo reaches past the nearest neighbour.
    The heights go over gloo on the host (a second, gloo group under NCCL).
  * ``LocalTransport``: n shards in one process on one device, one thread
    each (``LocalShards``, ``run_local``), the counterpart of XLA's virtual
    CPU devices.
    The CPU tests use it, and so does ``chip_smoke.py``: NCCL puts no two
    ranks on one card.  Every thread enqueues on the caller's stream, so a
    barrier orders the host and stream order orders the device.  Each
    exchange posts into one of two slots and waits at the barrier; a slot
    is written again only after every shard has passed the next barrier,
    so what a shard read stays alive until its reads are enqueued.  The
    barrier has a timeout, and a shard that raises breaks it, so the
    others raise too; nothing hangs.  It is internal: no CLI flag selects
    it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import queue
import threading
from typing import Any, Callable, Sequence

import torch
import torch.distributed as tdist

from . import dist

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("spatial_shard", default=None)


def rows(h: int, n: int, r: int) -> tuple[int, int]:
    """[lo, hi): the rows of a height-h tensor that shard r of n owns."""
    return r * h // n, (r + 1) * h // n


def current() -> "Shard | None":
    """The active shard of this thread, or None (every op unsharded)."""
    return _CURRENT.get()


def _narrow(x: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
    return x.narrow(dim, start, stop - start)


def fill_rows(x: torch.Tensor, dim: int, n_rows: int, value: float) -> torch.Tensor:
    """``n_rows`` rows of ``value`` shaped as ``x`` along ``dim``, in its format."""
    shape = list(x.shape)
    shape[dim] = n_rows
    return torch.full(shape, value, dtype=x.dtype, device=x.device).contiguous(
        memory_format=layout_of(x))


def layout_of(x: torch.Tensor) -> torch.memory_format:
    """``x``'s memory format: channels_last where it is that and not also
    contiguous (the models' activations), else contiguous."""
    return (torch.channels_last if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


def _assemble(x: torch.Tensor, dim: int, h: int, n: int, need: tuple[int, int],
              piece: Callable[[int, int, int], torch.Tensor], fill: float) -> torch.Tensor:
    """Rows [a, b) of the height-h tensor: padding ``fill`` outside [0, h),
    ``piece(q, start, stop)`` for the global rows [start, stop) shard q owns."""
    a, b = need
    parts = []
    if a < min(b, 0):
        parts.append(fill_rows(x, dim, min(b, 0) - a, fill))
    for q in range(n):
        lo, hi = rows(h, n, q)
        start, stop = max(a, lo), min(b, hi)
        if start < stop:
            parts.append(piece(q, start, stop))
    if max(a, h) < b:
        parts.append(fill_rows(x, dim, b - max(a, h), fill))
    if not parts:
        return _narrow(x, dim, 0, 0)
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return out.contiguous(memory_format=layout_of(x))


class LocalTransport:
    """n shards as n threads of one process on one device."""

    def __init__(self, n: int, timeout_s: float | None = None):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=dist.pg_timeout_s() if timeout_s is None
                                         else timeout_s)
        self._slots: list[list[Any]] = [[None] * n, [None] * n]
        self._gen = [0] * n

    def _exchange(self, r: int, obj: Any) -> list[Any]:
        gen = self._gen[r]
        self._gen[r] = gen + 1
        slot = self._slots[gen % 2]
        slot[r] = obj
        self.barrier.wait()
        return list(slot)

    def heights(self, r: int, x: torch.Tensor, dim: int) -> list[int]:
        return self._exchange(r, x.shape[dim])

    def fetch_rows(self, r: int, x: torch.Tensor, h: int, need: Sequence[tuple[int, int]],
                   fill: float, dim: int) -> torch.Tensor:
        posted = self._exchange(r, x)

        def piece(q: int, start: int, stop: int) -> torch.Tensor:
            lo = rows(h, self.n, q)[0]
            return _narrow(posted[q], dim, start - lo, stop - lo)

        return _assemble(x, dim, h, self.n, need[r], piece, fill)

    def all_reduce(self, r: int, t: torch.Tensor, op: str) -> torch.Tensor:
        posted = self._exchange(r, t)
        combine = torch.add if op == "sum" else torch.maximum
        out = posted[0]
        for v in posted[1:]:  # the same order on every shard: the same result
            out = combine(out, v)
        return out.clone() if out is t else out

    def gather_rows(self, r: int, t: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._exchange(r, t), dim)


class GroupTransport:
    """One shard per rank of the process group."""

    def __init__(self):
        if not dist.active():
            raise RuntimeError("a group transport needs a process group (--n_devices or "
                               "--multihost)")
        self.n = dist.world()
        # the heights are host integers: gloo, a group of its own under NCCL
        self._meta = (None if self.n == 1 or dist.backend() == "gloo"
                      else tdist.new_group(backend="gloo"))

    def heights(self, r: int, x: torch.Tensor, dim: int) -> list[int]:
        if self.n == 1:
            return [x.shape[dim]]
        mine = torch.tensor([x.shape[dim]], dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(self.n)]
        tdist.all_gather(every, mine, group=self._meta)
        return [int(v) for v in every]

    def fetch_rows(self, r: int, x: torch.Tensor, h: int, need: Sequence[tuple[int, int]],
                   fill: float, dim: int) -> torch.Tensor:
        lo_r, _ = rows(h, self.n, r)
        ops, received = [], {}
        for q in range(self.n):
            if q == r:
                continue
            lo_q, hi_q = rows(h, self.n, q)
            # what q needs of this rank's rows, and what this rank needs of q's
            start, stop = max(need[q][0], lo_r), min(need[q][1], rows(h, self.n, r)[1])
            if start < stop:
                ops.append(tdist.P2POp(tdist.isend, _narrow(x, dim, start - lo_r,
                                                            stop - lo_r).contiguous(), q))
            start, stop = max(need[r][0], lo_q), min(need[r][1], hi_q)
            if start < stop:
                shape = list(x.shape)
                shape[dim] = stop - start
                received[q] = torch.empty(shape, dtype=x.dtype, device=x.device)
                ops.append(tdist.P2POp(tdist.irecv, received[q], q))
        for req in (tdist.batch_isend_irecv(ops) if ops else []):
            req.wait()
        return _assemble(x, dim, h, self.n, need[r],
                         lambda q, start, stop: (_narrow(x, dim, start - lo_r, stop - lo_r)
                                                 if q == r else received[q]), fill)

    def all_reduce(self, r: int, t: torch.Tensor, op: str) -> torch.Tensor:
        t = t.clone()
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM if op == "sum" else tdist.ReduceOp.MAX)
        return t

    def gather_rows(self, r: int, t: torch.Tensor, dim: int) -> torch.Tensor:
        counts = self.heights(r, t, dim)
        most = max(counts)
        padded = t
        if t.shape[dim] < most:
            padded = torch.cat([t, fill_rows(t, dim, most - t.shape[dim], 0)], dim)
        parts = [torch.empty_like(padded.contiguous()) for _ in range(self.n)]
        tdist.all_gather(parts, padded.contiguous())
        return torch.cat([_narrow(p, dim, 0, c) for p, c in zip(parts, counts)], dim)


@dataclasses.dataclass(eq=False)
class Shard:
    """Shard ``r`` of ``transport.n``: what a sharded op asks of the layout
    and of the other shards.  Every method that exchanges is called by
    every shard, in the same order."""

    transport: Any
    r: int

    @property
    def n(self) -> int:
        return self.transport.n

    def rows(self, h: int, r: int | None = None) -> tuple[int, int]:
        """[lo, hi) of height h that this shard (or shard ``r``) owns."""
        return rows(h, self.n, self.r if r is None else r)

    def height(self, x: torch.Tensor, dim: int = 2) -> int:
        """The global height of sharded ``x`` (an exchange)."""
        return sum(self.transport.heights(self.r, x, dim))

    def fetch(self, x: torch.Tensor, h: int, need: Callable[[int], tuple[int, int]],
              fill: float = 0.0, dim: int = 2) -> torch.Tensor:
        """Global rows ``need(r)`` = [a, b) of sharded ``x`` (height h), ``fill``
        outside [0, h); ``need(q)`` is every shard's range (an exchange)."""
        return self.transport.fetch_rows(self.r, x, h, [need(q) for q in range(self.n)],
                                         fill, dim)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or ``op='max'``) over the shards, a new tensor."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce: op {op!r}, expected 'sum' or 'max'")
        return self.transport.all_reduce(self.r, t, op)

    def gather_rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every shard's rows of ``t`` in order along ``dim``: the whole tensor."""
        return self.transport.gather_rows(self.r, t, dim)

    def slice_rows(self, t, dim: int = 1):
        """This shard's rows of a whole (unsharded) tensor or array."""
        h = t.shape[dim]
        if h % self.n:
            raise ValueError(f"height-sharded eval: height {h} does not divide by the "
                             f"{self.n} shards")
        lo, hi = self.rows(h)
        index = [slice(None)] * t.ndim
        index[dim] = slice(lo, hi)
        return t[tuple(index)]

    @contextlib.contextmanager
    def active(self):
        """Inside, the model's sharded modules run on this shard's rows."""
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)


def group_shard() -> Shard:
    """This rank's shard of the process group's world."""
    return Shard(GroupTransport(), dist.rank())


class LocalShards:
    """n shards as n long-lived threads of this process, on one device.

    ``run(fn)`` calls ``fn(shard)`` on every thread, each with a shard of a
    new ``LocalTransport``, on the caller's device and stream with its grad
    and inference modes, and returns the results in shard order.  The
    threads outlive a run, and with them what torch keeps per thread: the
    cuDNN plans ``cudnn.benchmark`` tuned for their slab shapes are kept
    per thread, so new threads would tune every conv again.  A shard that
    raises breaks the barrier (its peers raise too) and its error is
    raised by ``run``.  ``close`` (or leaving the ``with``) ends them."""

    def __init__(self, n: int, device: torch.device | str = "cpu",
                 timeout_s: float | None = None):
        self.n = n
        self.device = torch.device(device)
        self.timeout_s = timeout_s
        self._tasks: list[queue.Queue] = [queue.Queue() for _ in range(n)]
        self._done: queue.Queue = queue.Queue()
        self._threads = [threading.Thread(target=self._serve, args=(r,), name=f"shard{r}",
                                          daemon=True) for r in range(n)]
        for t in self._threads:
            t.start()

    def _serve(self, r: int) -> None:
        while True:
            task = self._tasks[r].get()
            if task is None:
                return
            fn, transport, stream, grad, inference = task
            try:
                with contextlib.ExitStack() as stack:
                    if stream is not None:
                        stack.enter_context(torch.cuda.device(self.device))
                        stack.enter_context(torch.cuda.stream(stream))
                    stack.enter_context(torch.set_grad_enabled(grad))
                    stack.enter_context(torch.inference_mode(inference))
                    self._done.put((r, True, fn(Shard(transport, r))))
            except BaseException as e:  # noqa: BLE001 - raised by ``run`` in the caller
                transport.barrier.abort()
                self._done.put((r, False, e))

    def run(self, fn: Callable[[Shard], Any]) -> list[Any]:
        transport = LocalTransport(self.n, self.timeout_s)
        stream = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                  else None)
        task = (fn, transport, stream, torch.is_grad_enabled(),
                torch.is_inference_mode_enabled())
        for q in self._tasks:
            q.put(task)
        results: list[Any] = [None] * self.n
        errors: list[BaseException] = []
        for _ in range(self.n):
            r, ok, value = self._done.get()
            if ok:
                results[r] = value
            else:
                errors.append(value)
        if errors:  # the first that is not a peer's broken barrier is the cause
            first = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0])
            raise RuntimeError(f"height-sharded run over {self.n} local shards failed: "
                               f"{type(first).__name__}: {first}") from first
        return results

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for t in self._threads:
            t.join(timeout=60.0)

    def __enter__(self) -> "LocalShards":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_local(n: int, fn: Callable[[Shard], Any], device: torch.device | str = "cpu",
              timeout_s: float | None = None) -> list[Any]:
    """``LocalShards(n, device, timeout_s).run(fn)`` on threads of its own."""
    with LocalShards(n, device, timeout_s) as shards:
        return shards.run(fn)
