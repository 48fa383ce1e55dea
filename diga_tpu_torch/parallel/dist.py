"""Data-parallel training over processes: one process per device.

The counterpart of ``diga_tpu/parallel/mesh.py``.  JAX runs one program
over a ``Mesh('data')``; GSPMD changes where the step runs, not what it
computes: every batch-level reduction of a JAX step is over the global
batch.  Here one process drives one device, and the step makes the same
reductions global by hand.

The rank layout, decided once:

  * rank r is JAX's process r with one local device, ``cuda:LOCAL_RANK``
    or the CPU;
  * each rank loads the recipe batch of every stream, host-sharded by
    ``diga_tpu/data/pipeline.py:57-82``: rank r builds rows
    ``b·Bg + r·batch + j`` of global batch b (``data/loader.py``);
  * the global batch is the ranks' batches concatenated rank by rank
    (JAX's multi-host layout), so a world-N step computes what one process
    computes on that global batch:
      - BN statistics over the global batch (``sync_bn.SyncBatchNorm2d``);
      - gradients summed over the ranks and divided by the world
        (``all_reduce_grads``): every loss is a mean whose average over
        equal shards is the global mean (OHEM scales its local sum to make
        it so, ``ops/losses.py``);
      - the centroid scan over the rows of every rank in global order
        (``gather_rows``);
      - every per-image random draw at the global batch's shape from the
        shared generator, each rank keeping its own rows (``draw_local``);
        a batch concatenated from several parts (``[source; view]``) is
        laid out part by part in the global batch, each part rank by rank
        (``batch_segments``);
  * the backend is NCCL on ``cuda`` and gloo on ``cpu``, never swapped; a
    group that fails to form raises, and a collective that waits longer
    than the group's timeout raises (a dead rank never hangs its peers).

Without a process group (no ``--n_devices``/``--multihost``) none of this
runs: one process on one device, ``nn.BatchNorm2d``, the same draws.  That
default differs from JAX's, whose CLIs take every device.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Iterable, Sequence

import torch
import torch.distributed as tdist

# a collective that waits longer than this raises on every waiting rank
PG_TIMEOUT_ENV = "DIGA_TORCH_PG_TIMEOUT_S"
DEFAULT_PG_TIMEOUT_S = 600.0
# how long ``launch`` waits for a spawned world to end (unset: no limit)
JOIN_TIMEOUT_ENV = "DIGA_TORCH_JOIN_TIMEOUT_S"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

_SEGMENTS: contextvars.ContextVar = contextvars.ContextVar("batch_segments", default=None)


def active() -> bool:
    """Is there a process group?"""
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if active() else 0


def world() -> int:
    return tdist.get_world_size() if active() else 1


def is_writer() -> bool:
    """Only rank 0 writes files (metrics, weights, checkpoints, traces)."""
    return rank() == 0


def backend() -> str | None:
    """The process group's backend (``nccl`` or ``gloo``), or None."""
    return tdist.get_backend() if active() else None


def backend_for(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device_type!r} (use 'cuda' or 'cpu')")


def pg_timeout_s() -> float:
    return float(os.environ.get(PG_TIMEOUT_ENV, DEFAULT_PG_TIMEOUT_S))


def check_devices(n: int, device_type: str) -> None:
    """Raise when ``n`` ranks are asked for and fewer devices exist, as
    ``make_mesh`` does (``diga_tpu/parallel/mesh.py:25-32``).  Gloo ranks
    on the CPU are the counterpart of XLA's virtual CPU devices: any
    number."""
    if n < 1:
        raise ValueError(f"--n_devices {n}: expected at least 1")
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"requested {n} ranks on cuda but only {have} CUDA device(s) "
                             "exist; pass --device cpu for gloo ranks on the CPU")


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:LOCAL_RANK``, or the CPU."""
    backend_for(device_type)
    return torch.device("cuda", local_rank) if device_type == "cuda" else torch.device("cpu")


def local_device(device_type: str) -> torch.device:
    """This process's device: the card ``init_group`` made current, or the CPU."""
    return rank_device(device_type, torch.cuda.current_device() if device_type == "cuda" else 0)


def init_group(rank_: int, world_: int, device_type: str, init_method: str,
               local_rank: int | None = None) -> torch.device:
    """Join the process group (``nccl`` on cuda, ``gloo`` on cpu) with the
    ``DIGA_TORCH_PG_TIMEOUT_S`` timeout; returns the rank's device."""
    check_devices(1 if local_rank is None else local_rank + 1, device_type)
    device = rank_device(device_type, rank_ if local_rank is None else local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(backend_for(device_type), init_method=init_method, rank=rank_,
                             world_size=world_,
                             timeout=datetime.timedelta(seconds=pg_timeout_s()))
    return device


def close_group() -> None:
    if active():
        tdist.destroy_process_group()


def torchrun_env() -> dict[str, str] | None:
    """torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
    ``MASTER_PORT``, or None where any is missing."""
    env = {k: os.environ.get(k) for k in TORCHRUN_ENV}
    return None if any(v is None for v in env.values()) else env


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def broadcast_tensors(tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor from rank 0, in place."""
    if not active():
        return
    with torch.no_grad():
        for t in tensors:
            tdist.broadcast(t.data, src=0)


def broadcast_module(module: torch.nn.Module) -> None:
    """Every parameter and buffer from rank 0, in place."""
    broadcast_tensors(list(module.parameters()) + list(module.buffers()))


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum the gradients over the ranks and divide by the world, in one
    flat bucket per dtype.  The same parameters carry a gradient on every
    rank: each runs the same step."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    n = world()
    for dtype in sorted({g.dtype for g in grads}, key=str):
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        tdist.all_reduce(flat)
        flat.div_(n)
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` itself without a group)."""
    if not active():
        return t
    t = t.clone()
    tdist.all_reduce(t)
    return t


def mean_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The step's scalar metrics averaged over the ranks, for logging."""
    if not active():
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float32).reshape(()) for k in keys])
    flat = all_reduce_sum(flat) / world()
    return dict(zip(keys, flat.unbind()))


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``'s rows from every rank, concatenated in rank order (every rank
    holds a tensor of one shape); ``t`` itself without a group."""
    if not active():
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world())]
    tdist.all_gather(parts, src)
    out = torch.cat(parts, dim=0)
    return out.to(torch.bool) if t.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# per-image draws: at the global batch's shape, each rank keeps its rows
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def batch_segments(*sizes: int):
    """Inside, a batch drawn for with ``draw_local`` (the models' channel
    dropout) is ``len(sizes)`` parts of ``sizes[i]`` local rows each, laid
    out part by part in the global batch, each part rank by rank: the
    forward of ``[source; view]`` is ``batch_segments(b, b)``."""
    token = _SEGMENTS.set(tuple(int(s) for s in sizes))
    try:
        yield
    finally:
        _SEGMENTS.reset(token)


def local_rows(n_local: int, segments: Sequence[int] | None = None) -> list[int]:
    """This rank's row indices in the global batch of ``n_local`` local rows
    per rank, made of ``segments`` (default: ``batch_segments``' or one part)."""
    sizes = tuple(segments or _SEGMENTS.get() or (n_local,))
    if sum(sizes) != n_local:  # a forward on a batch the context does not describe
        sizes = (n_local,)
    n, r = world(), rank()
    rows, offset = [], 0
    for s in sizes:
        rows.extend(range(offset + r * s, offset + (r + 1) * s))
        offset += n * s
    return rows


def draw_local(draw: Callable[[int], Any], n_local: int, shared: Sequence[str] = ()) -> Any:
    """``draw(n)`` makes ``n`` rows of per-image draws (a tensor, or a dict
    of tensors with ``n`` leading rows, the ``shared`` keys excepted).
    Without a group this is ``draw(n_local)``; under one, ``draw`` runs at
    the global batch's shape and this rank keeps its rows, so a world-N run
    draws what one process draws for the global batch."""
    if not active():
        return draw(n_local)
    full = draw(world() * n_local)
    rows = local_rows(n_local)

    def take(v: torch.Tensor) -> torch.Tensor:
        return v[torch.as_tensor(rows, device=v.device)]

    if isinstance(full, dict):
        return {k: v if k in shared else take(v) for k, v in full.items()}
    return take(full)


# ---------------------------------------------------------------------------
# launching a world
# ---------------------------------------------------------------------------

def _rank_main(rank_: int, world_: int, device_type: str, init_method: str, threads: int,
               fn: Callable, args: tuple, results) -> None:
    """A spawned rank: join the group, run ``fn(*args)``, report, leave."""
    torch.set_num_threads(threads)
    try:
        init_group(rank_, world_, device_type, init_method)
        try:
            out = fn(*args)
        finally:
            close_group()
        results.put((rank_, "ok", out if rank_ == 0 else None))
    except BaseException as e:  # noqa: BLE001 - reported to the launcher, then the rank fails
        results.put((rank_, "error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
        raise SystemExit(1)


def launch(fn: Callable, n: int, device_type: str, args: tuple = (),
           multihost: bool = False, join_timeout_s: float | None = None) -> Any:
    """Run ``fn(*args)`` on every rank of a world; return rank 0's result.

    ``multihost``: this process is one rank of a torchrun world (``env://``
    from torchrun's environment; it runs ``fn`` itself).  Else ``n`` = 1
    forms a one-rank group in this process (the reduce paths run, on the
    card too), and ``n`` > 1 spawns one process per device on this host
    over a ``file://`` rendezvous; each gets an equal share of this
    process's torch threads.  A rank that fails makes ``launch`` raise
    with every rank's error; a world that outlasts ``join_timeout_s``
    (default ``DIGA_TORCH_JOIN_TIMEOUT_S``, else no limit) is killed and
    raises."""
    if multihost:
        env = torchrun_env()
        if env is None:
            raise RuntimeError("--multihost needs torchrun's environment: "
                               + ", ".join(TORCHRUN_ENV))
        init_group(int(env["RANK"]), int(env["WORLD_SIZE"]), device_type, "env://",
                   local_rank=int(env["LOCAL_RANK"]))
        try:
            return fn(*args)
        finally:
            close_group()
    check_devices(n, device_type)
    if active():
        raise RuntimeError("launch: a process group already exists in this process")
    store = tempfile.mkdtemp(prefix="diga_dist_")
    init_method = f"file://{os.path.join(store, 'rendezvous')}"
    try:
        if n > 1:
            return _spawn_world(fn, n, device_type, args, init_method, join_timeout_s)
        init_group(0, 1, device_type, init_method)
        try:
            return fn(*args)
        finally:
            close_group()
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _spawn_world(fn, n, device_type, args, init_method, join_timeout_s):
    import torch.multiprocessing as mp

    if join_timeout_s is None and os.environ.get(JOIN_TIMEOUT_ENV):
        join_timeout_s = float(os.environ[JOIN_TIMEOUT_ENV])
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // n)
    procs = [ctx.Process(target=_rank_main, daemon=False, name=f"rank{r}",
                         args=(r, n, device_type, init_method, threads, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    reports: dict[int, tuple[str, Any]] = {}
    try:
        while len(reports) < n:
            try:
                r, status, payload = results.get(timeout=0.5)
                reports[r] = (status, payload)
                continue
            except queue.Empty:
                pass
            dead = [p for p in procs if p.exitcode is not None
                    and int(p.name[4:]) not in reports]
            if dead:  # a report may still be in the pipe; else it was killed
                try:
                    r, status, payload = results.get(timeout=2.0)
                    reports[r] = (status, payload)
                    continue
                except queue.Empty:
                    pass
                for p in dead:  # its peers fail on their own, at the group's timeout
                    reports[int(p.name[4:])] = ("error", f"exited with code {p.exitcode}")
            if deadline is not None and time.monotonic() > deadline:
                for r in range(n):
                    reports.setdefault(r, ("error", f"still running after {join_timeout_s} s"))
                break
    finally:
        for p in procs:
            p.join(timeout=30.0 if deadline is None else max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: msg for r, (status, msg) in sorted(reports.items()) if status != "ok"}
    if errors:
        raise RuntimeError(f"{len(errors)} of {n} ranks failed:\n" + "\n".join(
            f"rank {r}: {msg}" for r, msg in errors.items()))
    return reports[0][1]
