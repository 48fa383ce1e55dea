"""CUDA graphs of the segmentation models' calls in a train step.

A train step calls its segmentation model (``DeepLabV2``, ``HRNetOCR`` or
``MiTDAFormer``; any module) at fixed shapes: the student's forward on
[source; view] with its backward, the EMA teacher's forward under
``no_grad`` and the student's
``bn_stats_forward`` on the target batch (self-training: the forwards of
its own batches).  On the card each call is thousands of small kernels,
and launching them one by one from the host is what holds a step back
where the kernels are small (HRNet-W48+OCR, PERF.md).  ``ModelCalls``
captures each call once as a CUDA graph and replays it from then on: one
launch for the forward, one for its backward.

Keys and lifetime.  A graph is keyed by the module, the method
(``forward``, ``bn_stats_forward``), whether the outputs take gradients
(grad mode on and a parameter that requires one), the module's training
flag, the autocast state, the input's shape and dtype, and the
generators the module's submodules hold (``ChannelDropout.generator``;
MiT's stochastic depth draws from its dropout's, so that generator is
registered once).
A key's calls run eagerly until ``EAGER_CALLS`` of them have finished,
a forward with gradients once its backward has run: they are its warm-up
(cuDNN's autotuning at the shape, of the backward's convolutions too, the
per-stream workspaces, B2's tickets among them) and they are real calls,
whose effects the step keeps.  The next call captures the graph and
replays it once: a capture runs nothing, so that replay is the call.
Every later call copies its input into the graph's static input and
replays.  So no call runs the model an extra time: the BN running
statistics, their batch counters and the dropout generators move exactly
as in the eager step (the generators are registered with the graph: a
replay draws what the eager call would and advances them as far).  A
module's hooks run where the call runs eagerly or is captured, not at a
replay.

Streams.  Every call that engages (eager, capture, replay) runs on the
backend's own stream, after the caller's queued work and before what the
caller queues next, and so does its backward (an autograd node runs on
its forward's stream).  The parameters' gradient accumulators, which a
pending backward keeps alive into the next capture of the same key, are
then always on the capturing stream: one made on the caller's default
stream would tie that stream to the capture, which CUDA refuses.

Outputs.  A graph writes its outputs to the same memory at every replay;
a call hands out aliases of that memory.  A graph is replayed again only
once nothing holds the aliases of its last call and its backward has run
or can no longer run.  A call of a key whose graphs are all in use
captures another graph for the key (the self-training step's second
teacher forward at the first one's shape), up to ``MAX_GRAPHS``; past
that the call runs eagerly.  Each graph has a memory pool of its own
(its backward shares its forward's), so no replay overwrites another
graph's outputs.

Backward.  A forward with gradients runs through an autograd function,
as ``torch.cuda.make_graphed_callables`` does, without its extra warm-up
runs: the function's forward replays the forward graph, its backward
copies the incoming gradients into the graph's static gradient inputs
(zeros for an output that received none) and replays the backward
graph, which computes the parameters' gradients by
``torch.autograd.grad``.  It returns aliases of those, which the
parameters' gradient accumulators take as their ``.grad``: the tensors
the optimizer (``torch.optim.SGD``, ``AdamW``) reads.

Where it engages.  Only where the backend serves the input
(``CudaGraphs``: a CUDA tensor, outside another capture), no process
group is initialised (the synced BN runs collectives) and the input
takes no gradient.  Everywhere else (the CPU, ``--n_devices``,
``--multihost``) the call is the plain one.  The evaluator does not call
its model through here.

Spans and tallies.  Every call that engages runs in a span
``graph_replay`` or ``graph_eager`` (``utils/profiling.py::span``),
inside the caller's span named after the model's class, and adds to the
tallies ``graph_replay``, ``graph_capture`` and ``graph_eager`` of any
open recording (a capturing call counts a capture and a replay); a plain
call opens and tallies nothing.  A replayed
forward's kernels are launched inside the model's span, and the
backward's inside the autograd node that the sequence number joins to
the function's call there: the profiler's scope rule charges both to the
model, as it charges the eager call's kernels.  A port kernel's launch
tally (``ops/group_norm.py``) counts the calls of its wrapper, so a
captured call counts once, at its capture; its replays are counted where
they run, from the device's records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable

import torch
import torch.nn as nn

from ..parallel import dist
from ..utils.profiling import count, span

EAGER_CALLS = 1  # finished eager calls of a key before its capture
MAX_GRAPHS = 2  # graphs one key may hold


class CudaGraphs:
    """The capture backend on the card: each device's graphed calls on one
    side stream of its own."""

    def __init__(self):
        self._streams: dict[int, torch.cuda.Stream] = {}

    def serves(self, x: torch.Tensor) -> bool:
        return x.is_cuda and not torch.cuda.is_current_stream_capturing()

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        s = self._streams.get(device.index)
        if s is None:
            s = self._streams[device.index] = torch.cuda.Stream(device)
        return s

    @contextlib.contextmanager
    def stream(self, device: torch.device):
        """The body on the side stream, after the caller's queued work and
        before what the caller queues next."""
        s, caller = self._stream(device), torch.cuda.current_stream(device)
        s.wait_stream(caller)
        with torch.cuda.stream(s):
            yield
        caller.wait_stream(s)

    def capture(self, fn: Callable, device: torch.device, generators, pool=None):
        """(graph, fn's outputs): ``fn`` captured on the capture stream,
        ``generators`` registered, in ``pool`` or a new private one."""
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        # thread_local: the loop's loader and prefetch threads keep allocating
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=pool, stream=self._stream(device), capture_error_mode="thread_local"):
            out = fn()
        return graph, out


def _flatten(out) -> tuple[list, Callable]:
    """(the tensors of a call's output, in order, None kept; the inverse)."""
    if out is None:
        return [], lambda flat: None
    if isinstance(out, torch.Tensor):
        return [out], lambda flat: flat[0]
    if type(out) in (tuple, list) and all(o is None or isinstance(o, torch.Tensor) for o in out):
        kind = type(out)
        return list(out), lambda flat: kind(flat)
    raise TypeError(f"a graphed call returns a tensor, a tuple or list of tensors, or None; "
                    f"got {type(out).__name__}")


@contextlib.contextmanager
def _uncached_autocast():
    """Casts inside a capture are recorded, not looked up: a weight cast
    cached before the capture would be stale at every replay, and one cast
    inside it must not outlive it."""
    enabled = torch.is_autocast_cache_enabled()
    torch.clear_autocast_cache()
    torch.set_autocast_cache_enabled(False)
    try:
        yield
    finally:
        torch.set_autocast_cache_enabled(enabled)


@dataclasses.dataclass(eq=False)
class _Graph:
    """One captured call of a key: its static input, its forward graph and
    static outputs, and for a forward with gradients its backward graph."""

    static_in: torch.Tensor
    fwd: object
    outputs: list                  # static outputs (aliases), None kept
    rebuild: Callable              # outputs -> the call's output structure
    diff: list = dataclasses.field(default_factory=list)  # indices of outputs with gradients
    params: list = dataclasses.field(default_factory=list)
    bwd: object = None
    grad_in: list = dataclasses.field(default_factory=list)  # static gradients of outputs[diff]
    grad_zero: list = dataclasses.field(default_factory=list)
    grads: list = dataclasses.field(default_factory=list)    # static gradients of params
    handed: list = dataclasses.field(default_factory=list)   # weakrefs to the last call's aliases
    node: object = None            # weakref to the pending backward's autograd node
    generation: int = 0

    def in_use(self) -> bool:
        return (any(r() is not None for r in self.handed)
                or (self.node is not None and self.node() is not None))

    def run(self, x: torch.Tensor) -> int:
        with torch.no_grad():
            self.static_in.copy_(x)
        self.fwd.replay()
        self.generation += 1
        return self.generation

    def backward(self, generation: int, grads) -> list:
        if generation != self.generation:
            raise RuntimeError("a graphed call was replayed again before the backward of its "
                               "previous replay ran")
        for i, g in enumerate(grads):
            if g is None:
                if not self.grad_zero[i]:
                    self.grad_in[i].zero_()
                    self.grad_zero[i] = True
            else:
                self.grad_in[i].copy_(g)
                self.grad_zero[i] = False
        self.bwd.replay()
        self.node = None
        return [None if g is None else g.detach() for g in self.grads]


class _Replay(torch.autograd.Function):
    """A graphed forward with gradients: ``apply(graph, x, *params)``."""

    @staticmethod
    def forward(ctx, graph: _Graph, x: torch.Tensor, *params):
        ctx.set_materialize_grads(False)
        ctx.graph, ctx.generation = graph, graph.run(x)
        return tuple(graph.outputs[i].detach() for i in graph.diff)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.graph.backward(ctx.generation, grads))


def _autocast_state(device_type: str) -> tuple:
    return (torch.is_autocast_enabled(device_type), torch.get_autocast_dtype(device_type))


class ModelCalls:
    """The train step's calls of its segmentation models, replayed as graphs
    where ``backend`` serves them (``CudaGraphs()`` on the card), plain
    calls everywhere else and with no backend."""

    def __init__(self, backend=None):
        self.backend = backend
        self._warm: dict[tuple, list] = {}  # key -> [its finished eager calls]
        self._graphs: dict[tuple, list[_Graph]] = {}
        self._holders: dict[nn.Module, list] = {}  # module -> [(submodule, attribute)]

    def forward(self, model: nn.Module, x: torch.Tensor):
        return self._call(model, "forward", x)

    def bn_stats_forward(self, model: nn.Module, x: torch.Tensor):
        return self._call(model, "bn_stats_forward", x)

    def _engages(self, x: torch.Tensor) -> bool:
        return (self.backend is not None and self.backend.serves(x) and not dist.active()
                and not x.requires_grad)

    def _generators(self, model: nn.Module) -> list:
        holders = self._holders.get(model)
        if holders is None:
            holders = self._holders[model] = [
                (m, k) for m in model.modules() for k, v in vars(m).items()
                if isinstance(v, torch.Generator)]
        return [getattr(m, k) for m, k in holders]

    @staticmethod
    def _eager(fn: Callable, x: torch.Tensor):
        with span("graph_eager"):
            count("graph_eager")
            return fn(x)

    def _warm_up(self, fn: Callable, x: torch.Tensor, warm: list):
        """An eager call, counted in ``warm`` once it has finished: at once,
        or when the first of its outputs that take gradients gets one."""
        out = self._eager(fn, x)
        diff = [o for o in _flatten(out)[0] if o is not None and o.requires_grad]
        if not diff:
            warm[0] += 1
            return out
        done = []

        def finished(grad):
            if not done:
                done.append(True)
                warm[0] += 1

        for o in diff:
            o.register_hook(finished)
        return out

    def _call(self, model: nn.Module, method: str, x: torch.Tensor):
        fn = model if method == "forward" else getattr(model, method)  # forward: with its hooks
        if not self._engages(x):
            return fn(x)
        grad = torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())
        gens = self._generators(model)
        key = (model, method, grad, model.training, _autocast_state(x.device.type),
               tuple(x.shape), x.dtype, tuple(id(g) for g in gens))
        with self.backend.stream(x.device):
            warm = self._warm.setdefault(key, [0])
            if warm[0] < EAGER_CALLS:
                return self._warm_up(fn, x, warm)
            graphs = self._graphs.setdefault(key, [])
            graph = next((g for g in graphs if not g.in_use()), None)
            if graph is None and len(graphs) >= MAX_GRAPHS:
                return self._eager(fn, x)
            with span("graph_replay"):
                count("graph_replay")
                if graph is None:
                    graph = self._capture(model, fn, x, grad, gens)
                    graphs.append(graph)
                    count("graph_capture")
                return self._replay(graph, x)

    def _capture(self, model: nn.Module, fn: Callable, x: torch.Tensor, grad: bool,
                 gens: list) -> _Graph:
        static_in = torch.empty_like(x)
        with torch.no_grad():
            static_in.copy_(x)
        held = []  # the captured call's outputs, for the backward's capture

        def forward():
            out = fn(static_in)
            held[:] = [out]
            return out

        with _uncached_autocast():
            fwd, out = self.backend.capture(forward, x.device, gens)
        flat, rebuild = _flatten(out)
        graph = _Graph(static_in, fwd, [None if o is None else o.detach() for o in flat],
                       rebuild)
        diff = [i for i, o in enumerate(flat) if o is not None and o.requires_grad]
        if grad and diff:
            graph.diff = diff
            graph.params = [p for p in model.parameters() if p.requires_grad]
            graph.grad_in = [torch.zeros_like(flat[i]) for i in graph.diff]
            graph.grad_zero = [True] * len(graph.diff)

            def backward():
                outs = _flatten(held[0])[0]
                return torch.autograd.grad([outs[i] for i in graph.diff], graph.params,
                                           graph.grad_in, allow_unused=True)

            bwd, grads = self.backend.capture(backward, x.device, (), pool=fwd.pool())
            graph.bwd, graph.grads = bwd, list(grads)
        held.clear()
        return graph

    @staticmethod
    def _replay(graph: _Graph, x: torch.Tensor):
        if graph.bwd is None:
            graph.run(x)
            flat = [None if o is None else o.detach() for o in graph.outputs]
        else:
            diff = _Replay.apply(graph, x, *graph.params)
            graph.node = weakref.ref(diff[0].grad_fn)
            flat = [None if o is None else o.detach() for o in graph.outputs]
            for i, o in zip(graph.diff, diff):
                flat[i] = o
        graph.handed = [weakref.ref(o) for o in flat if o is not None]
        return graph.rebuild(flat)
