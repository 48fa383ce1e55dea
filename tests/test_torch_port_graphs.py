"""The train step's model calls as CUDA graphs (``train/graphs.py``).

On the CPU, with the capture backend replaced by ``FakeGraphs`` (a
"capture" runs the call to learn its outputs, then puts the modules'
buffers and the generators back as they were, since a capture runs
nothing; a "replay" runs the call again, with the grad mode of its
capture, and writes the results into the captured outputs, which the
wrapper's aliases share):

* 3 DG, warm-up and self-training steps through the wrapper equal the
  plain steps bit for bit (metrics, parameters, BN statistics and
  counters, SGD momentum, every generator) on the tiny DeepLab and
  HRNet+OCR configs, with the tallies of eager calls, captures and
  replays the policy predicts (the self-training step calls the teacher
  and the student twice at one shape: two graphs each);
* a key's first ``EAGER_CALLS`` calls run eagerly (a forward with
  gradients until its backward has run), the next captures and replays
  once, later ones replay; a new shape, grad mode or method
  makes a new key; a graph whose outputs are still held is not replayed
  (another is captured, and past ``MAX_GRAPHS`` the call is eager); the
  parameters' gradients are the graph's own memory, not copies; an
  initialised process group never captures; the spans and tallies
  appear in a recording;
* the step builders (and so ``build_experiment``) default to graphed
  calls of their own, which run plain on the CPU;
* ``port_launches`` counts the port's kernels by their device records'
  names.

On the card (``cuda`` marker; they skip here): 5 graphed steps against 5
eager steps from the same state and draws, on the tiny HRNet+OCR semiseg
warm-up, the tiny DeepLab warm-up, the tiny DeepLab self-training step
and the tiny MiT warm-up (AdamW; the head's depthwise kernels), in f32
with deterministic algorithms: the metrics, parameters, BN statistics,
``num_batches_tracked``, the optimizer's state and both dropout
generators are equal bit for bit (inside any tolerance of the semiseg
parity); each step's loss is a tensor of its own; and the card's records
of the port's kernels count as many launches in the graphed steps as in
the eager ones, on MiT 12 depthwise forward-kernel launches and 3 weight
gradients a step.  Without deterministic
algorithms two eager runs already differ (the bilinear upsample's
backward adds with atomics), by up to a few percent of the momentum on
these ill-conditioned tiny models.
"""

import contextlib
import dataclasses

import pytest
import torch
import torch.distributed as tdist
import torch.nn as nn

from diga_tpu_torch.configs import presets
from diga_tpu_torch.models import hrnet_ocr, mit_daformer
from diga_tpu_torch.models.resnet_deeplab import ChannelDropout
from diga_tpu_torch.train import graphs
from diga_tpu_torch.train import steps as steps_module
from diga_tpu_torch.train.build import build_experiment, make_schedule, make_step_config
from diga_tpu_torch.train.graphs import MAX_GRAPHS, ModelCalls
from diga_tpu_torch.train.steps import build_dg_step, build_selftrain_step, build_warmup_step
from diga_tpu_torch.utils import profiling
from diga_tpu_torch.utils.synth import synth_batch

CPU = torch.device("cpu")
TINY_HRNET = {
    "stem_channels": 8,
    "stage1_blocks": 1,
    "stage1_channels": 8,
    "stages": [(1, 1, (8, 16)), (1, 1, (8, 16, 32)), (1, 1, (8, 16, 32, 64))],
    "ocr_mid_channels": 32,
    "ocr_key_channels": 16,
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    the tiny HRNet's small ops only contend across more."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _tiny_hrnet(monkeypatch):
    monkeypatch.setitem(hrnet_ocr.ARCHS, "tiny", TINY_HRNET)


# ---------------------------------------------------------------------------
# the fake capture backend
# ---------------------------------------------------------------------------

def _leaves(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [] if out is None else [out]


class _FakeGraph:
    def __init__(self, fn, out, grad: bool):
        self.fn, self.out, self.grad = fn, out, grad

    def replay(self):
        with torch.set_grad_enabled(self.grad):
            fresh = self.fn()
        with torch.no_grad():
            for static, new in zip(_leaves(self.out), _leaves(fresh)):
                if static is not None:
                    static.detach().copy_(new)

    def pool(self):
        return None


class FakeGraphs:
    """A capture backend on the CPU for ``modules``' calls."""

    def __init__(self, *modules):
        self.modules, self.captures = modules, 0  # the modules: set later, where unknown

    def serves(self, x):
        return x.device.type == "cpu"

    def stream(self, device):
        return contextlib.nullcontext()

    def capture(self, fn, device, generators, pool=None):
        buffers = [b for m in self.modules for b in m.buffers()]
        kept = [b.clone() for b in buffers]
        gens = [*generators, torch.default_generator]
        states = [g.get_state() for g in gens]
        out = fn()
        for b, v in zip(buffers, kept):
            b.data.copy_(v)  # untracked: the captured forward saved them for its backward
        for g, s in zip(gens, states):
            g.set_state(s)
        self.captures += 1
        return _FakeGraph(fn, out, torch.is_grad_enabled()), out


# ---------------------------------------------------------------------------
# whole steps: the wrapper against the plain calls
# ---------------------------------------------------------------------------

def _tiny(name: str, source: int, target: int, **extra):
    p = presets.get_preset(name)
    return dataclasses.replace(
        p, data=dataclasses.replace(
            p.data, source_streams=(presets.LoaderSpec("gta5", (32, 64), source),),
            target_streams=(presets.LoaderSpec("cityscapes", (32, 64), target),)),
        train=dataclasses.replace(p.train, crop_hw=(32, 64), compute_dtype="float32"),
        extra={**p.extra, **extra})


def _deeplab(name, source=1, target=1):
    return _tiny(name, source, target, layers=(1, 1, 1, 1))


def _hrnet(name, source=1, target=1):
    return _tiny(name, source, target, hrnet_arch="tiny",
                 feat_dim=TINY_HRNET["ocr_mid_channels"])


# (config, model calls a step, eager calls, captures): the teacher, the
# student and its target-stats forward a step, each eager at step 0 and
# captured at step 1; the self-training step calls the teacher on [source;
# mix] and the target batch, the student on [source; mix] and the DACS
# image, one shape each: the teacher's second call captures at step 0, the
# student's runs eagerly too (the first call's backward has not run yet),
# and from step 1 both calls of a model are in use at once: two graphs each
CASES = {
    "deeplab_dg": (lambda: _deeplab("dg_gta5"), 3, 3, 3),
    "deeplab_warmup": (lambda: _deeplab("gta2city_warmup"), 3, 3, 3),
    "hrnet_semiseg_warmup": (lambda: _hrnet("semiseg_1_8_warmup"), 3, 3, 3),
    "deeplab_selftrain": (lambda: _deeplab("gta2city_selftrain", 1, 2), 4, 3, 4),
}


def _builder(cfg, state):
    if cfg.stage == "selftrain":
        return build_selftrain_step
    return build_warmup_step if state.translator is not None else build_dg_step


def _state_values(state) -> dict:
    out = {}
    for role in ("student", "teacher"):
        for k, v in getattr(state, role).state_dict().items():
            out[f"{role}.{k}"] = v
    for i, st in enumerate(state.optimizer.state.values()):
        for k, v in st.items():  # SGD's momentum; AdamW's step and moments
            out[f"optimizer.{i}.{k}"] = v
    for k, g in state.generators().items():
        out[k] = g.get_state()
    return out


def _steps(cfg, graphed: bool, n: int = 3, device=CPU, launches: dict | None = None):
    """``n`` steps of ``cfg`` on ``device``: on the CPU graphed through
    ``FakeGraphs``, on the card through ``build_experiment``'s own calls;
    else the plain calls (``build_experiment``'s own on the CPU).
    ``launches`` (the card): filled with the steps' launches of the port's
    kernels, from the card's records."""
    state, step, _ = build_experiment(cfg, device)
    calls = None
    if graphed and device == CPU:
        calls = ModelCalls(FakeGraphs(state.student, state.teacher))
        step = _builder(cfg, state)(make_step_config(cfg), make_schedule(cfg), calls)
    elif not graphed and device != CPU:
        step = _builder(cfg, state)(make_step_config(cfg), make_schedule(cfg), ModelCalls())
    metrics = []
    counting = profiling.device_launches() if launches is not None else contextlib.nullcontext({})
    with profiling.recording() as rec, counting as found:
        for i in range(n):
            metrics.append(step(state, synth_batch(cfg, device, seed=i)))
    if launches is not None:
        launches.update(found)
    return state, metrics, dict(rec.counts), calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_steps_equal_plain_steps_bit_for_bit(case):
    make_cfg, calls_a_step, eager, captures = CASES[case]
    cfg = make_cfg()
    plain, plain_metrics, plain_counts, _ = _steps(cfg, graphed=False)
    state, metrics, counts, calls = _steps(cfg, graphed=True)

    assert plain_counts == {}  # the CPU: the plain calls, no span, no tally
    assert counts == {"graph_eager": eager, "graph_capture": captures,
                      "graph_replay": 3 * calls_a_step - eager}
    assert calls.backend.captures == captures + sum(
        1 for gs in calls._graphs.values() for g in gs if g.bwd is not None)
    for i, (a, b) in enumerate(zip(metrics, plain_metrics)):
        for k in b:
            assert torch.equal(a[k], b[k]), (i, k, a[k], b[k])
    want, got = _state_values(plain), _state_values(state)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the policy, on a small module
# ---------------------------------------------------------------------------

class Small(nn.Module):
    """A conv, a train-mode BN and a channel dropout with a generator of its own."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.bn = nn.BatchNorm2d(4)
        self.drop = ChannelDropout(0.5)
        self.drop.generator = torch.Generator().manual_seed(3)

    def forward(self, x):
        y = self.drop(self.bn(self.conv(x)))
        return y, y.mean(dim=(2, 3))

    def bn_stats_forward(self, x):
        self.bn(self.conv(x))


def _x(batch=2, seed=0):
    return torch.randn(batch, 3, 6, 8, generator=torch.Generator().manual_seed(seed))


def _call(calls, model, x, method="forward"):
    with profiling.span(type(model).__name__):
        return getattr(calls, method)(model, x)


def test_first_calls_are_eager_then_one_capture_then_replays():
    m = Small()
    calls, eager_calls = ModelCalls(FakeGraphs(m)), graphs.EAGER_CALLS
    seen = []
    with profiling.recording() as rec:
        for i in range(eager_calls + 3):
            with torch.no_grad():
                _call(calls, m, _x(seed=i))
            seen.append(dict(rec.counts))
    for i in range(eager_calls):
        assert seen[i] == {"graph_eager": i + 1}
    assert seen[eager_calls] == {"graph_eager": eager_calls, "graph_capture": 1,
                                 "graph_replay": 1}
    assert seen[-1] == {"graph_eager": eager_calls, "graph_capture": 1, "graph_replay": 3}
    assert calls.backend.captures == 1


def test_a_forward_with_gradients_captures_only_after_a_warm_up_backward():
    m = Small()
    calls = ModelCalls(FakeGraphs(m))
    with profiling.recording() as rec:
        a, b = _call(calls, m, _x(seed=0)), _call(calls, m, _x(seed=1))
        assert dict(rec.counts) == {"graph_eager": 2}  # no backward has run yet
        (a[1].sum() + b[1].sum()).backward()
        c = _call(calls, m, _x(seed=2))
        c[1].sum().backward()
    assert dict(rec.counts) == {"graph_eager": 2, "graph_capture": 1, "graph_replay": 1}


def test_a_new_shape_grad_mode_or_method_makes_a_new_key():
    m = Small()
    calls = ModelCalls(FakeGraphs(m))
    variants = [
        (lambda: torch.no_grad(), 2, "forward"),
        (lambda: torch.no_grad(), 3, "forward"),              # shape
        (lambda: contextlib.nullcontext(), 2, "forward"),     # grad mode
        (lambda: torch.no_grad(), 2, "bn_stats_forward"),     # method
    ]
    with profiling.recording() as rec:
        for mode, batch, method in variants:
            for i in range(2):
                with mode():
                    out = _call(calls, m, _x(batch, i), method)
                if method == "forward" and torch.is_grad_enabled() and out[0].requires_grad:
                    out[1].sum().backward()
                del out
    assert len(calls._graphs) == 4
    assert dict(rec.counts) == {"graph_eager": 4, "graph_capture": 4, "graph_replay": 4}


def test_a_graph_whose_outputs_are_held_is_not_replayed():
    m = Small()
    calls = ModelCalls(FakeGraphs(m))
    with torch.no_grad():
        _call(calls, m, _x(seed=0))  # eager
        first = _call(calls, m, _x(seed=1))
        kept = first[0].clone()
        second = _call(calls, m, _x(seed=2))  # the first graph is held: a second one
        assert torch.equal(first[0], kept)
        third = _call(calls, m, _x(seed=3))  # both held, MAX_GRAPHS reached: eager
        assert torch.equal(first[0], kept)
        assert len(calls._graphs[next(iter(calls._graphs))]) == MAX_GRAPHS == 2
        del first, second, third
        with profiling.recording() as rec:
            _call(calls, m, _x(seed=4))
    assert dict(rec.counts) == {"graph_replay": 1}
    assert calls.backend.captures == 2


def test_gradients_land_in_the_graphs_memory_and_match_eager():
    torch.manual_seed(0)
    eager, graphed = Small(), Small()
    graphed.load_state_dict(eager.state_dict())
    calls = ModelCalls(FakeGraphs(graphed))
    for i in range(3):
        x = _x(seed=i)
        for m, call in ((eager, lambda m, x: m(x)), (graphed, lambda m, x: _call(calls, m, x))):
            y, pooled = call(m, x)
            (y.square().mean() + pooled.sum()).backward()
        for p, q in zip(eager.parameters(), graphed.parameters()):
            assert torch.equal(p.grad, q.grad)
        if i > 0:  # the graph's gradients, taken as .grad without a copy
            (graph,) = next(iter(calls._graphs.values()))
            assert [q.grad.data_ptr() for q in graphed.parameters()] == \
                [g.data_ptr() for g in graph.grads]
        for m in (eager, graphed):
            m.zero_grad(set_to_none=True)
    assert torch.equal(eager.bn.running_mean, graphed.bn.running_mean)
    assert torch.equal(eager.bn.num_batches_tracked, graphed.bn.num_batches_tracked)
    assert torch.equal(eager.drop.generator.get_state(), graphed.drop.generator.get_state())


def test_a_process_group_never_captures(tmp_path):
    m = Small()
    calls = ModelCalls(FakeGraphs(m))
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        with profiling.recording() as rec, torch.no_grad():
            for i in range(4):
                _call(calls, m, _x(seed=i))
    finally:
        tdist.destroy_process_group()
    assert dict(rec.counts) == {}
    assert calls.backend.captures == 0 and not calls._graphs


def test_no_backend_and_inputs_with_gradients_are_plain_calls():
    m = Small()
    with profiling.recording() as rec, torch.no_grad():
        for i in range(3):
            _call(ModelCalls(), m, _x(seed=i))
    calls = ModelCalls(FakeGraphs(m))
    with profiling.recording() as rec2:
        for i in range(3):
            _call(calls, m, _x(seed=i).requires_grad_())
    assert dict(rec.counts) == dict(rec2.counts) == {}
    assert rec.spans == [("Small", None, *s[2:]) for s in rec.spans]
    assert calls.backend.captures == 0


def test_spans_and_tallies_in_a_recording():
    m = Small()
    calls = ModelCalls(FakeGraphs(m))
    with profiling.recording() as rec, torch.no_grad():
        for i in range(3):
            _call(calls, m, _x(seed=i))
    spans = [(name, parent) for name, parent, *_ in rec.spans]
    assert spans == [("graph_eager", "Small"), ("Small", None),
                     ("graph_replay", "Small"), ("Small", None),
                     ("graph_replay", "Small"), ("Small", None)]
    assert dict(rec.counts) == {"graph_eager": 1, "graph_capture": 1, "graph_replay": 2}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_builders_default_to_graphed_calls_of_their_own(case, monkeypatch):
    make_cfg, calls_a_step, eager, captures = CASES[case]
    backends = []

    def cuda_graphs():  # serves the CPU, as CudaGraphs serves the card
        backends.append(FakeGraphs())
        return backends[-1]

    monkeypatch.setattr(steps_module, "CudaGraphs", cuda_graphs)
    cfg = make_cfg()
    state, step, _ = build_experiment(cfg, CPU)
    _builder(cfg, state)(make_step_config(cfg), make_schedule(cfg))
    assert len(backends) == 2  # one each: a step's graphs are its own
    backends[0].modules = (state.student, state.teacher)
    with profiling.recording() as rec:
        for i in range(2):
            step(state, synth_batch(cfg, CPU, seed=i))
    assert dict(rec.counts) == {"graph_eager": eager, "graph_capture": captures,
                                "graph_replay": 2 * calls_a_step - eager}
    assert backends[1].captures == 0


def _record(name: str, n: int) -> tuple:
    return (1e-6 * n, n, name)  # a ProfileReport.top_ops entry: (seconds, count, name)


def test_port_launches_count_the_kernels_by_their_records_names():
    ops = [_record("void (anonymous namespace)::gn_stats_kernel<float>(float const*, int)", 4),
           _record("void (anonymous namespace)::gn_stats_kernel<__nv_bfloat16>(int)", 2),
           _record("void (anonymous namespace)::gn_apply_kernel<float>(float const*)", 6),
           _record("void (anonymous namespace)::distill_partial_kernel<float>(float const*)", 3),
           _record("(anonymous namespace)::distill_fold_kernel(float const*, int)", 3),
           _record("distill_grad_kernel<__nv_bfloat16>", 3),
           _record("void my_gn_stats_kernel_v2(float*)", 7),
           _record("void at::native::elementwise_kernel<128, 2>(int)", 9),
           _record("void (anonymous namespace)::depthwise_conv3x3_kernel<__nv_bfloat16>("
                   "__nv_bfloat16 const*, (anonymous namespace)::Walk, int)", 12),
           _record("void (anonymous namespace)::depthwise_wgrad_kernel<float>(float const*)", 3),
           _record("void (anonymous namespace)::depthwise_wgrad_fold_kernel<float>(int)", 3),
           _record("void at::native::conv_depthwise2d_forward_kernel<3>(float*)", 5)]
    assert profiling.port_launches(ops) == {"distill_loss": 3, "distill_grad": 3,
                                            "group_norm_stats": 6, "group_norm_apply": 6,
                                            "depthwise_fwd": 12, "depthwise_wgrad": 3}
    assert profiling.port_launches([]) == dict.fromkeys(profiling.PORT_LAUNCHES, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# MiT-B5's shape cut to 2 blocks a stage and a 64-wide head (its sep-ASPP
# head's depthwise convs run the port's kernels)
TINY_MIT = {"embed_dims": (32, 64, 160, 256), "num_heads": (1, 2, 5, 8), "depths": (2, 2, 2, 2),
            "sr_ratios": (8, 4, 2, 1), "mlp_ratio": 4, "drop_path_rate": 0.1,
            "head_channels": 64, "aspp_dilations": (1, 6, 12, 18)}


@pytest.fixture
def _tiny_mit(monkeypatch):
    monkeypatch.setitem(mit_daformer.ARCHS, "tiny", TINY_MIT)


def _mit(name, source=1, target=1):
    return _tiny(name, source, target, mit_arch="tiny")


CARD_CASES = {
    "hrnet_semiseg_warmup": lambda: _hrnet("semiseg_1_8_warmup", 2, 2),
    "deeplab_warmup": lambda: _deeplab("gta2city_warmup", 2, 2),
    "deeplab_selftrain": lambda: _deeplab("gta2city_selftrain", 1, 2),  # as on the CPU
    "mit_warmup": lambda: _mit("gta2city_warmup_mitb5", 2, 2),
}


@pytest.fixture
def _deterministic():
    """Deterministic algorithms, f32 without TF32: then two eager runs on the
    card agree bit for bit, and so must the graphed one."""
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.use_deterministic_algorithms(flags[0])
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_graphed_steps_equal_eager_steps_on_the_card(case, _deterministic, _tiny_mit):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    cfg, cuda = CARD_CASES[case](), torch.device("cuda")
    eager, eager_metrics, eager_counts, _ = _steps(cfg, graphed=False, n=5, device=cuda)
    state, metrics, counts, _ = _steps(cfg, graphed=True, n=5, device=cuda)
    assert eager_counts == {}
    assert counts["graph_capture"] >= 3 and counts["graph_replay"] >= 4 * counts["graph_eager"]
    losses = [m["loss"] for m in metrics]
    assert len({t.data_ptr() for t in losses}) == len(losses)
    for i, (a, b) in enumerate(zip(metrics, eager_metrics)):
        for k in b:
            assert torch.equal(a[k], b[k]), (i, k, a[k], b[k])
    want, got = _state_values(eager), _state_values(state)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_the_cards_records_count_the_launches_of_replayed_graphs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    cfg, cuda, n = _deeplab("gta2city_warmup", 2, 2), torch.device("cuda"), 4
    eager, graphed = {}, {}
    *_, eager_counts, _ = _steps(cfg, graphed=False, n=n, device=cuda, launches=eager)
    *_, counts, _ = _steps(cfg, graphed=True, n=n, device=cuda, launches=graphed)
    assert eager_counts == {} and counts["graph_replay"] > 0
    assert eager["distill_loss"] == eager["distill_grad"] == n
    assert eager["group_norm_stats"] == eager["group_norm_apply"] > 0
    assert graphed == eager


@pytest.mark.cuda
def test_a_graphed_mit_step_launches_the_depthwise_kernels(_tiny_mit):
    """Each step: 12 forward-kernel launches (teacher, student and the
    target statistics, 3 convs each, and the student's 3 input gradients)
    and 3 weight gradients, eager and replayed alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    cfg, cuda, n = _mit("gta2city_warmup_mitb5", 2, 2), torch.device("cuda"), 4
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    eager, graphed = {}, {}
    *_, eager_counts, _ = _steps(cfg, graphed=False, n=n, device=cuda, launches=eager)
    *_, counts, _ = _steps(cfg, graphed=True, n=n, device=cuda, launches=graphed)
    assert eager_counts == {} and counts["graph_replay"] > 0
    assert eager["depthwise_fwd"] == 12 * n and eager["depthwise_wgrad"] == 3 * n
    assert graphed == eager
