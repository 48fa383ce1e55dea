"""The port's HRNet+OCR against ``diga_tpu``'s, on the CPU.

* the forward in eval and in train mode (``droprate=0``) of a tiny arch at
  32x64, weights through ``hrnet_state_dict_from_jax`` loaded strictly:
  the four outputs within 1e-4 of the reference's largest magnitude, and
  after the train-mode forward the BN running statistics likewise;
* ``state_dict()``'s key order is the port converter's, its backbone part
  is the JAX ``hrnet_ocr_to_torch``'s, and W48 loads strictly;
* the ImageNet hrnetv2 init, ``hrnet_imagenet_state_dict``, against
  ``hrnet_imagenet_init`` on a seeded checkpoint in the ImageNet file's
  naming (``module.`` prefixed, BN counters, a trailing classifier), and
  its four ``RuntimeError`` cases, raised by both;
* the SGD groups: every HRNet parameter, BN affine included, at 1x with
  weight decay, as ``head_param_mask`` labels them.

The JAX model reads its arch at call time (``arch_name`` other than
``w48`` means ``W32``), so ``W32`` is patched to the tiny arch on the JAX
side only; the port takes the arch dict.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import diga_tpu.models.hrnet_ocr as H
from diga_tpu.models.convert_hrnet import hrnet_imagenet_init, hrnet_ocr_to_torch
from diga_tpu.models.resnet_deeplab import head_param_mask
from diga_tpu_torch.models import hrnet_ocr as port_hrnet
from diga_tpu_torch.models.convert import hrnet_imagenet_state_dict, hrnet_state_dict_from_jax
from diga_tpu_torch.models.hrnet_ocr import W48, HRNetOCR
from diga_tpu_torch.train.optim import param_groups, sgd_grouped

TINY = {
    "stem_channels": 8,
    "stage1_blocks": 1,
    "stage1_channels": 8,
    "stages": [
        (1, 1, (8, 16)),
        (1, 1, (8, 16, 32)),
        (1, 1, (8, 16, 32, 64)),
    ],
    "ocr_mid_channels": 32,
    "ocr_key_channels": 16,
}
JAX_W32 = H.W32  # before any patching
K = 19
X_HW = (32, 64)
OUTPUTS = ["feats", "aux", "logits", "aug"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    the tiny HRNet's thousand small ops a step only contend across more."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_tiny():
    """(model, params, stats) of the JAX tiny HRNetOCR: a jitted init (eager,
    about 50 s), every 1-D leaf moved off its init, variances positive."""
    saved = H.W32
    H.W32 = TINY
    try:
        model = H.HRNetOCR(num_classes=K, arch_name="tiny", droprate=0.0)
        k = jax.random.PRNGKey(0)
        variables = jax.jit(model.init, static_argnames=("train",))(
            {"params": k, "dropout": k}, jnp.zeros((1, *X_HW, 3)), train=False)
        rng = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + (rng.normal(size=a.shape).astype(np.float32) * 0.1
                                       if a.ndim == 1 else 0.0), variables["params"])
        stats = jax.tree_util.tree_map(
            lambda a: np.abs(np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.1),
            variables["batch_stats"])
        yield model, params, stats
    finally:
        H.W32 = saved


def _port(params, stats) -> HRNetOCR:
    model = HRNetOCR(num_classes=K, arch=TINY, droprate=0.0)
    model.load_state_dict(hrnet_state_dict_from_jax(params, stats, TINY), strict=True)
    return model


@pytest.fixture(scope="module")
def forwards(jax_tiny):
    """Both packages' outputs in eval and train mode on one seeded batch, and
    the running statistics after the train-mode forward."""
    model, params, stats = jax_tiny
    x = np.random.default_rng(2).normal(size=(2, *X_HW, 3)).astype(np.float32)
    apply = jax.jit(model.apply, static_argnames=("train", "mutable"))
    out = {}
    for train in (False, True):
        ref, mut = apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
                         mutable=("batch_stats",))
        port = _port(params, stats).train(train)
        with torch.no_grad():
            ours = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        out[train] = {
            "ref": [np.asarray(r) for r in ref],
            "ours": [o.permute(0, 2, 3, 1).numpy() for o in ours],
            "ref_stats": hrnet_state_dict_from_jax(params, _np(mut["batch_stats"]), TINY),
            "ours_stats": port.state_dict()}
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("i,name", list(enumerate(OUTPUTS)))
def test_forward_matches_jax(forwards, train, i, name):
    ref, ours = forwards[train]["ref"][i], forwards[train]["ours"][i]
    assert ours.shape == ref.shape
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= 1e-4 * scale, f"{name}: max_abs_err {err:.3e}, max|ref| {scale:.3e}"


def test_train_forward_running_stats_match_jax(forwards):
    ref, ours = forwards[True]["ref_stats"], forwards[True]["ours_stats"]
    keys = [k for k in ref if "running" in k]
    assert len(keys) == 2 * sum(1 for k in ref if k.endswith("running_mean"))
    moved = 0
    for k in keys:
        want = ref[k].numpy()
        np.testing.assert_allclose(ours[k].numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=k)
        moved += not np.array_equal(want, forwards[False]["ref_stats"][k].numpy())
    assert moved == len(keys)


def test_state_dict_order_is_the_converters(jax_tiny):
    _, params, stats = jax_tiny
    ours = [k for k in HRNetOCR(K, TINY).state_dict() if not k.endswith("num_batches_tracked")]
    assert ours == list(hrnet_state_dict_from_jax(params, stats, TINY))
    jax_sd = hrnet_ocr_to_torch(params, stats, TINY)
    assert set(ours) == set(jax_sd)
    # the backbone in the JAX converter's order (the ImageNet init's pairing);
    # the two BN-absorbed OCR conv biases sit beside their weights here
    assert [k for k in ours if k.startswith("hrnet.")] == \
        [k for k in jax_sd if k.startswith("hrnet.")]
    for k in ("ocrnet.pixel_representations.0.bias", "ocrnet.soft_object_regions.0.bias"):
        assert ours.index(k) == ours.index(k.replace(".bias", ".weight")) + 1


def test_w48_loads_the_converters_output_strictly():
    model = H.HRNetOCR(num_classes=K, arch_name="w48")
    shapes = jax.eval_shape(lambda k: model.init({"params": k, "dropout": k},
                                                 jnp.zeros((1, 64, 64, 3)), train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = hrnet_state_dict_from_jax(zeros["params"], zeros["batch_stats"], W48)
    port = HRNetOCR(num_classes=K, arch=W48)
    port.load_state_dict(sd, strict=True)
    assert port.hrnet.out_channels == 720
    assert sum(p.numel() for p in port.parameters()) == \
        sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))


# ---------------------------------------------------------------------------
# the ImageNet hrnetv2 init
# ---------------------------------------------------------------------------

_IMAGENET_NAMES = (("hrnet.stage1.", "layer1."), ("hrnet.transition_stage_1_2.", "transition1."),
                   ("hrnet.transition_stage_2_3.", "transition2."),
                   ("hrnet.transition_stage_3_4.", "transition3."), ("hrnet.", ""))


def _imagenet_checkpoint(params, stats, seed=5) -> dict:
    """A seeded checkpoint in the hrnetv2 ImageNet file's layout: the
    backbone's tensors in order under the classification net's names, a
    ``num_batches_tracked`` after each BN, ``module.`` prefixes, and the
    classifier's tensors trailing."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in hrnet_ocr_to_torch(params, stats, TINY).items():
        if not k.startswith("hrnet."):
            continue
        for old, new in _IMAGENET_NAMES:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        a = rng.normal(size=v.shape).astype(np.float32)
        out["module." + k] = np.abs(a) if k.endswith("running_var") else a
        if k.endswith("running_var"):
            out["module." + k.replace("running_var", "num_batches_tracked")] = np.array(7)
    out["module.classifier.weight"] = rng.normal(size=(1000, 2048)).astype(np.float32)
    out["module.classifier.bias"] = np.zeros(1000, np.float32)
    return out


def test_imagenet_init_matches_jax(jax_tiny):
    _, params, stats = jax_tiny
    ckpt = _imagenet_checkpoint(params, stats)
    port = _port(params, stats)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    ours = hrnet_imagenet_state_dict(port, {k: torch.from_numpy(np.asarray(v))
                                            for k, v in ckpt.items()})
    p_ref, s_ref = hrnet_imagenet_init(params, stats, ckpt, TINY)
    want = hrnet_state_dict_from_jax(_np(p_ref), _np(s_ref), TINY)
    assert set(want) <= set(ours)
    for k, v in want.items():
        torch.testing.assert_close(ours[k], v, rtol=0, atol=0, msg=k)
    backbone = [k for k in want if k.startswith("hrnet.")]
    assert all(not torch.equal(ours[k], before[k]) for k in backbone)
    assert all(torch.equal(ours[k], before[k]) for k in want if k.startswith("ocrnet."))
    port.load_state_dict(ours, strict=True)


def _broken(ckpt: dict, case: str) -> dict:
    items = list(ckpt.items())
    conv2 = [k for k, _ in items].index("module.conv2.weight")
    if case == "first_not_conv1":
        items = [items[conv2]] + items[:conv2] + items[conv2 + 1:]
    elif case == "truncated":
        items = items[:len(items) // 2]
    elif case == "shape":
        k, v = items[conv2]
        items[conv2] = (k, np.zeros((*v.shape[:-1], v.shape[-1] + 1), v.dtype))
    elif case == "suffix":  # bn1.weight and bn1.bias swap places (equal shapes)
        items[1], items[2] = items[2], items[1]
        assert items[1][0] == "module.bn1.bias"
    return dict(items)


@pytest.mark.parametrize("case,match", [("first_not_conv1", "expected 'conv1.weight'"),
                                        ("truncated", "truncated dump"),
                                        ("shape", "shape mismatch"),
                                        ("suffix", "suffix mismatch")])
def test_imagenet_init_refuses_what_jax_refuses(jax_tiny, case, match):
    _, params, stats = jax_tiny
    ckpt = _broken(_imagenet_checkpoint(params, stats), case)
    with pytest.raises(RuntimeError, match=match):
        hrnet_imagenet_init(params, stats, ckpt, TINY)
    with pytest.raises(RuntimeError, match=match):
        hrnet_imagenet_state_dict(_port(params, stats),
                                  {k: torch.from_numpy(np.asarray(v)) for k, v in ckpt.items()})


# ---------------------------------------------------------------------------
# the optimizer's groups
# ---------------------------------------------------------------------------

def test_param_groups_match_head_param_mask(jax_tiny):
    _, params, stats = jax_tiny
    labels = jax.tree_util.tree_leaves(head_param_mask(params))
    assert set(labels) == {"backbone"}  # no top-level 'head', nothing frozen
    port = _port(params, stats)
    groups = param_groups(port, head_mult=10.0)
    assert [len(g["params"]) for g in groups] == [len(labels), 0]
    assert groups[0]["lr_mult"] == 1.0
    names = {id(p): k for k, p in port.named_parameters()}
    grouped = {names[id(p)] for p in groups[0]["params"]}
    assert {"hrnet.bn1.weight", "hrnet.bn1.bias", "ocrnet.augmented_rep.1.weight",
            "ocrnet.segmentation_classes.0.bias"} <= grouped
    assert "ocrnet.pixel_representations.0.bias" not in grouped  # a buffer (BN-absorbed)
    opt = sgd_grouped(port, 1e-3, weight_decay=5e-4, head_mult=1.0)
    assert all(g["weight_decay"] == 5e-4 for g in opt.param_groups)


def test_archs_are_the_jax_packages():
    assert port_hrnet.ARCHS == {"w48": H.W48, "w32": JAX_W32}
