"""The port's DeepLabV2 (diga_tpu_torch) against the JAX DeepLabV2.

A JAX ``DeepLabV2(layers=(1, 1, 1, 1), s2b=False)`` init, with BN
statistics and norm affines moved away from their init values, crosses
to the port through ``state_dict_from_jax`` and through the JAX package's
``segmodel_to_torch``; both load with ``strict=True``.  The eval forward
on a 1x33x65x3 image (odd grids: the ceil-mode pool and the stride-2
1x1 convs) matches all four JAX outputs in f32 at atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diga_tpu.models.convert import segmodel_to_torch
from diga_tpu_torch.models.convert import state_dict_from_jax
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2

from _torch_port_common import LAYERS, jax_tiny_deeplab


@pytest.fixture(scope="module")
def tiny():
    return jax_tiny_deeplab(seed=5)


def test_state_dict_from_jax_loads_strict(tiny):
    _, params, stats = tiny
    sd = state_dict_from_jax(params, stats, LAYERS)
    model = DeepLabV2(num_classes=19, layers=LAYERS)
    model.load_state_dict(sd, strict=True)
    # the reference key set, exactly as the JAX package exports it
    assert set(sd) == set(segmodel_to_torch(params, stats, LAYERS))


def test_segmodel_to_torch_loads_strict(tiny):
    _, params, stats = tiny
    ref = segmodel_to_torch(params, stats, LAYERS)
    model = DeepLabV2(num_classes=19, layers=LAYERS)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ref.items()}, strict=True)
    ours = state_dict_from_jax(params, stats, LAYERS)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_eval_forward_matches_jax(tiny):
    jmodel, params, stats = tiny
    x = np.random.default_rng(6).normal(size=(1, 33, 65, 3)).astype(np.float32)
    jouts = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)

    model = DeepLabV2(num_classes=19, layers=LAYERS)
    model.load_state_dict(state_dict_from_jax(params, stats, LAYERS), strict=True)
    model.eval()
    with torch.inference_mode():
        touts = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, j, t in zip(("shallow", "deep", "logits", "feat"), jouts, touts):
        assert t.is_contiguous(memory_format=torch.channels_last), name
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                   atol=1e-4, rtol=0, err_msg=name)
