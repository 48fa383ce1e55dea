"""Shared helpers of the tests/test_torch_port_*.py files."""

import numpy as np

import jax
import jax.numpy as jnp

from diga_tpu.models.resnet_deeplab import DeepLabV2 as JaxDeepLabV2

LAYERS = (1, 1, 1, 1)


def jax_tiny_deeplab(seed: int, hw=(33, 65), num_classes: int = 19):
    """A JAX DeepLabV2 at tiny depth, eval layout (``s2b=False``), and its
    (params, batch_stats) as numpy trees with every 1-D leaf (BN/GN affine,
    BN statistics) moved away from its init value, variances kept positive."""
    model = JaxDeepLabV2(num_classes=num_classes, layers=LAYERS, s2b=False)
    k = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    variables = model.init({"params": k, "dropout": k},
                           jnp.zeros((1, *hw, 3)), train=False)

    def perturb(a, positive):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        a = a + rng.normal(size=a.shape).astype(np.float32) * 0.1
        return np.abs(a) if positive else a

    params = jax.tree_util.tree_map(lambda a: perturb(a, False), variables["params"])
    stats = jax.tree_util.tree_map(lambda a: perturb(a, True), variables["batch_stats"])
    return model, params, stats
