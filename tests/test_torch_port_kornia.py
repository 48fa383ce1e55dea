"""The port's kornia photometric chain against ``diga_tpu``'s, on the CPU.

``diga_tpu.ops.photometric.kornia_photometric_chain`` draws from a JAX key
(``keys = split(rng, 12)``, ``photometric.py:201``); the port's chain takes
its draws as an argument, so each test derives them from the same key the
way JAX splits it (``_torch_port_steps.jax_kornia_draws``) and injects
them.  Keys are picked from a seeded scan so that every one of the 24
jitter orders, and
every gate both on and off for the whole batch, is run.  Inputs span the
normalized range the reference feeds kornia, about [-2, 1.2], with gray
pixels (HSV's zero-range branch) and exact 0 and 1.  Tolerance: f32 atol
1e-5 (and rtol 1e-5), the tolerance of the ``diga`` chain's tests.

Also: ``draw_kornia`` itself (ranges, shapes, one permutation), and 5
warm-up steps with ``photometric='kornia'``, beta 0.4, against the jitted
JAX step with the step's own draws injected (ROADMAP A2).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.ops import photometric as jax_photo
from diga_tpu_torch.ops import photometric as P

import _torch_port_steps as steps

ATOL = RTOL = 1e-5
B = 2
N_SCAN = 4000  # keys scanned for orders and gate patterns
GATES = {"jitter": (5, None), "gray": (6, 0.3), "blur": (7, 0.8), "sharp": (8, 0.3)}


def _images(b, seed, h=9, w=13):
    """NHWC in [-2, 1.2], a gray row (equal channels) and pixels of exact 0 and 1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 1.2, size=(b, h, w, 3)).astype(np.float32)
    x[:, 0, :3] = 0.0
    x[:, -1, :3] = 1.0
    x[:, h // 2] = x[:, h // 2, :, :1]
    return x


@pytest.fixture(scope="module")
def scan():
    """The uniforms behind each of the first N_SCAN keys' order and gates."""
    keys = jax.vmap(lambda s: jax.random.split(jax.random.PRNGKey(s), 12))(jnp.arange(N_SCAN))
    orders = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 4))(keys[:, 0]))
    gate_u = {g: np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (B, 1, 1, 1)))(
        keys[:, i])).reshape(N_SCAN, B) for g, (i, _) in GATES.items()}
    return orders, gate_u


_jax_chain = jax.jit(jax_photo.kornia_photometric_chain,
                     static_argnames=("p_jitter", "with_sharpness"))


def _check(seed, x, p_jitter=0.5, with_sharpness=True):
    key = jax.random.PRNGKey(seed)
    draws = steps.jax_kornia_draws(key, x.shape[0], p_jitter)
    ours = P.kornia_photometric_chain(torch.from_numpy(x), draws, with_sharpness=with_sharpness)
    ref = _jax_chain(jnp.asarray(x), key, p_jitter=p_jitter, with_sharpness=with_sharpness)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    return draws


@pytest.mark.parametrize("order", list(itertools.permutations(range(4))),
                         ids=lambda o: "".join(map(str, o)))
def test_every_jitter_order_matches_jax(scan, order):
    orders, _ = scan
    seed = int(np.flatnonzero((orders == order).all(axis=1))[0])
    draws = _check(seed, _images(B, seed), p_jitter=1.0)  # every image jittered
    assert tuple(draws["order"].tolist()) == order and bool(draws["jitter"].all())


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("gate", list(GATES))
def test_each_gate_on_and_off_matches_jax(scan, gate, on):
    _, gate_u = scan
    p = GATES[gate][1] or 0.5
    hit = (gate_u[gate] < p).all(axis=1) if on else (gate_u[gate] >= p).all(axis=1)
    seed = int(np.flatnonzero(hit)[0])
    draws = _check(seed, _images(B, 50 + seed))
    assert bool((draws[gate] == on).all())


@pytest.mark.parametrize("with_sharpness", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diga_photometric_kornia_variant_matches_jax(seed, with_sharpness):
    b = 6
    x = _images(b, 100 + seed, h=12, w=17)
    key = jax.random.PRNGKey(seed)
    draws = steps.jax_kornia_draws(key, b, p_jitter=0.7)
    ours = P.diga_photometric(torch.from_numpy(x), draws, 0.4, variant="kornia",
                              with_sharpness=with_sharpness)
    ref = jax_photo.diga_photometric(jnp.asarray(x), key, 0.4, "kornia", p_jitter=0.7,
                                     with_sharpness=with_sharpness)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_sharpness_keeps_the_border_and_a_tiny_image():
    """Only interior pixels blend; an image of 2 rows has no interior."""
    draws = P.draw_kornia(torch.Generator().manual_seed(3), 2)
    for k in ("jitter", "gray", "blur"):
        draws[k] = torch.zeros(2, dtype=torch.bool)
    draws["sharp"] = torch.ones(2, dtype=torch.bool)
    draws["sharp_factor"] = torch.full((2,), 0.5)
    for h in (2, 7):
        x = torch.from_numpy(_images(2, 7, h=h, w=9))
        y = P.kornia_photometric_chain(x, draws)
        border = torch.ones(h, 9, dtype=torch.bool)
        border[1:-1, 1:-1] = False
        assert torch.equal(y[:, border], x[:, border])
        assert h == 2 or not torch.equal(y, x)


def test_draw_kornia_ranges_and_determinism():
    a = P.draw_kornia(torch.Generator().manual_seed(5), 64, p_jitter=0.7)
    b = P.draw_kornia(torch.Generator().manual_seed(5), 64, p_jitter=0.7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(a["order"].tolist()) == [0, 1, 2, 3]
    for k, (lo, hi) in {"brightness": (-0.4, 0.4), "contrast": (0.6, 1.4),
                        "saturation": (0.8, 1.2), "hue": (-0.1, 0.1),
                        "sharp_factor": (0.0, 0.5)}.items():
        assert a[k].shape == (64,) and a[k].dtype == torch.float32
        assert bool((a[k] >= lo).all() and (a[k] <= hi).all()), k
    for k in ("jitter", "gray", "blur", "sharp"):
        assert a[k].dtype == torch.bool and a[k].shape == (64,)


# ---------------------------------------------------------------------------
# 5 warm-up steps with the kornia chain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kornia_trajectories():
    return steps.run_steps("warmup", K=19, beta=0.4, photometric="kornia")


@pytest.mark.parametrize("what", steps.WHAT)
def test_kornia_warmup_step_matches_jax_every_step(kornia_trajectories, what):
    steps.check(kornia_trajectories, what)
