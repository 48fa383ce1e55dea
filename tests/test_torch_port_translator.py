"""The port's frozen translator (diga_tpu_torch.models.translator) against the JAX modules.

The JAX ``ImgEncoder``/``ImgDecoder`` are initialised from a seed at a
small width, their parameters cross over through the port's
``translator_state_dict_from_jax`` and load with ``strict=True``; the same
numpy image batch goes through both, in f32.  The JAX decoder runs both
its plain nearest-2x up-blocks and its subpixel rewrite of them, the same
function.  Tolerance 1e-4 of the output's largest magnitude (f32 convs
and instance-norm reductions in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.models.translator import ImgDecoder as JaxDecoder
from diga_tpu.models.translator import ImgEncoder as JaxEncoder
from diga_tpu_torch.models.convert import translator_state_dict_from_jax
from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder, translate

ENC = dict(dim=8, n_downsample=2, n_res=2)
DEC = dict(dim=32, n_upsample=2, n_res=2)
HW = (32, 48)


@pytest.fixture(scope="module")
def jax_translator():
    x = jnp.zeros((1, *HW, 3), jnp.float32)
    enc = JaxEncoder(**ENC)
    enc_p = enc.init(jax.random.PRNGKey(0), x)["params"]
    z = enc.apply({"params": enc_p}, x)
    dec_p = JaxDecoder(**DEC).init(jax.random.PRNGKey(1), z)["params"]
    return enc, enc_p, dec_p


def _port(enc_p, dec_p):
    sds = translator_state_dict_from_jax({"enc_s": enc_p, "dec_s2t": dec_p})
    enc = ImgEncoder(dim=ENC["dim"], n_downsample=ENC["n_downsample"], n_res=ENC["n_res"])
    dec = ImgDecoder(dim=DEC["dim"], n_upsample=DEC["n_upsample"], n_res=DEC["n_res"])
    enc.load_state_dict(sds["enc_s"], strict=True)
    dec.load_state_dict(sds["dec_s2t"], strict=True)
    return torch.nn.ModuleDict({"enc_s": enc, "dec_s2t": dec})


def _image(seed):
    return np.random.default_rng(seed).normal(size=(2, *HW, 3)).astype(np.float32)


def test_encoder_matches_jax(jax_translator):
    enc, enc_p, dec_p = jax_translator
    x = _image(0)
    ref = np.asarray(enc.apply({"params": enc_p}, jnp.asarray(x)))
    frozen = _port(enc_p, dec_p)
    with torch.no_grad():
        ours = frozen["enc_s"](torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("subpixel_up", [False, True])
def test_encoder_decoder_match_jax(jax_translator, subpixel_up):
    enc, enc_p, dec_p = jax_translator
    x = _image(1)
    z = enc.apply({"params": enc_p}, jnp.asarray(x))
    ref = np.asarray(JaxDecoder(**DEC, subpixel_up=subpixel_up).apply({"params": dec_p}, z))
    with torch.no_grad():
        ours = translate(_port(enc_p, dec_p), torch.from_numpy(x))
    assert ours.shape == ref.shape == (2, *HW, 3)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_state_dicts_have_the_reference_keys(jax_translator):
    _, enc_p, dec_p = jax_translator
    sds = translator_state_dict_from_jax({"enc_s": enc_p, "dec_s2t": dec_p})
    assert "model.0.conv.weight" in sds["enc_s"]
    assert "model.3.model.1.model.0.conv.bias" in sds["enc_s"]
    assert "model.0.model.0.model.1.conv.weight" in sds["dec_s2t"]
    assert {"model.2.conv.weight", "model.4.conv.weight", "model.5.conv.weight"} <= set(sds["dec_s2t"])
    # the full-size modules take the same key sets as the reference files
    full = ImgEncoder().state_dict().keys() | ImgDecoder().state_dict().keys()
    assert "model.3.model.3.model.1.conv.weight" in full and "model.5.conv.bias" in full
