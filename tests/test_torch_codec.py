"""PyTorch port parity: the codec extract path and the VQ nearest-neighbour
search (ttts_tpu_torch against ttts_tpu) on the CPU, in f32.

Contract: VQ codes bit-identical. The VQ plain version (what the CUDA
wrapper runs on a CPU tensor) must equal both the JAX oracle
vq_nearest_reference and the Pallas kernel in interpret mode."""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_api import TINY
from test_torch_config import to_port
from ttts_tpu.models import porting as jporting
from ttts_tpu.models.quantize import RVQState
from ttts_tpu.models.vqvae import SynthesizerTrn as JaxSynth
from ttts_tpu.ops.pallas import vq as vq_mod
from ttts_tpu_torch import porting
from ttts_tpu_torch.models.vqvae import SynthesizerTrn
from ttts_tpu_torch.ops.cuda.vq import vq_nearest, vq_nearest_plain

SPEC_CH = TINY.audio.filter_length // 2 + 1


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpreter mode on the CPU (tests/test_pallas_vq.py)."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    vq_mod.vq_nearest_pallas.clear_cache()
    yield
    vq_mod.vq_nearest_pallas.clear_cache()


# the codec's full width (500, 192, 1024), one row, and a bins that is no
# multiple of the card kernel's 128-code slice (1000)
@pytest.mark.parametrize("n,d,bins", [(100, 192, 1024), (37, 16, 32), (7, 32, 100),
                                      (500, 192, 1024), (1, 192, 1024), (500, 192, 1000)])
def test_vq_plain_matches_reference_and_pallas(interpret_mode, n, d, bins):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.standard_normal((bins, d)).astype(np.float32)
    cb[5] = cb[2]          # an exact tie: the lowest index must win
    x[0] = cb[2]
    got = vq_nearest(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    ref = np.asarray(vq_mod.vq_nearest_reference(jnp.asarray(x), jnp.asarray(cb)))
    pallas = np.asarray(vq_mod.vq_nearest_pallas(jnp.asarray(x), jnp.asarray(cb),
                                                 tile_n=64, tile_b=128))
    assert got.dtype == np.int32 and got[0] == 2
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(vq_nearest_plain(torch.from_numpy(x),
                                                   torch.from_numpy(cb)).numpy(), ref)


@pytest.fixture(scope="module")
def codec():
    """JAX TINY codec variables with a random (not all-zero) codebook, and
    the port built from them through ttts_tpu_torch.porting."""
    model = JaxSynth(TINY.vqvae, spec_channels=SPEC_CH, segment_frames=4)
    hop, frames = TINY.audio.hop_length, 8
    wav = jnp.zeros((1, frames * hop, 1))
    spec = jnp.zeros((1, frames, SPEC_CH))
    key = jax.random.key(0)
    rngs = {"params": key, "noise": key, "slice": key, "vq": key}
    variables = jax.jit(functools.partial(model.init, train=False))(
        rngs, wav, wav, spec, spec, jnp.asarray([frames]), jnp.zeros((1, 8), jnp.int32),
        jnp.asarray([8]))
    st = variables["codebook"]["quantizer"]["state"]
    embed = jax.random.normal(jax.random.key(7), st.embed.shape)
    variables = dict(variables)
    variables["codebook"] = {"quantizer": {"state": RVQState(
        embed=embed, embed_avg=embed, cluster_size=st.cluster_size,
        inited=jnp.asarray(True))}}
    port = SynthesizerTrn(to_port(TINY.vqvae), spec_channels=SPEC_CH).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          porting.synthesizer_trn_state_dict(variables).items()})
    return model, variables, port


def test_extract_code_bit_identical(codec):
    model, variables, port = codec
    rng = np.random.default_rng(0)
    frames = 24
    wav = (rng.standard_normal((2, frames * TINY.audio.hop_length, 1)) * 0.1).astype(np.float32)
    spec = np.abs(rng.standard_normal((2, frames, SPEC_CH))).astype(np.float32)
    lengths = np.asarray([frames, frames - 6])
    extract = jax.jit(functools.partial(model.apply, method=model.extract_code))
    want = np.asarray(extract(variables, jnp.asarray(wav), jnp.asarray(spec),
                              jnp.asarray(lengths)))
    with torch.no_grad():
        got = port.extract_code(torch.from_numpy(wav), torch.from_numpy(spec),
                                torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (2, 1, frames // 2)
    assert len(np.unique(want)) > 1  # the random codebook gives varied codes
    np.testing.assert_array_equal(got, want)


def test_converter_round_trip(codec):
    """porting.synthesizer_trn_state_dict inverts the JAX porter's helpers
    for every part the extract path builds."""
    _, variables, port = codec
    sd = porting.synthesizer_trn_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    p = variables["params"]
    back = {
        "ref_enc": jporting._mel_style_encoder(sd, "ref_enc"),
        "enc_p": jporting._posterior_audio_encoder(
            sd, "enc_p", n_down=len(TINY.vqvae.posterior_down_rates),
            n_rb=len(TINY.vqvae.posterior_rb_kernels),
            wn_layers=TINY.vqvae.posterior_wn_layers),
        "proj": jporting._conv(sd, "proj"),
    }
    flat = lambda t: {"/".join(k): v for k, v in  # noqa: E731
                      flax.traverse_util.flatten_dict(t).items()}
    for name, tree in back.items():
        want, got = flat(jax.tree_util.tree_map(np.asarray, p[name])), flat(tree)
        assert set(got) == set(want), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}/{k}")
    st = variables["codebook"]["quantizer"]["state"]
    np.testing.assert_array_equal(sd["quantizer.vq.layers.0._codebook.embed"],
                                  np.asarray(st.embed)[0])
