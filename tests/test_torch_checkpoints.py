"""Release checkpoints in the PyTorch port: the `.npz` files that the JAX
package's export_release writes (float16 weights, 0x1f-joined keys, enc_q
dropped) load into ttts_tpu_torch through infer_utils.load_model and
TextToSpeech.from_checkpoints, and the codec reconstructs from one as the
JAX package does from the same file; eval_codec runs end to end on the CPU.

Weights are seeded fills of each JAX TINY model's variable shapes
(test_torch_codec_synth.random_codec_variables); nothing is downloaded."""

import functools
import wave

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY
from test_torch_codec_synth import (HOP, SPEC_CH, TOL, _codec_inputs, _fill, _jax_with_noise,
                                    random_codec_variables, rel)
from test_torch_config import to_port
from ttts_tpu import infer_utils as jinfer
from ttts_tpu.train.checkpoints import export_release
from ttts_tpu_torch import infer_utils, porting
from ttts_tpu_torch.api import TextToSpeech
from ttts_tpu_torch.eval_codec import main as eval_codec_main
from ttts_tpu_torch.models.vqvae import SynthesizerTrn

PORT_TINY = to_port(TINY)


@pytest.fixture(scope="module")
def codec_release(tmp_path_factory):
    """(JAX model, variables, path of their release export)."""
    model, variables = random_codec_variables(seed=3)
    path = tmp_path_factory.mktemp("release") / "codec.npz"
    export_release(variables, path, drop_prefixes=("enc_q",), config={"version": 2})
    return model, variables, path


def test_codec_release_reconstructs_as_jax(codec_release, monkeypatch):
    """export_release → JAX load_model → infer equals export_release → the
    port's load_model → infer, with JAX's z_p noise injected."""
    _, _, path = codec_release
    jmodel, jvars = jinfer.load_model("vqvae", str(path), TINY)
    model, sd = infer_utils.load_model("vqvae", path, PORT_TINY)
    assert isinstance(model, SynthesizerTrn) and not model.training
    assert set(sd) == set(model.state_dict())
    wav, spec, lengths, text, tl = _codec_inputs(seed=11)
    want, draws = _jax_with_noise(monkeypatch, lambda: jmodel.apply(
        jvars, wav, spec, lengths, text, tl, 0.5, method=jmodel.infer,
        rngs={"noise": jax.random.key(5)}))
    with torch.no_grad():
        got = model.infer(*map(torch.from_numpy, (wav, spec, lengths, text, tl)), 0.5,
                          noise=torch.from_numpy(np.array(draws[0])))
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    assert rel(got, want) < TOL


def _jax_stage_variables(name: str, seed: int):
    """Seeded variables of a JAX TINY model of the registry (gpt,
    diffusion, vocos, clvp), from its init's shapes."""
    model = jinfer.build_model(name, TINY)
    key, c = jax.random.key(0), TINY
    text, codes = jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 16), jnp.int32)
    mel = jnp.zeros((1, 32, c.diffusion_net.in_channels))
    args = {"gpt": (text, jnp.asarray([8]), codes, jnp.asarray([16 * 1024])),
            "diffusion": (mel, jnp.asarray([1.0]),
                          jnp.zeros((1, 16, c.diffusion_net.in_latent_channels)), mel),
            "vocos": (mel,), "clvp": (text, codes)}[name]
    shapes = jax.eval_shape(functools.partial(model.init, key), *args)
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(shapes)
    return flax.traverse_util.unflatten_dict(
        {k: np.asarray(_fill(k, v.shape, rng), np.float32) for k, v in flat.items()})


@pytest.mark.parametrize("name", ["gpt", "diffusion", "vocos", "clvp"])
def test_stage_release_loads(name, tmp_path):
    """Every other stage's release loads strictly into the port, equal to
    porting.STATE_DICT_FNS of the float16-rounded variables."""
    variables = _jax_stage_variables(name, seed=len(name))
    path = tmp_path / f"{name}.npz"
    export_release(variables, path, config={"version": 2})
    model, sd = infer_utils.load_model(name, path, PORT_TINY)
    rounded = jax.tree_util.tree_map(lambda a: a.astype(np.float16).astype(np.float32),
                                     variables)
    want = porting.STATE_DICT_FNS[infer_utils.STAGES[name]](rounded)
    assert set(sd) == set(want) == set(model.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, err_msg=k)


def test_from_checkpoints(codec_release, tmp_path):
    _, _, path = codec_release
    vocos = _jax_stage_variables("vocos", seed=1)
    vpath = tmp_path / "vocos.npz"
    export_release(vocos, vpath)
    tts = TextToSpeech.from_checkpoints(PORT_TINY, codec=path, vocos=vpath, device="cpu",
                                        seed=4)
    random = TextToSpeech(PORT_TINY, device="cpu", seed=4)
    for stage, want in (("codec", infer_utils.load_state_dict("vqvae", path)),
                        ("vocos", infer_utils.load_state_dict("vocos", vpath))):
        got = getattr(tts, stage).state_dict()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{stage}/{k}")
    for stage in ("gpt", "diffusion", "clvp"):  # left None: the seed's random weights
        for k, v in getattr(random, stage).state_dict().items():
            assert torch.equal(getattr(tts, stage).state_dict()[k], v), f"{stage}/{k}"


def test_orbax_directory_raises(tmp_path):
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        infer_utils.load_model("vqvae", tmp_path / "ckpt", PORT_TINY)
    with pytest.raises(ValueError, match="Orbax"):
        TextToSpeech.from_checkpoints(PORT_TINY, codec=tmp_path / "ckpt", device="cpu")


def _write_wav(path, data, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(data, -1, 1) * 32767).astype(np.int16).tobytes())


def test_eval_codec_main(codec_release, tmp_path):
    """python -m ttts_tpu_torch.eval_codec on the CPU: a seeded 16 kHz wav
    of 8 codec hops (resampled to 32 kHz), the TINY config from a JSON
    file; the written wav is infer's output as PCM16."""
    import dataclasses
    import json

    from ttts_tpu_torch.data.audio import load_wav
    from ttts_tpu_torch.ops.mel import vits_spectrogram

    _, _, path = codec_release
    sr = TINY.audio.sampling_rate
    rng = np.random.default_rng(8)
    src = tmp_path / "in.wav"
    _write_wav(src, 0.2 * rng.standard_normal(8 * HOP // 2), sr // 2)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dataclasses.asdict(TINY)))
    out = tmp_path / "gen.wav"
    eval_codec_main(["--ckpt", str(path), "--wav", str(src), "--out", str(out),
                     "--config", str(cfg), "--device", "cpu"])
    got, got_sr = load_wav(out)
    assert got_sr == sr and got.shape == (8 * HOP,)

    model, _ = infer_utils.load_model("vqvae", path, PORT_TINY)
    wav = torch.from_numpy(load_wav(src, target_sr=sr)[0])[None]
    a = TINY.audio
    spec = vits_spectrogram(wav, a.filter_length, a.hop_length, a.win_length).transpose(1, 2)
    assert spec.shape == (1, 8, SPEC_CH)
    with torch.no_grad():
        want = model.infer(wav[..., None], spec, torch.tensor([8]), torch.zeros((1, 1), dtype=torch.long),
                           torch.tensor([1]), 0.5, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got, np.clip(want[0, :, 0].numpy(), -1, 1), atol=1.5 / 32767)
