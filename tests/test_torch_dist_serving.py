"""TextToSpeech(mesh=...) of the port on gloo worlds of 2 CPU processes at
TINY widths, the same weights and the same injected draws (JAX's draws for
seed 3, tests/test_torch_slice.JaxDraws) as the single-process call:

- data parallel (data=2): tts_batch of 4 streams at preset "fast" (16
  decode rows, the CLVP rerank and 4 tail rows sharded) gives every
  candidate's codes and the winners of the single-process call, and its
  waveforms within 1e-6 (rows computed in smaller batches); and within the
  repo's 1e-3 contract of JAX's mesh tts_batch (tests/test_api_batch.py:
  28-55) on a 2-device data mesh of the virtual CPU mesh; 3 streams (12
  decode rows sharded, the 3 tail rows run whole on every rank) likewise;
- tensor parallel (model=2): the decode over each rank's 2 of 4 heads is
  token-identical to the single-process decode (preset "ultra_fast");
- sequence parallel (sp=2): the trunk's ring attention leaves the
  waveforms within 1e-4 (preset "ultra_fast");
- every rank returns the same waveforms, and `replicate` makes ranks
  built from different seeds hold rank 0's weights.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from test_torch_parallel import run_world, torch_threads, worker_main  # noqa: F401

TEXTS = ["ni3 hao3", "shi4 jie4 hao3", "jin1 tian1", "tian1 qi4 hao3"]
MAX_GEN = 32
STAGES = ("codec", "gpt", "diffusion", "vocos", "clvp")


class FixedDraws:
    """The draws of one call, computed beforehand (the Draws interface)."""

    def __init__(self, gumbel: np.ndarray, normal: np.ndarray):
        self.g, self.n = torch.from_numpy(gumbel), torch.from_numpy(normal)

    def gumbel(self, shape):
        assert tuple(shape) == tuple(self.g.shape), (shape, self.g.shape)
        return self.g

    def normal(self, shape):
        assert tuple(shape) == tuple(self.n.shape), (shape, self.n.shape)
        return self.n


# the calls of the test: (texts, preset)
CASES = {"four": (TEXTS, "fast"), "three": (TEXTS[:3], "fast"),
         "four_uf": (TEXTS, "ultra_fast")}
K = {"fast": 4, "ultra_fast": 1}


def _call(tts, case, draws):
    texts, preset = CASES[case]
    wavs = tts.tts_batch(texts, _voice(), 44100, preset=preset, max_generate_length=MAX_GEN,
                         draws=FixedDraws(*draws[case]))
    return {"wavs": wavs, "codes": tts.last_codes, "best": tts.last_best,
            "lens": tts.last_code_lens}


def _voice():
    rng = np.random.default_rng(0)
    t = np.arange(44100) / 44100
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(t.size)
            ).astype(np.float32)


def _serve(tmp, rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    from ttts_tpu_torch.api import TextToSpeech
    from ttts_tpu_torch.config import MeshConfig
    from ttts_tpu_torch.parallel import make_mesh

    cfg = torch.load(tmp / "cfg.pt", weights_only=False)
    weights = torch.load(tmp / "weights.pt")
    draws = {k: tuple(np.load(tmp / f"draws_{k}.npz")[n] for n in ("gumbel", "normal"))
             for k in CASES}
    meshes = {"dp": make_mesh(MeshConfig(data=2, model=1)),
              "tp": make_mesh(MeshConfig(data=1, model=2)),
              "sp": init_device_mesh("cpu", (2,), mesh_dim_names=("sp",))}
    out = {}
    for name, mesh in meshes.items():
        # seeds differ per rank: replicate gives every rank rank 0's weights
        tts = TextToSpeech(cfg, device="cpu", seed=10 + rank, mesh=mesh)
        out[f"{name}_replicated"] = float(sum(p.double().sum() for p in tts.gpt.parameters()))
        for stage in STAGES:
            tts.set_params(stage, weights[stage])
        if name == "dp":
            out["dp"] = _call(tts, "four", draws)
            out["dp3"] = _call(tts, "three", draws)
        else:
            out[name] = _call(tts, "four_uf", draws)
    return out


SCENARIOS = {"serve": _serve}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(each rank's outputs, the single-process port's, JAX's mesh
    tts_batch's waveforms)."""
    import jax

    from test_api import TINY as JTINY
    from test_torch_config import to_port
    from test_torch_slice import JaxDraws
    from ttts_tpu.api import TextToSpeech as JaxTTS
    from ttts_tpu.config import MeshConfig as JMeshConfig
    from ttts_tpu.models.quantize import rvq_state_from_dict
    from ttts_tpu.parallel import make_mesh as jmake_mesh
    from ttts_tpu_torch import porting
    from ttts_tpu_torch.api import TextToSpeech

    tmp = tmp_path_factory.mktemp("serve")
    cfg = to_port(JTINY)
    tts = TextToSpeech(cfg, device="cpu", seed=1)
    jtts = JaxTTS(JTINY, seed=0, init_stages=("vocos",))
    for stage, name in (("codec", "vqvae"), ("gpt", "gpt"), ("diffusion", "diffusion"),
                        ("clvp", "clvp")):
        sd = {k: v.numpy() for k, v in tts._modules()[stage].state_dict().items()}
        jtts.set_params(stage, rvq_state_from_dict(porting.VARIABLES_FNS[name](sd)))
    tts.set_params("vocos", porting.STATE_DICT_FNS["vocos"](jtts.params["vocos"]))
    torch.save(cfg, tmp / "cfg.pt")
    torch.save({s: {k: v.clone() for k, v in m.state_dict().items()}
                for s, m in tts._modules().items()}, tmp / "weights.pt")
    single, draws = {}, {}
    for case, (texts, preset) in CASES.items():
        jd = JaxDraws(3)
        n = len(texts)
        draws[case] = (jd.gumbel((MAX_GEN, K[preset] * n, cfg.gpt.number_mel_codes)).numpy(),
                       jd.normal((n, 4 * MAX_GEN, cfg.diffusion_net.in_channels)).numpy())
        np.savez(tmp / f"draws_{case}.npz", gumbel=draws[case][0], normal=draws[case][1])
        single[case] = _call(tts, case, draws)
    outs = run_world(pathlib.Path(__file__), "serve", 2, tmp, timeout=120)
    mesh = jmake_mesh(JMeshConfig(data=2, model=1), devices=jax.devices()[:2])
    jm = JaxTTS(JTINY, params=jtts.params, mesh=mesh)
    jax_wavs = jm.tts_batch(TEXTS, _voice(), 44100, preset="fast", max_generate_length=MAX_GEN,
                            seed=3)
    return outs, single, jax_wavs


def _same_draw(got, want):
    np.testing.assert_array_equal(got["codes"], want["codes"])
    assert got["best"] == want["best"] and got["lens"] == want["lens"]


@pytest.mark.parametrize("case", ["four", "three"])
def test_data_parallel_matches_single_process(served, case):
    outs, single, _ = served
    want = single[case]
    for o in outs:
        got = o["dp" if case == "four" else "dp3"]
        _same_draw(got, want)
        assert len(got["wavs"]) == len(want["wavs"])
        for g, w in zip(got["wavs"], want["wavs"]):
            assert g.shape == w.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def test_data_parallel_matches_jax_mesh(served):
    outs, single, jax_wavs = served
    assert len(jax_wavs) == len(TEXTS)
    for g, w in zip(outs[0]["dp"]["wavs"], jax_wavs):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_tensor_parallel_decode_is_token_identical(served):
    outs, single, _ = served
    for o in outs:
        _same_draw(o["tp"], single["four_uf"])
        for g, w in zip(o["tp"]["wavs"], single["four_uf"]["wavs"]):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_sequence_parallel_serving(served):
    outs, single, _ = served
    for o in outs:
        _same_draw(o["sp"], single["four_uf"])
        for g, w in zip(o["sp"]["wavs"], single["four_uf"]["wavs"]):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["dp", "tp", "sp"])
def test_ranks_agree_and_replicate(served, name):
    outs, _, _ = served
    assert outs[0][f"{name}_replicated"] == outs[1][f"{name}_replicated"]
    for a, b in zip(outs[0][name]["wavs"], outs[1][name]["wavs"]):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    worker_main(SCENARIOS)
