"""PyTorch port parity: the audio quality classifier
(AudioMiniEncoderWithClassifierHead) against ttts_tpu's on the CPU, in f32:
logits and the label loss, with and without distribute_zero_label, at mel
lengths where flax's "SAME" padding of the stride-4 convolutions is
asymmetric and where it is zero; infer_utils.build_model / load_model of an
export_release `.npz`.

Weights: seeded fills of the JAX model's variable shapes (the reference
zero-initialises each ResBlock's last conv and every attention projection,
which would hide them). Contract: logits within 1e-3 relative (L2), the
loss within 1e-3 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec_synth import rel, seeded_variables
from ttts_tpu.config import ClassifierConfig
from ttts_tpu.models.classifier import AudioMiniEncoderWithClassifierHead as JaxClassifier
from ttts_tpu.train.checkpoints import export_release
from ttts_tpu_torch import infer_utils, porting
from ttts_tpu_torch.config import TTTSConfig
from ttts_tpu_torch.models.blocks import same_pad
from ttts_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead

TOL = 1e-3
CFG = ClassifierConfig(classes=3, spec_dim=16, embedding_dim=32, depth=2, resnet_blocks=1,
                       attn_blocks=2, num_attn_heads=2, base_channels=16, kernel_size=5)


def _port_cfg(cfg):
    from ttts_tpu_torch.config import ClassifierConfig as PortCfg

    return PortCfg(**dataclasses.asdict(cfg))


def _variables(cfg, seed=0):
    model = JaxClassifier(cfg)
    return model, seeded_variables(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 40, cfg.spec_dim))), seed)


@pytest.fixture(scope="module")
def pair():
    model, variables = _variables(CFG)
    port = AudioMiniEncoderWithClassifierHead(_port_cfg(CFG)).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          porting.classifier_state_dict(variables).items()})
    return model, variables, port


def _pads(t):
    pads = []
    for _ in range(CFG.depth):
        pads.append(same_pad(t, 3, CFG.downsample_factor))
        t = -(-t // CFG.downsample_factor)
    return pads


# T=42: the first stride-4 conv pads (0, 1); T=44: no pad at either
@pytest.mark.parametrize("t,pads", [(42, [(0, 1), (0, 0)]), (44, [(0, 0), (0, 0)])])
def test_logits_and_loss(pair, t, pads):
    model, variables, port = pair
    assert _pads(t) == pads
    mel = np.random.default_rng(t).standard_normal((4, t, CFG.spec_dim)).astype(np.float32)
    labels = np.asarray([0, 1, 2, 0])
    want = np.asarray(model.apply(variables, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
        loss = port(torch.from_numpy(mel), torch.from_numpy(labels))
    assert got.shape == (4, CFG.classes) and rel(got, want) < TOL
    want_loss = model.apply(variables, jnp.asarray(mel), jnp.asarray(labels))
    assert abs(float(loss) - float(want_loss)) < TOL * abs(float(want_loss))


def test_distributed_zero_label_loss(pair):
    """Label 0 softened by 20% spread over the other classes."""
    model, variables, port = pair
    cfg = dataclasses.replace(CFG, distribute_zero_label=True)
    mel = np.random.default_rng(7).standard_normal((4, 40, CFG.spec_dim)).astype(np.float32)
    labels = np.asarray([0, 1, 0, 2])
    want = float(JaxClassifier(cfg).apply(variables, jnp.asarray(mel), jnp.asarray(labels)))
    hard = float(model.apply(variables, jnp.asarray(mel), jnp.asarray(labels)))
    port.cfg = _port_cfg(cfg)
    try:
        with torch.no_grad():
            got = float(port(torch.from_numpy(mel), torch.from_numpy(labels)))
    finally:
        port.cfg = _port_cfg(CFG)
    assert abs(got - want) < TOL * abs(want) and abs(want - hard) > 10 * TOL * abs(want)


def test_converter_values_round_trip(pair):
    """Every JAX value lands in the state dict once (sorted values equal),
    under the port's keys exactly."""
    _, variables, port = pair
    sd = porting.classifier_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    flat = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(variables)])
    np.testing.assert_array_equal(np.sort(np.concatenate([v.ravel() for v in sd.values()])),
                                  np.sort(flat))


def test_build_and_load_release(pair, tmp_path):
    """build_model("classifier") and load_model of an export_release .npz
    (float16 weights): the loaded logits equal the port's on the float16-
    rounded weights."""
    model, variables, _ = pair
    cfg = TTTSConfig(classifier=_port_cfg(CFG))
    built = infer_utils.build_model("classifier", cfg)
    assert isinstance(built, AudioMiniEncoderWithClassifierHead) and not built.training
    path = tmp_path / "classifier.npz"
    export_release(variables, path, config={"version": 2})
    loaded, sd = infer_utils.load_model("classifier", path, cfg)
    rounded = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16).astype(np.float32),
                                     variables)
    for k, v in porting.classifier_state_dict(rounded).items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    mel = np.random.default_rng(1).standard_normal((2, 40, CFG.spec_dim)).astype(np.float32)
    want = np.asarray(model.apply(rounded, jnp.asarray(mel)))
    with torch.no_grad():
        assert rel(loaded(torch.from_numpy(mel)), want) < TOL
