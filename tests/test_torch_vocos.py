"""PyTorch port parity: Vocos (ConvNeXt backbone + ISTFT head) against
ttts_tpu on the CPU, in f32. Waveform within 1e-3 (the head exponentiates
log-magnitudes, which scales f32 rounding up)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY
from test_torch_config import to_port
from ttts_tpu.config import VocosConfig
from ttts_tpu.models import vocos as jvocos
from ttts_tpu_torch import porting
from ttts_tpu_torch.models.vocos import Vocos

CFGS = {"tiny": TINY.vocos, "wide": VocosConfig(dim=64, intermediate_dim=192, num_layers=2)}


@pytest.fixture(scope="module", params=sorted(CFGS))
def vocos(request):
    cfg = CFGS[request.param]
    model = jvocos.Vocos(cfg)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 16, cfg.input_channels)))
    port = Vocos(to_port(cfg)).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          porting.vocos_state_dict(variables).items()})
    return model, variables, port


def test_waveform(vocos):
    model, variables, port = vocos
    mel = (np.random.default_rng(0).standard_normal((2, 24, 100)) * 2 - 4).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 23 * 256)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_converter_round_trip(vocos):
    _, variables, port = vocos
    sd = porting.vocos_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    back = jvocos.port_torch_state_dict(variables, sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, back),
                           jax.tree_util.tree_map(np.asarray, variables))
