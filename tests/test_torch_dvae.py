"""PyTorch port parity of the discrete VAE (ttts_tpu_torch.models.dvae
against ttts_tpu.models.dvae) on the CPU, in f32, at tests/test_dvae.py's
sizes (32 codes of 16, 8 mel bins, 2 stride-2 layers of 8 and 16):

- get_codebook_indices: codes bit-identical; decode_codes and the eval
  forward within TOL;
- the training forward from a pending codebook (k-means init, then the
  search and the EMA / expiry update) on 80 frames (40 rows for 32
  codes), JAX's k-means and expiry rows injected from the key its
  rvq_forward receives: recon and commit losses and the output within TOL,
  the codebook state within STATE_TOL;
- with a ResBlock on each side (the reference's other layout), the same
  forward parity and the converters' round trip;
- JAX's test_training_reduces_recon: a few steps of the port's AdamW lower
  recon + commit.

Weights: seeded fills of JAX's variable shapes, a seeded inited codebook.
TOL 1e-5 relative (L2): the largest of three readings (seed offsets 0-2)
was 2.1e-7; STATE_TOL 1e-5, absolute and relative, as the codec's
training test holds its codebook."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec_synth import rel, seeded_variables
from test_torch_quantize_train import jax_vq_draws
from test_torch_vqvae_train import RvqKeys
from ttts_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from ttts_tpu.models.quantize import RVQState
from ttts_tpu_torch import porting
from ttts_tpu_torch.models.dvae import DiscreteVAE
from ttts_tpu_torch.models.quantize import rvq_init
from ttts_tpu_torch.train.state import AdamW

KW = dict(num_tokens=32, codebook_dim=16, channels=8, out_channels=8, hidden_dim=8,
          num_layers=2)
TOL, STATE_TOL = 1e-5, 1e-5


def _mel(t, seed=0):
    return np.random.default_rng(seed).standard_normal((2, t, 8)).astype(np.float32)


def _variables(model, seed=0, inited=True):
    params = seeded_variables(lambda: model.init(
        {"params": jax.random.key(0), "vq": jax.random.key(1)}, _mel(32), train=True)["params"],
        seed=seed)
    shape = (1, KW["num_tokens"], KW["codebook_dim"])
    if inited:
        emb = jnp.asarray(np.random.default_rng(seed + 9).standard_normal(shape), jnp.float32)
        state = RVQState(embed=emb, embed_avg=emb, cluster_size=jnp.ones(shape[:2]),
                         inited=jnp.asarray(True))
    else:
        z = jnp.zeros(shape)
        state = RVQState(embed=z, embed_avg=z, cluster_size=jnp.zeros(shape[:2]),
                         inited=jnp.asarray(False))
    return {"params": params, "codebook": {"quantizer": {"state": state}}}


def _port(variables, **kw):
    port = DiscreteVAE(**{**KW, **kw})
    sd = porting.dvae_state_dict(variables)
    assert set(sd) == set(port.state_dict()), set(sd) ^ set(port.state_dict())
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port.eval()


@pytest.fixture(scope="module")
def dvae():
    model = JDiscreteVAE(**KW)
    variables = _variables(model)
    return model, variables, _port(variables)


def test_codes_and_decode(dvae):
    model, variables, port = dvae
    mel = _mel(32, seed=1)
    codes = np.asarray(model.apply(variables, mel, method=model.get_codebook_indices))
    with torch.no_grad():
        got = port.get_codebook_indices(torch.from_numpy(mel))
        rec = port.decode_codes(got)
    assert got.shape == (2, 8) and len(np.unique(codes)) > 2
    np.testing.assert_array_equal(got.numpy(), codes)
    want = model.apply(variables, codes, method=model.decode_codes)
    assert rec.shape == want.shape == (2, 32, 8) and rel(rec, want) <= TOL


def test_eval_forward(dvae):
    model, variables, port = dvae
    mel = _mel(32, seed=2)
    recon, commit, out = model.apply(variables, mel, train=False)
    with torch.no_grad():
        precon, pcommit, pout = port(torch.from_numpy(mel))
    assert rel(pout, out) <= TOL and abs(precon.item() - float(recon)) <= TOL * float(recon)
    assert pcommit.item() == float(commit) == 0.0


def _jax_train_step(model, variables, mel, monkeypatch):
    keys = RvqKeys(monkeypatch)
    (recon, commit, out), mut = jax.jit(lambda v, m: model.apply(
        v, m, train=True, rngs={"vq": jax.random.key(5)}, mutable=["codebook"]))(variables, mel)
    return (recon, commit, out), mut["codebook"]["quantizer"]["state"], keys.keys[0]


@pytest.mark.parametrize("resblocks", [0, 1])
def test_training_forward(resblocks, monkeypatch):
    kw = {"num_resnet_blocks": resblocks}
    model = JDiscreteVAE(**KW, **kw)
    variables = _variables(model, inited=False)
    port = _port(variables, **kw).train()
    mel = _mel(80, seed=3)
    (recon, commit, out), st, key = _jax_train_step(model, variables, mel, monkeypatch)
    draws = jax_vq_draws(key, 2 * 20, 1, KW["num_tokens"], "farthest_point")
    precon, pcommit, pout = port(torch.from_numpy(mel), train=True, vq_draws=draws)
    assert rel(pout.detach(), out) <= TOL
    for a, b in ((precon, recon), (pcommit, commit)):
        assert float(b) > 0 and abs(a.item() - float(b)) <= TOL * float(b)
    buf = port.quantizer.state()
    for k in ("embed", "embed_avg", "cluster_size"):
        np.testing.assert_allclose(getattr(buf, k).numpy(), np.asarray(getattr(st, k)),
                                   rtol=STATE_TOL, atol=STATE_TOL)
    back = porting.dvae_variables(port.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]),
                    jax.tree_util.tree_leaves(variables["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (jax.tree_util.tree_structure(back["params"])
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                                   variables["params"])))


def test_training_reduces_recon():
    """JAX's test_training_reduces_recon for the port: 20 steps of its AdamW
    (adam at 3e-3: no decay, no clip, no warmup) from a pending codebook."""
    torch.manual_seed(0)
    port = DiscreteVAE(**KW)
    port.quantizer.set_state(rvq_init(1, KW["num_tokens"], KW["codebook_dim"]))
    port.train()
    mel = torch.from_numpy(_mel(32))
    opt = AdamW(list(port.parameters()), 3e-3, warmup_steps=0, betas=(0.9, 0.999),
                weight_decay=0.0, grad_clip=None)
    g = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(21):
        recon, commit, _ = port(mel, train=True, generator=g)
        loss = recon + commit
        opt.update(torch.autograd.grad(loss, opt.params))
        losses.append(loss.item())
    assert losses[-1] < losses[0]
