"""The port's parallel package (ttts_tpu_torch/parallel) on gloo worlds of
CPU processes, against the JAX package's on the 8-device virtual CPU mesh
(tests/conftest.py) at the same number of shards:

- make_mesh's shapes, axis names and errors equal ttts_tpu.parallel's for
  (data=-1, model=2) and (dcn=2, data=-1, model=2); on 4 ranks the mesh,
  data_axis_size, shard_batch / gather_batch and the coalesced all_reduce;
- infer_param_shardings shards the same leaves, on the same output
  dimension, as JAX's at model=2, min_size=4096 on the GPT of
  __graft_entry__._dryrun_gpt, and shard_params (DTensors on a 2-rank
  model mesh) leaves its loss within 1e-5 of the unsharded loss;
- ring_attention non-causal, causal and with the Toeplitz strip at sp = 2
  and 4 within 1e-5 (f32) of plain attention and of JAX's
  make_ring_attention at the same n;
- AA_diffusion with an sp group of 4 within 1e-4 of the dense port and of
  JAX's sequence-parallel trunk (tests/test_ring_attention.py:60-85).

The worlds are processes started by `run_world` (this file's __main__ is
the worker): each joins a gloo group through a file store with a 60 s
timeout, and the parent kills every rank when the world outlives its own
timeout and re-raises a failing rank's traceback. A worker imports torch
and the port only: JAX runs in the test bodies, in the parent.
"""

from __future__ import annotations

import datetime
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIFF_CFG = dict(in_channels=6, out_channels=12, model_channels=64, num_heads=4, num_layers=2,
                in_latent_channels=16, dropout=0.0)
GPT_CFG = dict(model_dim=128, layers=2, heads=4, max_text_tokens=32, max_mel_tokens=64,
               dropout=0.0)


# ------------------------------------------------------------------ harness


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """One torch thread in the test process while a module that imports
    this runs (the ranks set their own): the suite runs in several worker
    processes on the machine's cores, and torch's OpenMP threads of all of
    them contending made the single-process references many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_world(script: pathlib.Path, scenario: str, world: int, tmp: pathlib.Path,
              timeout: float = 90.0):
    """Run `python script scenario rank world tmp` for every rank; kill them
    all when `timeout` seconds pass; raise with the failing ranks' output.
    Returns each rank's saved result (tmp/out_<rank>.pt)."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp / f"log_{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), scenario, str(r), str(world),
                               str(tmp)], stdout=logs[r], stderr=subprocess.STDOUT, env=env,
                              cwd=str(ROOT))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        text = "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                         + (tmp / f"log_{r}.txt").read_text()[-4000:] for r in failed)
        raise RuntimeError(f"world {scenario} failed or timed out after {timeout} s:\n{text}")
    return [torch.load(tmp / f"out_{r}.pt", weights_only=False) for r in range(world)]


def worker_main(scenarios):
    """A worker's entry: join the gloo world of argv, run the scenario and
    save its result as out_<rank>.pt."""
    import torch.distributed as dist

    scenario, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        out = scenarios[scenario](pathlib.Path(tmp), rank, world)
        torch.save(out, pathlib.Path(tmp) / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def inputs(tmp: pathlib.Path):
    return dict(np.load(tmp / "inputs.npz"))


# ------------------------------------------------------------ worker scenarios


def _plain_attention(q, k, v, causal=False, strip=None):
    t, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if strip is not None:
        idx = torch.arange(t)[None, :] - torch.arange(t)[:, None] + t - 1
        s = s + strip[:, idx][None]
    if causal:
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _rings(tmp, rank, world):
    """ring_attention (local blocks) and make_ring_attention (full inputs)
    over an sp mesh of the whole world, in the three modes."""
    from torch.distributed.device_mesh import init_device_mesh

    from ttts_tpu_torch.parallel.ring_attention import make_ring_attention, ring_attention

    x = {k: torch.from_numpy(v) for k, v in inputs(tmp).items()}
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("sp",))
    group = mesh.get_group("sp")
    c = x["q"].shape[1] // world
    local = [x[n][:, rank * c:(rank + 1) * c] for n in "qkv"]
    out = {}
    for mode, kw in (("plain", {}), ("causal", {"causal": True}), ("strip", {})):
        strip = x["strip"] if mode == "strip" else None
        out[f"local_{mode}"] = ring_attention(*local, group, bias_strip=strip, **kw)
        ring = make_ring_attention(mesh, "sp", with_bias=strip is not None, **kw)
        out[f"full_{mode}"] = ring(x["q"], x["k"], x["v"], *(() if strip is None else (strip,)))
        out[f"plain_{mode}"] = _plain_attention(x["q"], x["k"], x["v"], strip=strip, **kw)
    return out


def _four(tmp, rank, world):
    """4 ranks: the meshes and batch helpers, the rings at n = 4 and the
    sequence-parallel diffusion trunk."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ttts_tpu_torch.config import DiffusionNetConfig, MeshConfig
    from ttts_tpu_torch.models.diffusion_net import AA_diffusion
    from ttts_tpu_torch.parallel import data_axis_size, make_mesh, shard_batch
    from ttts_tpu_torch.parallel.mesh import all_reduce, batch_groups, data_rank, gather_batch

    out = {}
    for name, cfg in (("dm", MeshConfig(data=-1, model=2)),
                      ("ddm", MeshConfig(dcn=2, data=-1, model=1))):
        mesh = make_mesh(cfg)
        x = torch.arange(8.0).reshape(8, 1) * 10
        mine = shard_batch(mesh, x)
        s = all_reduce([torch.full((2,), float(rank)), None], batch_groups(mesh))
        out[name] = {"shape": tuple(mesh.mesh.shape), "names": mesh.mesh_dim_names,
                     "data_axis_size": data_axis_size(mesh), "data_rank": data_rank(mesh),
                     "mine": mine, "gathered": gather_batch(mesh, mine), "mean": s}
    out.update(_rings(tmp, rank, world))
    x = {k: torch.from_numpy(v) for k, v in inputs(tmp).items() if k.startswith("d_")}
    sd = torch.load(tmp / "diffusion.pt")
    cfg = DiffusionNetConfig(**DIFF_CFG)
    sp = init_device_mesh("cpu", (world,), mesh_dim_names=("sp",))
    for name, mesh in (("dense", None), ("sp", sp)):
        net = AA_diffusion(cfg, sp_mesh=mesh).eval()
        net.load_state_dict(sd)
        with torch.no_grad():
            out[f"trunk_{name}"] = net(x["d_x"], x["d_t"], x["d_latent"], x["d_refer"])
    dist.barrier()
    return out


def _two(tmp, rank, world):
    """2 ranks: the rings at n = 2; the sharding rule and a sharded GPT's
    loss on a (data=1, model=2) mesh."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ttts_tpu_torch.config import GPTConfig, MeshConfig
    from ttts_tpu_torch.models.gpt import UnifiedVoice
    from ttts_tpu_torch.parallel import make_mesh
    from ttts_tpu_torch.parallel.sharding import infer_param_shardings, shard_params
    from ttts_tpu_torch.train.steps import gpt_loss

    out = _rings(tmp, rank, world)
    mesh = make_mesh(MeshConfig(data=1, model=2))
    model = UnifiedVoice(GPTConfig(**GPT_CFG)).eval()
    model.load_state_dict(torch.load(tmp / "gpt.pt"))
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    batch = {k[4:]: torch.from_numpy(v) for k, v in inputs(tmp).items() if k.startswith("gpt_")}
    rules = infer_param_shardings(model, mesh, min_size=4096)
    out["shardings"] = {k: (p[0].dim if p[0].is_shard() else None) for k, p in rules.items()}
    with torch.no_grad():
        out["loss"] = gpt_loss(model, batch)[0]
        shard_params(model, mesh, min_size=4096)
        with implicit_replication():
            loss = gpt_loss(model, batch)[0]
    out["loss_sharded"] = loss.full_tensor() if isinstance(loss, DTensor) else loss
    out["sharded_local"] = {k: (tuple(p.to_local().shape), shapes[k])
                            for k, p in model.named_parameters() if isinstance(p, DTensor)}
    return out


SCENARIOS = {"four": _four, "two": _two}


# -------------------------------------------------------------------- tests


def _ring_inputs(rng, t=64):
    b, h, d = 2, 4, 16
    return {"q": rng.standard_normal((b, t, h, d)).astype(np.float32),
            "k": rng.standard_normal((b, t, h, d)).astype(np.float32),
            "v": rng.standard_normal((b, t, h, d)).astype(np.float32),
            "strip": rng.standard_normal((h, 2 * t - 1)).astype(np.float32)}


def _jax_diffusion(rng):
    """JAX's AA_diffusion of tests/test_ring_attention.py:60-85: its
    variables, inputs and the dense and sp=4 outputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ttts_tpu.config import DiffusionNetConfig
    from ttts_tpu.models.diffusion_net import AA_diffusion

    cfg = DiffusionNetConfig(**DIFF_CFG)
    b, t = 2, 32
    x = {"d_x": rng.standard_normal((b, t, 6)).astype(np.float32),
         "d_t": np.asarray([3.0, 17.0], np.float32),
         "d_latent": rng.standard_normal((b, 10, 16)).astype(np.float32),
         "d_refer": rng.standard_normal((b, 9, 6)).astype(np.float32)}
    args = [jnp.asarray(x[k]) for k in ("d_x", "d_t", "d_latent", "d_refer")]
    dense = AA_diffusion(cfg)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("sp",))
    sp = AA_diffusion(cfg, sp_mesh=mesh)
    params = dense.init(jax.random.key(0), *args)
    # rescale the zero-initialised output projections so that attention
    # reaches the output
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (0.05 * jax.random.normal(jax.random.key(len(path)), v.shape)
                         if "proj" in jax.tree_util.keystr(path) and v.ndim == 2 else v),
        params)
    outs = {"dense": np.asarray(jax.jit(lambda p: dense.apply(p, *args))(params)),
            "sp": np.asarray(jax.jit(lambda p: sp.apply(p, *args))(params))}
    return params, x, outs


@pytest.fixture(scope="module")
def world_four(tmp_path_factory):
    from ttts_tpu_torch import porting

    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("four")
    params, dx, jax_out = _jax_diffusion(rng)
    ring = _ring_inputs(rng)
    np.savez(tmp / "inputs.npz", **ring, **dx)
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in porting.aa_diffusion_state_dict(params).items()},
               tmp / "diffusion.pt")
    return run_world(pathlib.Path(__file__), "four", 4, tmp), ring, jax_out


def _dryrun_gpt_batch(rng, b=4, lt=12, lm=16):
    return {"text": rng.integers(1, 200, size=(b, lt)),
            "text_lengths": rng.integers(4, lt + 1, size=(b,)),
            "mel_codes": rng.integers(0, 1024, size=(b, lm)),
            "wav_lengths": rng.integers(4, lm + 1, size=(b,)) * 1024}


@pytest.fixture(scope="module")
def world_two(tmp_path_factory):
    import jax

    from ttts_tpu.config import GPTConfig
    from ttts_tpu.models.gpt import UnifiedVoice
    from ttts_tpu_torch import porting

    rng = np.random.default_rng(1)
    tmp = tmp_path_factory.mktemp("two")
    ring = _ring_inputs(rng)
    batch = _dryrun_gpt_batch(rng)
    params = UnifiedVoice(GPTConfig(**GPT_CFG)).init(
        jax.random.key(0), *(jax.numpy.asarray(batch[k]) for k in
                             ("text", "text_lengths", "mel_codes", "wav_lengths")))
    np.savez(tmp / "inputs.npz", **ring, **{f"gpt_{k}": v for k, v in batch.items()})
    sd = porting.unified_voice_state_dict(params)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp / "gpt.pt")
    return run_world(pathlib.Path(__file__), "two", 2, tmp), ring, params


@pytest.mark.parametrize("cfg", [dict(data=-1, model=2), dict(dcn=2, data=-1, model=2),
                                 dict(data=3, model=2), dict(model=3)])
def test_mesh_shape_matches_jax(cfg):
    import jax

    from ttts_tpu.config import MeshConfig as JMeshConfig
    from ttts_tpu.parallel import data_axis_size as jdata_axis_size
    from ttts_tpu.parallel import make_mesh as jmake_mesh
    from ttts_tpu_torch.config import MeshConfig
    from ttts_tpu_torch.parallel.mesh import mesh_shape

    devices = jax.devices()[:8]
    try:
        jmesh = jmake_mesh(JMeshConfig(**cfg), devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh_shape(MeshConfig(**cfg), 8)
        return
    shape, names = mesh_shape(MeshConfig(**cfg), 8)
    assert names == jmesh.axis_names
    assert shape == tuple(jmesh.shape[a] for a in names)
    n_data = math.prod(s for s, a in zip(shape, names) if a in ("data", "dcn"))
    assert n_data == jdata_axis_size(jmesh)


def test_make_mesh_on_four_ranks(world_four):
    outs, _, _ = world_four
    for r, o in enumerate(outs):
        dm, ddm = o["dm"], o["ddm"]
        assert dm["shape"] == (2, 2) and dm["names"] == ("data", "model")
        assert ddm["shape"] == (2, 2, 1) and ddm["names"] == ("dcn", "data", "model")
        assert dm["data_axis_size"] == 2 and ddm["data_axis_size"] == 4
        # row-major over ranks: (data, model) = divmod(rank, 2); dcn slowest
        assert dm["data_rank"] == r // 2 and ddm["data_rank"] == r
        x = torch.arange(8.0).reshape(8, 1) * 10
        np.testing.assert_array_equal(dm["mine"], x[4 * (r // 2):4 * (r // 2) + 4])
        np.testing.assert_array_equal(ddm["mine"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(dm["gathered"], x)
        np.testing.assert_array_equal(ddm["gathered"], x)
        # the mean over the batch axes: the two data ranks of a model column
        # (ranks r % 2 and r % 2 + 2), and all four ranks on the dcn mesh
        assert dm["mean"][1] is None and ddm["mean"][1] is None
        np.testing.assert_array_equal(dm["mean"][0], torch.full((2,), 1.0 + r % 2))
        np.testing.assert_array_equal(ddm["mean"][0], torch.full((2,), 1.5))


def test_infer_param_shardings_match_jax(world_two):
    """JAX's rule at model=2 marks its sharded leaves; porting carries the
    marks (1 + the index along the sharded last axis) to the port's keys,
    whose rule must shard the same keys on the dimension the marks vary
    along."""
    import jax
    from jax.sharding import Mesh

    from ttts_tpu.parallel.sharding import infer_param_shardings as jinfer
    from ttts_tpu_torch import porting

    outs, _, params = world_two
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    rules = jinfer(params, mesh, min_size=4096)

    def mark(v, s):
        if tuple(s.spec) and s.spec[-1] == "model":
            return np.broadcast_to(1.0 + np.arange(v.shape[-1]), v.shape).astype(np.float32)
        return np.zeros(v.shape, np.float32)

    marks = porting.unified_voice_state_dict(jax.tree_util.tree_map(mark, params, rules))
    want = {}
    for k, m in marks.items():
        if not m.any():
            want[k] = None
        else:
            varying = [d for d in range(m.ndim) if m.shape[d] > 1
                       and not (np.diff(m, axis=d) == 0).all()]
            assert len(varying) == 1, k
            want[k] = varying[0]
    for o in outs:
        assert o["shardings"] == want
    assert sum(d is not None for d in want.values()) >= 9


def test_shard_params_keeps_gpt_loss(world_two):
    outs, _, _ = world_two
    for o in outs:
        assert o["sharded_local"], "no parameter was sharded"
        for k, (local, whole) in o["sharded_local"].items():
            d = o["shardings"][k]
            if d is None:
                assert local == whole
            else:
                assert local[d] * 2 == whole[d]
        np.testing.assert_allclose(float(o["loss_sharded"]), float(o["loss"]), atol=1e-5,
                                   rtol=0)
    assert float(outs[0]["loss"]) == float(outs[1]["loss"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["plain", "causal", "strip"])
def test_ring_attention(n, mode, world_two, world_four):
    """Every rank's local ring output is its chunk of the full output; the
    full outputs equal plain attention and JAX's ring at the same n."""
    import jax
    from jax.sharding import Mesh

    from ttts_tpu.parallel.ring_attention import make_ring_attention as jmake_ring

    outs, ring = (world_two if n == 2 else world_four)[:2]
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("sp",))
    jring = jax.jit(jmake_ring(mesh, "sp", causal=mode == "causal", with_bias=mode == "strip"))
    args = [ring[k] for k in "qkv"] + ([ring["strip"]] if mode == "strip" else [])
    want = np.asarray(jring(*args))
    c = want.shape[1] // n
    for r, o in enumerate(outs):
        full = o[f"full_{mode}"].numpy()
        np.testing.assert_allclose(full, o[f"plain_{mode}"].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(full, want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(o[f"local_{mode}"].numpy(), full[:, r * c:(r + 1) * c])


def test_sequence_parallel_trunk(world_four):
    outs, _, jax_out = world_four
    np.testing.assert_allclose(jax_out["sp"], jax_out["dense"], atol=1e-4, rtol=0)
    assert np.abs(jax_out["dense"]).max() > 0.1
    for o in outs:
        sp, dense = o["trunk_sp"].numpy(), o["trunk_dense"].numpy()
        assert sp.shape == (2, 32, 12)
        np.testing.assert_allclose(sp, dense, atol=1e-4, rtol=0)
        np.testing.assert_allclose(sp, jax_out["sp"], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(sp, outs[0]["trunk_sp"].numpy())


if __name__ == "__main__":
    worker_main(SCENARIOS)
