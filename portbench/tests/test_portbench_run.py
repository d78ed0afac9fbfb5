"""Whole runs at TINY widths on the CPU, the look for a card skipped: the
result line, a cell added by files alone, the program against the plain
reference (the same arithmetic in f32 on the CPU, so every reading is 0),
the held-down stop code, and `correct` false under each fault the cells
can have and under the fp8 control."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from conftest import tiny_ttts
from portbench import run as bench

SEED = 2 ** 31 + 77  # past 32 signed bits: seeds may be that large


def tiny_run(root, cell, trace=0, seconds=0.5):
    return bench.run(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                      "--trace", str(trace)], root=root, require_card=False)


@pytest.fixture(scope="module")
def serve_result(tiny_root):
    return tiny_run(tiny_root, "serve.fast.b64")


@pytest.fixture(scope="module")
def train_result(tiny_root):
    return tiny_run(tiny_root, "train.gpt.ctx1796")


@pytest.mark.parametrize("which", ["serve", "train"])
def test_result_line(which, serve_result, train_result):
    out = serve_result if which == "serve" else train_result
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    e2e = "audio_s_per_s" if which == "serve" else "train_tokens_per_s"
    assert set(out["metrics"]) == {e2e, "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.loads(json.dumps(out))


def test_reference_is_the_port_on_the_cpu(serve_result):
    """f32 on the CPU: the port and the reference are the same arithmetic."""
    assert all(c["value"] <= 1e-6 for c in serve_result["checks"].values())


def test_training_reference_is_the_port_in_f32(tiny_root):
    """The port's f32 step (no autocast) against the reference's, from the
    benchmark's weights on a TINY batch: losses and the update agree."""
    from portbench import check as chk
    from portbench.reference.gpt import UnifiedVoice as RefGPT
    from ttts_tpu_torch.config import GPTConfig, _from_dict
    from ttts_tpu_torch.models.gpt import UnifiedVoice
    from ttts_tpu_torch.train.state import TrainState, make_adamw
    from ttts_tpu_torch.train.steps import gpt_train_step

    kind = bench.load(bench.PKG / "traffic" / "gpt_train.py", "kind_gpt_train_t")
    cfg = json.loads((tiny_root / "portbench/configs/ttts_v2_gpt_train.json").read_text())
    t = cfg["ttts"]["train"]
    ctx = type("C", (), {"seed": SEED, "device": torch.device("cpu")})()
    port = UnifiedVoice(_from_dict(GPTConfig, cfg["ttts"]["gpt"]))
    start = kind.start_weights(ctx, port)
    port.load_state_dict(start)
    state = TrainState.create(port, lambda ps: make_adamw(
        ps, t["lr"], t["warmup_steps"], tuple(t["betas"]), t["weight_decay"], t["grad_clip"],
        t["eps"]))
    spec = {"text": [10, 12, 8, 9], "mel": [20, 24, 17, 30], "text_pad": 16, "mel_pad": 32}
    batches = [kind.make_batch(spec, s, "cpu") for s in (1, 2)]
    names = [n for n, _ in port.named_parameters()]
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(gpt_train_step(state, b, i)["loss"]))
        if i == 0:
            opt = state.opt.opt.state
            grad1 = {n: float(opt[p]["exp_avg"].norm()) / (1 - t["betas"][0])
                     for n, p in zip(names, state.params)}
    delta = {n: p.detach() - start[n] for n, p in port.named_parameters()}
    ref = RefGPT(chk.ref_config(cfg).gpt)
    ref.load_state_dict(start)
    got = chk.reference_steps(ref.train(), batches, t, t["text_weight"], t["mel_weight"], 2)
    readings = chk.train_readings({"losses": losses, "grad1": grad1, "delta": delta}, got,
                                  start)
    print(readings)
    assert readings["loss_rel"] < 1e-6 and readings["grad_gap"] < 1e-5
    assert readings["change_gap"] < 1e-3


def test_stop_code_held_down(tiny_root):
    """With the benchmark's weights no decode row draws the stop code, and
    every stream's audio is max_generate_length x 4 x 256 samples less one
    hop: the serving entry trims to code length x 4 x hop, and Vocos gives
    (frames - 1) x hop for a bucket that the codes fill."""
    kind = bench.load(bench.PKG / "traffic" / "serve_batch.py", "kind_serve_batch_t")
    cell = bench.find_cell(tiny_root, "serve.ultra_fast.b128")
    ctx = bench.context(cell, SEED, torch.device("cpu"))
    kind.setup(ctx)
    rec = kind.unit(ctx, 0)
    stop = cell.config["ttts"]["gpt"]["stop_mel_token"]
    n = ctx.params["max_generate_length"]
    assert not (np.asarray(rec["codes"]) == stop).any()
    assert [len(w) for w in rec["wavs"]] == [n * 4 * 256 - 256] * len(rec["texts"])


def test_new_cell_by_files_alone(tiny_root, tmp_path):
    """A cell added as a workload file and a manifest entry runs, no other
    file edited."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    bench_file = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / "portbench/workloads/train.gpt.ctx1796.json").read_text())
    base["traffic"] = "ctx64_rows3"
    base["params"]["cycle"] = [{"text": [9, 9, 9], "mel": [40, 40, 40], "text_pad": 16,
                                "mel_pad": 48}]
    (root / "portbench/workloads/train.gpt.ctx64.json").write_text(json.dumps(base))
    bench_file["workloads"].append({"name": "train.gpt.ctx64", "config": "ttts_v2_gpt_train",
                                    "traffic": "ctx64_rows3", "chips": 1, "why": "test"})
    for m in bench_file["end_to_end"] + bench_file["per_layer"]:
        if "train.gpt.ctx1796" in m.get("workloads", []):
            m["workloads"].append("train.gpt.ctx64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench_file))
    out = tiny_run(root, "train.gpt.ctx64")
    assert out["correct"] is True and "train_tokens_per_s" in out["metrics"]


def _altered_token(monkeypatch):
    """Every decode row's code altered where it is drawn (the check compares
a sample of the texts)."""
    import ttts_tpu_torch.models.gpt as gpt

    inner = gpt.sample_logits

    def wrong(logits, counts, params, gumbel):
        return (inner(logits, counts, params, gumbel) + 1) % 1024

    monkeypatch.setattr(gpt, "sample_logits", wrong)


def _altered_answer(monkeypatch):
    """Every waveform altered where the vocoder makes it."""
    import ttts_tpu_torch.models.vocos as vocos

    inner = vocos.Vocos.forward
    monkeypatch.setattr(vocos.Vocos, "forward", lambda self, x: 1.5 * inner(self, x))


def _state_unchanged(monkeypatch):
    """A step that computes the loss and leaves the state as it was."""
    import ttts_tpu_torch.train.steps as steps

    def frozen(state, batch, key, amp_dtype=None, **kw):
        loss, lt, lm = steps.gpt_loss(state.model.train(), batch)
        return {"loss": loss.detach(), "loss_text": lt, "loss_mel": lm}

    monkeypatch.setattr(steps, "gpt_train_step", frozen)


def _half_batch(monkeypatch):
    """A step given the first half of each batch's rows, the mean over them."""
    import ttts_tpu_torch.train.steps as steps

    inner = steps.gpt_train_step

    def half(state, batch, key, **kw):
        b = batch["text"].shape[0] // 2
        return inner(state, {k: v[:b] for k, v in batch.items()}, key, **kw)

    monkeypatch.setattr(steps, "gpt_train_step", half)


@pytest.mark.parametrize("cell, fault", [
    ("serve.fast.b64", _altered_token), ("serve.ultra_fast.b128", _altered_answer),
    ("train.gpt.ctx1796", _state_unchanged), ("train.gpt.ctx1796", _half_batch)],
    ids=["token", "answer", "state_unchanged", "half_batch"])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = tiny_run(tiny_root, cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", ["serve.ultra_fast.b128", "train.gpt.ctx1796"])
def test_control_is_not_correct(tiny_root, cell):
    """The fp8 control in the program's place fails a limit."""
    found = bench.find_cell(tiny_root, cell)
    kind = bench.load(bench.PKG / "traffic" / f"{found.workload['kind']}.py",
                      f"kind_control_{cell}")
    ctx = bench.context(found, SEED, torch.device("cpu"))
    kind.setup(ctx)
    records = [kind.unit(ctx, i) for i in range(2)]
    readings = kind.control(ctx, records)
    assert any(readings[k] > ctx.limits[k] for k in readings)


@pytest.mark.card
def test_card_run(card, tiny_root, tmp_path):
    """On a card: a traced run at TINY widths with the look for a card, the
    flash route in bf16 as the configuration states it."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    path = root / "portbench/configs/ttts_v2_gpt_train.json"
    cfg = json.loads(path.read_text())
    cfg["compute_dtype"] = "bfloat16"
    path.write_text(json.dumps(cfg))
    out = bench.run(["--workload", "train.gpt.ctx1796", "--seed", str(SEED), "--seconds", "1",
                     "--trace", "1"], root=root)
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert out["metrics"]["train.roofline.flash_fwd"]["value"] > 0


def test_no_card_no_result(tiny_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(bench.RunError):
        bench.run(["--workload", "train.gpt.ctx1796", "--seed", "1", "--seconds", "1"],
                  root=tiny_root)
    assert tiny_ttts()["gpt"]["layers"] == 1


def test_run_refuses_jax_in_sys_modules(tiny_root, monkeypatch):
    """A run whose process holds `jax` (or the JAX package) prints no result."""
    import types

    monkeypatch.setitem(__import__("sys").modules, "jax", types.ModuleType("jax"))
    with pytest.raises(bench.RunError, match="jax"):
        tiny_run(tiny_root, "train.gpt.ctx1796")
