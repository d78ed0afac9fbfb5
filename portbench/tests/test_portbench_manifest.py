"""BENCHMARK.json against the contract's shape rules, and every name in it
resolving to its file."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT
from portbench import run as bench

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KINDS = {w["name"]: json.loads((ROOT / "portbench" / "workloads" / f"{w['name']}.json")
                               .read_text())["kind"] for w in BENCH["workloads"]}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all("/" not in w and ".." not in w for w in BENCH["command"][2:])


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(
        BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    found = bench.find_cell(ROOT, cell)
    assert (bench.PKG / "traffic" / f"{found.workload['kind']}.py").is_file()
    assert found.config["name"] == found.entry["config"]
    assert "setup_s" in {m["name"] for m in found.end_to_end}
    assert len(found.end_to_end) >= 2 and found.per_layer
    limits = found.workload["limits"]
    assert limits and set(limits) <= _readings(found.workload["kind"], found.workload["params"])
    assert all(0 < v < 1 for v in limits.values())


def _readings(kind, params):
    if kind == "gpt_train":
        return {"loss_rel", "grad_gap", "change_gap"}
    extra = {"clvp_rel"} if params["candidates"] > 1 else set()
    return {"decode_gap", "latent_rel", "mel_rel", "wav_rel"} | extra


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_resolves(metric):
    m = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = bench.load(bench.PKG / "metrics" / f"{metric}.py", f"metric_{metric}")
    assert callable(mod.read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m["workloads"]:
        e2e = bench.find_cell(ROOT, cell).end_to_end
        assert m["moves"] in {e["name"] for e in e2e}
    if ".roofline." in metric:
        kernel = metric.rsplit(".", 1)[1]
        assert m["unit"] == "%"
        rf = bench.roofline(kernel)
        assert rf.KERNELS and callable(rf.work)


def test_configs_resolve():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert {"ttts", "assumed", "precision"} <= set(data)


def test_check_budget_fits():
    """A full check of 24 cells at run_seconds fits in 43200 s."""
    rs, cells = BENCH["run_seconds"], 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
