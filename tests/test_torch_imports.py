"""The PyTorch port runs where JAX is not installed: no file of
ttts_tpu_torch, and none of the chip scripts (chip_*.py), may import jax,
flax or optax, nor any ttts_tpu module (the port keeps its own copies of what
it needs)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "ttts_tpu_torch"
ALLOWED = ()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            if node.module == "ttts_tpu":
                yield from (f"ttts_tpu.{a.name}" for a in node.names)


FILES = sorted(PKG.rglob("*.py")) + sorted(ROOT.glob("chip_*.py"))


def test_package_has_files():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    PKG if PKG in p.parents else ROOT)))
def test_no_jax_imports(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax"), f"{path.name}: {mod}"
        if root == "ttts_tpu":
            assert mod.startswith(ALLOWED), f"{path.name} imports {mod}"


# the modules of the data-preparation and training-recipe slice: the scan
# above must cover them
SLICE = ["data/audio.py", "data/prepare/pipeline.py", "data/prepare/misc.py",
         "text/alignment.py", "train/eval_hooks.py", "utils/logging.py"]


def test_scan_covers_the_recipe_modules():
    assert all(PKG / p in FILES for p in SLICE)


# the model library and the host tools around third-party code
LIBRARY = ["models/rvq1.py", "models/dvae.py", "models/group_quantizer.py", "models/flows.py",
           "models/attentions_extras.py", "data/prepare/hubert.py", "data/spider.py",
           "text/alignment.py"]


@pytest.mark.parametrize("path", LIBRARY)
def test_scan_covers_the_model_library(path):
    """The scan covers each module, and importing it needs neither
    transformers nor matplotlib (both are imported at first use)."""
    import importlib
    import sys

    assert PKG / path in FILES
    name = "ttts_tpu_torch." + path[:-3].replace("/", ".")
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m == name or m.split(".")[0] in ("transformers", "matplotlib")}
    try:
        sys.modules["transformers"] = sys.modules["matplotlib"] = None
        importlib.import_module(name)
    finally:
        for m in ("transformers", "matplotlib", name):
            sys.modules.pop(m, None)
        sys.modules.update(saved)


@pytest.mark.parametrize("model", ["clvp", "classifier"])
def test_clvp_and_classifier_training_entry_points(model, tmp_path):
    """`python -m ttts_tpu_torch.train.mains clvp|classifier` parse and reach
    their trainers (a missing input file, not a refusal)."""
    import subprocess
    import sys

    from ttts_tpu_torch.train import mains

    out = subprocess.run([sys.executable, "-m", "ttts_tpu_torch.train.mains", model, "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--clean" in out.stdout and "classifier" in out.stdout
    missing = str(tmp_path / "missing")
    args = (["--manifest", missing] if model == "clvp"
            else ["--clean", missing, "--noise", missing])
    with pytest.raises(FileNotFoundError):
        mains.main([model, *args, "--device", "cpu", "--logs", str(tmp_path / "logs")])


# the multi-GPU package: the scan covers it, and importing it starts no
# process group (the CLIs and TextToSpeech(mesh=...) join one at run time)
PARALLEL = ["parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
            "parallel/ring_attention.py"]


@pytest.mark.parametrize("path", PARALLEL)
def test_scan_covers_the_parallel_package(path):
    import importlib

    import torch.distributed as dist

    assert PKG / path in FILES
    importlib.import_module("ttts_tpu_torch." + path[:-3].replace("/", ".").replace(
        ".__init__", ""))
    assert not dist.is_initialized()
