"""Build and load the hand-written CUDA kernels (ttts_tpu_torch/csrc/*.cu).

nvcc compiles every source in one call into a shared library with a plain C
interface, loaded with ctypes. The library is named by a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one reused. The
build happens at first use (never at import): the CPU-only test host has no
nvcc, and its wrappers take the plain PyTorch path there.

Build directory: ``<repo>/build/kernels`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p: a plain int would be cut to 32 bits)
_SIGNATURES = {
    "ttts_vq_nearest": (_P, _P, _P, _P, _I, _I, _I, _P),
    "ttts_decode_attention_bf16": (_P,) * 9 + (_I, _I, _I, _I, _F, _P),
    "ttts_flash_bias_attention": (_P,) * 5 + (_I,) * 8 + (_F, _P),
    "ttts_resblock": (_P,) * 13 + (_I, _I, _I, _I, _F, _P),
}

# seconds this process spent in nvcc (0.0 when an existing build was reused)
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a host "
                       "with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libttts_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless an identical build exists; return the
    library path. `verbose` adds ptxas's register/shared-memory report to the
    compiler output, which is printed."""
    global last_build_seconds
    path = library_path()
    if path.exists() and not verbose:
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
           "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr)
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ttts_error_string.argtypes = (ctypes.c_int,)
    lib.ttts_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point `name` on the current CUDA stream; raise if the
    launch was refused (the entry point returns cudaGetLastError())."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err:
        msg = lib.ttts_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")

