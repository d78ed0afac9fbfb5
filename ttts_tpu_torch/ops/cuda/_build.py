"""Build and load the hand-written CUDA kernels (ttts_tpu_torch/csrc/*.cu).

nvcc compiles each source to an object, one process per source, all started
together, and links the objects into one shared library with a plain C
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
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p: a plain int would be cut to 32 bits)
_SIGNATURES = {
    "ttts_vq_nearest": (_P, _P, _P, _I, _I, _I, _P),
    "ttts_decode_attention_bf16": (_P,) * 6 + (_I, _I, _I, _I, _F, _P),
    "ttts_flash_attention": (_P,) * 5 + (_I,) * 12 + (_F, _P),
    "ttts_resblock": (_P,) * 15 + (_I, _I, _I, _I, _F, _P),
    "ttts_gn_qkv": (_P,) * 8 + (_I,) * 5 + (_F, _P),
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


def _sources(csrc: pathlib.Path):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def library_path(csrc: pathlib.Path | None = None) -> pathlib.Path:
    """The library built from the sources in `csrc` (default: CSRC)."""
    cu, cuh = _sources(csrc or CSRC)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libttts_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, csrc: pathlib.Path | None = None) -> pathlib.Path:
    """Compile the kernels of `csrc` (default: CSRC) unless an identical
    build exists; return the library path. `verbose` adds ptxas's
    register/shared-memory report to the compiler output, which is printed.
    Builds of different sources may run at once (threads of one process)."""
    global last_build_seconds
    path = library_path(csrc)
    if path.exists() and not verbose:
        return path
    cu, _ = _sources(csrc or CSRC)
    objs = BUILD_DIR / f"obj.{os.getpid()}.{path.stem}"
    objs.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    nvcc, ptxas = _nvcc(), ["-Xptxas=-v"] if verbose else []
    t0 = time.perf_counter()
    procs = [(src, subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o",
                                     str(objs / f"{src.stem}.o"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for src in cu]
    failed = []
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
        elif verbose:
            print(f"{src.name}:\n{err}")
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *(str(objs / f"{src.stem}.o") for src in cu)],
                             capture_output=True, text=True)
        if res.returncode:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    last_build_seconds = time.perf_counter() - t0
    shutil.rmtree(objs, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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



def records_grad(*tensors) -> bool:
    """Whether autograd would record a call on these inputs: grad mode is on
    and a floating input requires grad. The kernels have no backward, so
    each dispatch takes its plain (differentiable) version then, as the JAX
    package trains on its XLA paths, and each raw wrapper refuses such
    inputs rather than return a tensor cut from the graph."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.is_floating_point() and t.requires_grad
        for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record `name`'s launch on these inputs."""
    if records_grad(*tensors):
        raise ValueError(f"{name}: the kernel has no backward; an input requires grad "
                         "under grad mode (the dispatch takes the plain version then)")
