"""Build and load the CUDA kernels of :mod:`repro_torch.kernels`.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds). The library lands in ``build/repro_torch/`` at the root of
the checkout, named by a hash of its source, the shared headers and the
flags, at first use; a later process reuses it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
CSRC = Path(__file__).resolve().parent / "csrc"

# No --use_fast_math: it makes division approximate and flushes denormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s, or
    the one on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, of
    every header in ``csrc/`` (the sources include ``common.cuh`` and
    ``butterfly.cuh``; hashing all headers rebuilds a library after any
    header edit) and of the
    flags."""
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns
    ``(path, seconds spent compiling, compiler output)``."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    (BUILD_DIR / f"{name}.log").write_text(log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)
    return out, seconds, log


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C function to its ``argtypes`` (every C function returns the
    ``cudaError_t`` of its launch as an int)."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _, _ = build(name)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


# ---------------------------------------------------------------------------
# what every wrapper does around a launch
# ---------------------------------------------------------------------------

def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (take the plain version);
    False when all lie on the current CUDA device, where the kernels launch;
    raises on any other device or a mix."""
    devices = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len(devices) == 1:
        (dev,) = devices
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"tensors on {dev}, but the kernels launch on "
                             f"the current device cuda:"
                             f"{torch.cuda.current_device()}")
        return False
    raise ValueError(f"the kernels take tensors all on the CPU or all on "
                     f"one CUDA device; got {sorted(map(str, devices))}")


def check(rc: int, fn: str):
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{fn} failed: cudaError_t {rc}")


def stream():
    """PyTorch's current CUDA stream, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
