"""Build and load the CUDA kernels of :mod:`repro_torch.kernels`.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds). The library lands in ``build/repro_torch/`` at the root of
the checkout, named by a hash of its source, the shared headers and the
flags, at first use; a later process reuses it.

Every wrapper also takes ``meta`` tensors (:func:`on_meta`): an abstract run
of a step (``launch/dryrun.py``) gets empty outputs of the right shapes and
dtypes and runs nothing. Wrapped in :func:`costed`, a wrapper reports its
kernel's flops and bytes to the cost walker of ``launch/hlocost.py`` on
every device, and hides the ops inside it from the walker.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.analysis import provenance
from repro_torch.utils import spans

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
    every header in ``csrc/`` (the sources include ``common.cuh``,
    ``butterfly.cuh`` and ``hopper.cuh``; hashing all headers rebuilds a
    library after any header edit) and of the flags."""
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
    ``cudaError_t`` of its launch as an int). With spans recording, a
    ``build.load`` note holds the load's host ms and the compile's
    (``compile_ms``) apart."""
    lib = _LOADED.get(name)
    if lib is None:
        t0 = time.perf_counter()
        path, compile_s, _ = build(name)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LOADED[name] = lib
        total_ms = (time.perf_counter() - t0) * 1e3
        spans.note("build.load", total_ms - compile_s * 1e3,
                   compile_ms=compile_s * 1e3, library=name)
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


def on_meta(*tensors) -> bool:
    """True when every tensor lies on ``meta`` (an abstract run: the
    wrapper returns empty outputs of the right shapes and dtypes and runs
    nothing); False when none does; raises on a mix, so a real tensor never
    takes the meta branch."""
    kinds = {t.device.type for t in tensors if t is not None}
    if "meta" not in kinds:
        return False
    if kinds != {"meta"}:
        raise ValueError(f"the kernels take meta tensors only together; got "
                         f"{sorted(kinds)}")
    return True


# the cost walkers listening (launch/hlocost.CostWalker adds itself while it
# walks a step), and how deep inside a costed wrapper the caller is
LISTENERS: list = []
_DEPTH = [0]


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def costed(flops, nbytes=None):
    """Decorator of a kernel wrapper: with a cost walker listening, report
    the call to it as one kernel, ``flops(*args, **kw)`` matmul-class flops
    and ``nbytes(*args, **kw)`` bytes, by default those of every tensor
    argument (read once) and every tensor returned (written once); a
    wrapper that reads only part of an argument (the grouped product reads
    the experts that have rows) counts its own, from shapes alone, so
    ``meta`` and the card count alike. It mutes the walker for the ops
    inside (the plain version on the CPU, the outputs' allocation on the
    card or on ``meta``), whose storages it still tracks. With a wire recorder
    listening (``analysis/provenance.py``), hand it the call's tensors in
    and out: a launch is no aten op, so a round's op log sees it only
    here. A wrapper called inside another is part of the outer one's
    kernel."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if _DEPTH[0] or not (LISTENERS or provenance.RECORDERS):
                return fn(*args, **kw)
            listeners = tuple(LISTENERS)
            _DEPTH[0] += 1
            try:
                out = fn(*args, **kw)
            finally:
                _DEPTH[0] -= 1
            ins = _tensors(args) + _tensors(list(kw.values()))
            outs = _tensors(out)
            if listeners:
                moved = (float(nbytes(*args, **kw)) if nbytes is not None
                         else sum(t.numel() * t.element_size()
                                  for t in ins + outs))
                work = float(flops(*args, **kw))
                for walker in listeners:
                    walker.kernel(fn.__name__, work, float(moved))
            for rec in tuple(provenance.RECORDERS):
                rec.kernel(fn.__name__, ins, outs)
            return out
        return wrapper
    return deco


def no_flops(*args, **kw) -> float:
    """The matmul-class flops of a kernel that does none (the exchange's
    butterflies and roundings run on the CUDA cores; the walker counts
    their bytes)."""
    return 0.0


def muted() -> bool:
    """True inside a :func:`costed` wrapper."""
    return _DEPTH[0] > 0


def check(rc: int, fn: str):
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{fn} failed: cudaError_t {rc}")


def stream():
    """PyTorch's current CUDA stream, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
