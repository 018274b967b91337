"""Build and load the port's CUDA C++ kernels (``orion_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``; no PyTorch
header is included, so a build takes seconds. The shared headers
``csrc/*.cuh`` (``tc.cuh``: the tensor-core building blocks) are included
by the sources. Libraries are cached under ``orion_tpu_torch/_build/``
(listed in ``.gitignore``) by the SHA-256 of their source and the headers,
so an edited source or header rebuilds and an unchanged one loads.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them; ``library(name)`` builds one on first use, and ``entry`` binds a
C function of it with its argument types. Every C entry point returns
``cudaGetLastError()`` as an int, and ``check(rc, name)`` raises when it
is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "paged_prefill", "ragged_verify",
           "rmsnorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of orion_tpu_torch are built from source on first use"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built already;
    returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Build every source in parallel (one nvcc each); returns the
    compiler's output per source (register and shared-memory use)."""
    with _LOCK:
        jobs = {n: _start(n) for n in SOURCES}
        return {n: _finish(n, *jobs[n]) for n in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        out, job = _start(name)
        _finish(name, out, job)
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    types set (once) and an int return (the cudaError_t of the launch)."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {rc})")
