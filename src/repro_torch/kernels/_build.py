"""Build the port's CUDA sources and load them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

All sources build in parallel, one ``nvcc`` each, at the first call that
needs a kernel (never at import). The library name carries a hash of the
source and flags, so an edited source is rebuilt and a stale library is
never loaded. The build directory is ``build/torch_ext`` at the root of the
checkout, or ``$REPRO_TORCH_BUILD_DIR``. Any failure raises: there is no
fallback to the plain versions on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOG: dict = {}          # source name -> {"seconds": s, "ptxas": text}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[2] / "build" / "torch_ext"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Build every missing library in parallel and load all of them.
    Returns ``{name: ctypes.CDLL}``; raises with nvcc's output on failure."""
    with _LOCK:
        sources = sorted(CSRC.glob("*.cu"))
        if all(s.stem in _LIBS for s in sources):
            return dict(_LIBS)
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in sources:
            so = _target(src)
            if src.stem in _LIBS or so.exists():
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, so, tmp, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        failed = []
        for src, so, tmp, t0, p in procs:
            log, _ = p.communicate()
            BUILD_LOG[src.stem] = {"seconds": time.perf_counter() - t0,
                                   "ptxas": log}
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in sources:
            if src.stem not in _LIBS:
                _LIBS[src.stem] = ctypes.CDLL(str(_target(src)))
        return dict(_LIBS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all()[name]


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
