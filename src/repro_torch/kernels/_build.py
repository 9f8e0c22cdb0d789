"""Build the port's CUDA sources and load them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [-D...] -o <build>/<name>-<hash>.so
         csrc/<name>.cu

A source named in ``DEFINES`` takes macros from ``nvcc_defines()`` of the
wrapper module of its name: the module's tile table becomes the kernel's
template instances, so the table is written once (``nvcc_flags``).

All sources build in parallel, one ``nvcc`` each, at the first call that
needs a kernel (never at import). The library name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and its flags, so an edited
source or header is rebuilt and a stale library is never loaded. The build
directory is ``build/torch_ext`` at the root of the checkout, or
``$REPRO_TORCH_BUILD_DIR``. Any failure raises: there is no fallback to the
plain versions on the card.

``on_card`` and ``float_code`` are the float wrappers' common checks: where
the operands lie, and which element type the C entry point is told.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# csrc/<name>.cu whose macros come from kernels/<name>.py::nvcc_defines()
DEFINES = ("alu", "flash_attention", "pool2d")

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


def nvcc_flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu``: ``NVCC_FLAGS`` and, for a
    source in ``DEFINES``, its wrapper module's macros."""
    if name not in DEFINES:
        return NVCC_FLAGS
    defines = tuple(importlib.import_module(
        f"{__package__}.{name}").nvcc_defines())
    if any("," in d for d in defines):   # nvcc would split them into two
        raise ValueError(f"{name}: a macro holds a comma: {defines}")
    return NVCC_FLAGS + defines


def _target(src: pathlib.Path) -> pathlib.Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers
                       + " ".join(nvcc_flags(src.stem)).encode())
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
            cmd = [_nvcc(), *nvcc_flags(src.stem), "-o", str(tmp), str(src)]
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


# element types the float kernels take, as their C entry points number them
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_card(what: str, *tensors) -> bool:
    """Where a wrapper runs: False when every tensor (``None`` skipped) lies
    on the CPU, True when all lie on one CUDA device; raises otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: operands must lie on one CUDA device or "
                         f"on the CPU, got {sorted(map(str, devs))}")
    return True


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernels' 16-byte loads
    (``cp.async``, TMA)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def float_code(what: str, *tensors) -> int:
    """The C entry points' code of the tensors' common dtype (f32 or bf16);
    raises on any other dtype or on mixed dtypes."""
    dts = {t.dtype for t in tensors if t is not None}
    if len(dts) != 1 or next(iter(dts)) not in FLOAT_CODES:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {sorted(map(str, dts))}")
    return FLOAT_CODES[dts.pop()]
