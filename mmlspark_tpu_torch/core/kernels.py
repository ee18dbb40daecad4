"""Hand-written CUDA kernels: build, load, and the device rule.

Role of `NativeLoader` (src/core/env/src/main/scala/NativeLoader.java:47-105)
and of the JAX package's core/kernels.py: make the native kernels available
before the first call. It is not a mode registry. Each `csrc/<name>.cu`
compiles with `nvcc` for `sm_90a` into its own shared library under
`build/mmlspark_tpu_torch/` beside the package, named by a hash of the
sources and flags, and loads through ctypes. There is no environment
override, no mode switch and no fallback: a wrapper given a CUDA tensor
launches its kernel or raises.

Building happens at first use (or up front through `build`), never at
import, so modules that hold kernel wrappers import on machines without
`nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["KernelBuildError", "build", "load", "resolve_device",
           "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS"]

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "mmlspark_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """`nvcc` is missing or refused a source; carries the compiler output."""


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device an entry point runs on. A CUDA device that is not there
    raises: the port never carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found on PATH or under /usr/local/cuda")


def _sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _lib_path(name: str) -> Path:
    """Library path keyed on the source, every shared header and the flags."""
    h = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: "list[str] | None" = None) -> dict:
    """Compile every missing kernel library, one `nvcc` per source, all
    started together. Returns {"seconds", "built", "cached"}; raises
    KernelBuildError with the compiler output of any source that fails."""
    names = _sources() if names is None else list(names)
    t0 = time.perf_counter()
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in names if not _lib_path(n).exists()]
        cached = [n for n in names if n not in todo]
        procs = []
        if todo:
            nvcc = _nvcc()
            for name in todo:
                # unique temp file + atomic rename: a concurrent build
                # never sees a half-written library
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
                procs.append((name, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        failures = []
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, _lib_path(name))
            else:
                os.unlink(tmp)
                failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
        if failures:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return {"seconds": time.perf_counter() - t0, "built": todo, "cached": cached}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
    return lib
