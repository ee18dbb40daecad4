"""Native host-kernel loader (the NativeLoader analogue).

Reference: `NativeLoader.java:47-105` extracts the right `.so` for the
platform and `System.load`s it before any native call. A copy of
mmlspark_tpu/native/__init__.py for the two host kernels the port uses:
numeric binning and the tree walk. The C++ in `kernels.cpp` is compiled ON
DEMAND with the system toolchain (g++, cached by source mtime, into this
package's own `_build/`) and bound via ctypes; every entry point has a
pure-numpy path that gives the same bits, taken when no toolchain is there
(`available()` reports which path is active).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["available", "get_lib", "bin_numeric", "make_tree_predictor"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "kernels.cpp")
_LOCK = threading.Lock()
_LIB: "ctypes.CDLL | None | bool" = None  # None = untried, False = unavailable

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64


def _build_dir() -> str:
    d = os.path.join(_DIR, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> str | None:
    """Never raises: any filesystem/toolchain problem returns None (the
    caller falls back to numpy, as NativeLoader falls back on resource
    lookup failure)."""
    try:
        out = os.path.join(_build_dir(), "libmmlsparktputorch.so")
        if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
            return out
        # unique tmp + atomic rename: concurrent builds can't corrupt the .so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_dir())
        os.close(fd)
    except OSError:
        return None  # read-only install dir, missing kernels.cpp, ...
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            os.unlink(tmp)
            return None
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.TimeoutExpired):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def get_lib() -> "ctypes.CDLL | None":
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB or None
        path = _compile()
        if path is None:
            _LIB = False
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _LIB = False
            return None
        lib.mmlspark_bin_numeric.argtypes = [
            _F64, _I64, _I64, _F64, _I64, _I32, _U8, _I32,
        ]
        lib.mmlspark_bin_numeric.restype = None
        lib.mmlspark_predict_trees.argtypes = [
            _I32, _I64, _I64, _I64, _I64,
            _I32, _I32, _U8, _I32, _I32, _F32, _I32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float, _U8, _I64, _F32,
        ]
        lib.mmlspark_predict_trees.restype = None
        # raw void* twin of the SAME signature, declared here so the two
        # can never drift: make_tree_predictor calls through it with
        # cached data pointers (the ndpointer path re-marshals every
        # immutable tree array on every call). It must be a SECOND CDLL
        # handle, not a CFUNCTYPE wrapper: ctypes releases the GIL only for
        # foreign functions reached through a library object (CFUNCTYPE
        # pointers are called WITH the GIL held), and other threads must
        # keep running while the walk does.
        raw = ctypes.CDLL(path)
        raw.mmlspark_predict_trees.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            *([ctypes.c_void_p] * 7),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        raw.mmlspark_predict_trees.restype = None
        lib._predict_trees_raw = raw.mmlspark_predict_trees
        _LIB = lib
        return lib


def available() -> bool:
    return get_lib() is not None


def bin_numeric(x: np.ndarray, upper_bounds: np.ndarray, num_bins: np.ndarray,
                is_cat: np.ndarray, out: np.ndarray) -> bool:
    """Fill `out` for numeric features; returns False when the native lib is
    unavailable (caller runs the numpy path)."""
    lib = get_lib()
    if lib is None:
        return False
    n, f = x.shape
    lib.mmlspark_bin_numeric(
        np.ascontiguousarray(x, np.float64), n, f,
        np.ascontiguousarray(upper_bounds, np.float64), upper_bounds.shape[1],
        np.ascontiguousarray(num_bins, np.int32),
        np.ascontiguousarray(is_cat, np.uint8),
        out,
    )
    return True


def make_tree_predictor(feature: np.ndarray, threshold: np.ndarray,
                        is_cat: np.ndarray, left: np.ndarray,
                        right: np.ndarray, value: np.ndarray,
                        tree_class: np.ndarray, k: int, max_steps: int,
                        init_score: float,
                        cat_bitset: "np.ndarray | None" = None):
    """Prepared SoA tree-walk scorer: `fn(bins) -> out`, or None when the
    native lib is unavailable. cat_bitset: (T, M, Bc) bool left-subset
    masks for categorical nodes.

    The tree arrays are immutable after training, so they are converted
    ONCE and the call goes through a raw void* prototype with cached data
    pointers; only `bins`/`out` marshal per call."""
    lib = get_lib()
    if lib is None:
        return None
    t, m = feature.shape
    if cat_bitset is None:
        cat_bitset = np.zeros((t, m, 1), bool)
    bc = cat_bitset.shape[-1]
    arrs = (
        np.ascontiguousarray(feature, np.int32),
        np.ascontiguousarray(threshold, np.int32),
        np.ascontiguousarray(is_cat, np.uint8),
        np.ascontiguousarray(left, np.int32),
        np.ascontiguousarray(right, np.int32),
        np.ascontiguousarray(value, np.float32),
        np.ascontiguousarray(tree_class, np.int32),
        np.ascontiguousarray(cat_bitset, np.uint8),
    )
    fn = lib._predict_trees_raw  # declared beside argtypes in get_lib
    tree_ptrs = tuple(a.ctypes.data for a in arrs[:7])
    cat_ptr = arrs[7].ctypes.data
    init = float(init_score)
    kk, steps = int(k), int(max_steps)

    def predict(bins: np.ndarray) -> np.ndarray:
        b = np.ascontiguousarray(bins, np.int32)
        n, f = b.shape
        out = (np.zeros((n, kk), np.float32) if kk > 1
               else np.zeros((n,), np.float32))
        fn(b.ctypes.data, n, f, t, m, *tree_ptrs,
           kk, steps, init, cat_ptr, bc, out.ctypes.data)
        return out

    predict._keepalive = arrs  # the cached pointers must outlive the closure
    return predict
