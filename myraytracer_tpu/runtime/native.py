"""ctypes bindings for the native (C++) runtime.

Loads ``libmrt_runtime.so``, built by runtime/build.sh on first use when
it is missing or older than ``bvh_builder.cpp`` (and a compiler is
available). The NumPy builder in ops/bvh.py is
the semantic reference; this is the fast path for large scenes — the
Python threading-links pass alone is O(8N) interpreter steps, the native
builder does the whole build in C++.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libmrt_runtime.so")
_SRC = os.path.join(_HERE, "bvh_builder.cpp")


def _stale(so: str, src: str) -> bool:
    """The library is missing or older than its source."""
    return (not os.path.exists(so)
            or os.path.getmtime(src) > os.path.getmtime(so))


def _build(so: str, here: str) -> bool:
    """Compile into a private file, then rename it over ``so``: concurrent
    builders (test workers) never load a half-written library."""
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["bash", os.path.join(here, "build.sh"), tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if _stale(_SO, _SRC) and not _build(_SO, _HERE):
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    lib.mrt_bvh_build.restype = ctypes.c_void_p
    lib.mrt_bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mrt_bvh_export.restype = None
    lib.mrt_bvh_export.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     leaf_size: int, builder: str = "median"):
    """Native build; returns the same BVHArrays as ops.bvh.build_bvh."""
    from myraytracer_tpu.ops.bvh import BVHArrays

    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not available")

    v0 = np.ascontiguousarray(v0, np.float64)
    v1 = np.ascontiguousarray(v1, np.float64)
    v2 = np.ascontiguousarray(v2, np.float64)
    T = v0.shape[0]
    centroids = np.ascontiguousarray((v0 + v1 + v2) / 3.0)
    tri_min = np.ascontiguousarray(np.minimum(np.minimum(v0, v1), v2))
    tri_max = np.ascontiguousarray(np.maximum(np.maximum(v0, v1), v2))

    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    n_nodes = ctypes.c_int64(0)
    handle = lib.mrt_bvh_build(
        dptr(centroids), dptr(tri_min), dptr(tri_max),
        T, leaf_size, 1 if builder == "sah" else 0, ctypes.byref(n_nodes),
    )
    N = n_nodes.value

    bbmin = np.empty((N, 3), np.float32)
    bbmax = np.empty((N, 3), np.float32)
    left = np.empty(N, np.int32)
    first = np.empty(N, np.int32)
    count = np.empty(N, np.int32)
    axis = np.empty(N, np.int32)
    entry = np.empty((8, N), np.int32)
    skip = np.empty((8, N), np.int32)
    order = np.empty(T, np.int32)
    max_leaf = ctypes.c_int32(0)

    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.mrt_bvh_export(
        handle, fptr(bbmin), fptr(bbmax), iptr(left), iptr(first),
        iptr(count), iptr(axis), iptr(entry), iptr(skip), iptr(order),
        ctypes.byref(max_leaf),
    )
    return BVHArrays(
        bbmin=bbmin, bbmax=bbmax, left=left, first=first, count=count,
        axis=axis, entry=entry, skip=skip, order=order,
        max_leaf=int(max_leaf.value),
    )
