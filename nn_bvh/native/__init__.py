"""Native (C++) host-side components, loaded via ctypes.

The device compute path is JAX/XLA (plus the CUDA traversal kernel); the
host-side runtime around it uses native code where the reference does (BVH
build: cpu/aggregates.cpp). The
shared library is compiled on first use with the system g++ and cached next
to the sources, keyed by a source hash; every entry point has a numpy
fallback so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")

_lib = None
_lib_tried = False


def _build_lib() -> "ctypes.CDLL | None":
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_DIR, f"_nn_bvh_native_{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"nn_bvh.native: build failed ({e}); numpy fallback",
                  file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.nn_bvh_build_sah.restype = ctypes.c_int64
    lib.nn_bvh_build_sah.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.nn_bvh_sah_cost.restype = ctypes.c_double
    lib.nn_bvh_sah_cost.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
    ]
    return lib


def get_lib():
    """The native library, or None if unavailable (numpy fallback)."""
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        if os.environ.get("NN_BVH_NO_NATIVE"):
            _lib = None
        else:
            _lib = _build_lib()
    return _lib


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_sah_native(prim_lo: np.ndarray, prim_hi: np.ndarray,
                     max_leaf: int | None = None):
    """Native binned-SAH build; returns an accel.build.BVH, or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..accel.build import BVH, MAX_LEAF_PRIMS

    if max_leaf is None:
        max_leaf = MAX_LEAF_PRIMS
    n = len(prim_lo)
    prim_lo = np.ascontiguousarray(prim_lo, np.float32)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32)
    cap = max(2 * n, 16)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_meta = np.empty((cap, 3), np.int32)
    order = np.empty(n, np.int64)
    n_nodes = lib.nn_bvh_build_sah(
        _fptr(prim_lo), _fptr(prim_hi), n, int(max_leaf),
        _fptr(node_lo), _fptr(node_hi),
        node_meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n_nodes <= 0:
        return None
    return BVH(
        node_lo=node_lo[:n_nodes].copy(),
        node_hi=node_hi[:n_nodes].copy(),
        node_meta=node_meta[:n_nodes].copy(),
        prim_order=order,
        n_nodes=int(n_nodes),
    )


def sah_cost_native(bvh) -> "float | None":
    lib = get_lib()
    if lib is None:
        return None
    return float(lib.nn_bvh_sah_cost(
        _fptr(np.ascontiguousarray(bvh.node_lo)),
        _fptr(np.ascontiguousarray(bvh.node_hi)),
        np.ascontiguousarray(bvh.node_meta).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)),
        int(bvh.n_nodes), 1.2, 1.0,
    ))
