"""ctypes loader for the native host-side core (nk_core.cpp).

Builds the shared library on first use (g++ -O3, for the generic target of
the host's architecture, so a library built on one machine loads on
another) into ``build/native/<hash of source and flags>/`` at the root of
the checkout, never next to the source; every entry point has a
pure-numpy fallback, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "nk_core.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                           "native")
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], "nk_core.so")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = _so_path()
            if not os.path.exists(so):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            I64 = ctypes.POINTER(ctypes.c_int64)
            F64 = ctypes.POINTER(ctypes.c_double)
            lib.canonicalize_coo.restype = ctypes.c_int64
            lib.canonicalize_coo.argtypes = [I64, I64, F64, ctypes.c_int64,
                                             ctypes.c_int64, I64, I64, F64]
            lib.route_entries.restype = None
            lib.route_entries.argtypes = [I64, I64, ctypes.c_int64, I64, I64, I64]
            I32 = ctypes.POINTER(ctypes.c_int32)
            lib.plan_entries.restype = None
            lib.plan_entries.argtypes = [I64, I64, ctypes.c_int64, I64, I64,
                                         ctypes.c_int64, I32, I32, I32, I64]
            lib.column_adjacency.restype = ctypes.c_int64
            lib.column_adjacency.argtypes = [I64, I64, ctypes.c_int64, I32,
                                             ctypes.c_int64, I64, I64,
                                             ctypes.c_int64]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def canonicalize_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     flat_len: int):
    """Canonical CSR from COO with emission-order duplicate summation.
    Returns (nzval, colind, rowptr) or None if the native lib is missing."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    nnz_in = len(vals)
    out_rowptr = np.zeros(flat_len + 1, dtype=np.int64)
    out_cols = np.empty(nnz_in, dtype=np.int64)
    out_vals = np.empty(nnz_in, dtype=np.float64)
    nnz = lib.canonicalize_coo(
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        _ptr(vals, ctypes.c_double), nnz_in, flat_len,
        _ptr(out_rowptr, ctypes.c_int64), _ptr(out_cols, ctypes.c_int64),
        _ptr(out_vals, ctypes.c_double))
    return out_vals[:nnz].copy(), out_cols[:nnz].copy(), out_rowptr


def plan_entries(rowptr: np.ndarray, colind: np.ndarray,
                 cell_node: np.ndarray, cell_elim: np.ndarray, nfronts: int):
    """Fused entry routing + per-front counting sort. Returns
    (ent_row, ent_col, ent_src, bounds) in int32/int64, or None if the
    native lib is missing."""
    lib = _load()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int64)
    cell_node = np.ascontiguousarray(cell_node, dtype=np.int64)
    cell_elim = np.ascontiguousarray(cell_elim, dtype=np.int64)
    nnz = len(colind)
    ent_row = np.empty(nnz, dtype=np.int32)
    ent_col = np.empty(nnz, dtype=np.int32)
    ent_src = np.empty(nnz, dtype=np.int32)
    bounds = np.empty(nfronts + 1, dtype=np.int64)
    lib.plan_entries(_ptr(rowptr, ctypes.c_int64),
                     _ptr(colind, ctypes.c_int64), len(rowptr) - 1,
                     _ptr(cell_node, ctypes.c_int64),
                     _ptr(cell_elim, ctypes.c_int64), nfronts,
                     _ptr(ent_row, ctypes.c_int32),
                     _ptr(ent_col, ctypes.c_int32),
                     _ptr(ent_src, ctypes.c_int32),
                     _ptr(bounds, ctypes.c_int64))
    return ent_row, ent_col, ent_src, bounds


def column_adjacency(rowptr: np.ndarray, colind: np.ndarray,
                     col_of_row: np.ndarray, ncols: int):
    """Directed column-adjacency pairs (mostly deduped — run the result
    through np.unique); None if the native lib is missing."""
    lib = _load()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int64)
    col_of_row = np.ascontiguousarray(col_of_row, dtype=np.int32)
    cap = max(64 * ncols, 1 << 20)
    while True:
        out_src = np.empty(cap, dtype=np.int64)
        out_dst = np.empty(cap, dtype=np.int64)
        n = lib.column_adjacency(
            _ptr(rowptr, ctypes.c_int64), _ptr(colind, ctypes.c_int64),
            len(rowptr) - 1, _ptr(col_of_row, ctypes.c_int32), ncols,
            _ptr(out_src, ctypes.c_int64), _ptr(out_dst, ctypes.c_int64),
            cap)
        if n >= 0:
            return out_src[:n].copy(), out_dst[:n].copy()
        cap *= 4


def route_entries(rowptr: np.ndarray, colind: np.ndarray,
                  cell_node: np.ndarray, cell_elim: np.ndarray):
    """Per-entry assembly-front routing; None if the native lib is missing."""
    lib = _load()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int64)
    cell_node = np.ascontiguousarray(cell_node, dtype=np.int64)
    cell_elim = np.ascontiguousarray(cell_elim, dtype=np.int64)
    out = np.empty(len(colind), dtype=np.int64)
    lib.route_entries(_ptr(rowptr, ctypes.c_int64), _ptr(colind, ctypes.c_int64),
                      len(rowptr) - 1, _ptr(cell_node, ctypes.c_int64),
                      _ptr(cell_elim, ctypes.c_int64), _ptr(out, ctypes.c_int64))
    return out
