"""ctypes bindings for the native meshkit library (native/meshkit.cc).

Loads (and, if needed, builds) ``libmeshkit.so``; every entry point has a
pure-numpy fallback so the framework runs without a compiler.  The native
layer covers the host-runtime hot loops the reference gets from
deal.II/p4est C++: unique-row topology extraction, transpose gather-map
construction, constraint chain resolution, point location.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = os.path.join(os.path.dirname(__file__), "..", "..", "native")
    so = os.path.join(root, "libmeshkit.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", root], capture_output=True,
                           timeout=120, check=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c64 = ctypes.c_int64

    lib.mk_unique_rows.restype = c64
    lib.mk_unique_rows.argtypes = [i64p, c64, c64, i64p]

    lib.mk_transpose_map.restype = None
    lib.mk_transpose_map.argtypes = [i32p, c64, c64, i64p, i64p]

    lib.mk_resolve_chains.restype = c64
    lib.mk_resolve_chains.argtypes = [
        i64p, c64, i64p, i64p, f64p, f64p, c64, i64p, i64p, f64p, f64p,
    ]

    lib.mk_locate_points_q1.restype = None
    lib.mk_locate_points_q1.argtypes = [
        f64p, c64, i64p, c64, ctypes.c_int, f64p, c64, ctypes.c_double,
        i64p, f64p,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _lib() is not None


def unique_rows(keys: np.ndarray):
    """ids (n,) by first occurrence + count of unique rows."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _lib()
    if lib is not None:
        out = np.empty(len(keys), dtype=np.int64)
        n_unique = lib.mk_unique_rows(keys, len(keys), keys.shape[1], out)
        return out, int(n_unique)
    # numpy fallback
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inv], len(first)


def transpose_map(cell_nodes: np.ndarray, n_nodes: int):
    """(counts (n_nodes,), order (n_slots,)): slots sorted by node."""
    flat = np.ascontiguousarray(cell_nodes.reshape(-1), dtype=np.int32)
    lib = _lib()
    if lib is not None:
        counts = np.empty(n_nodes, dtype=np.int64)
        order = np.empty(flat.size, dtype=np.int64)
        lib.mk_transpose_map(flat, flat.size, n_nodes, counts, order)
        return counts, order
    counts = np.bincount(flat, minlength=n_nodes).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    return counts, order


def locate_points_q1(verts, cells, points, tol=1e-9):
    """(cell ids (n_p,), ref coords (n_p, dim)); cell id -1 if not found."""
    lib = _lib()
    dim = verts.shape[1]
    if lib is None:
        return None  # caller falls back to the Python implementation
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    points = np.ascontiguousarray(np.atleast_2d(points), dtype=np.float64)
    out_cell = np.empty(len(points), dtype=np.int64)
    out_xi = np.empty((len(points), dim), dtype=np.float64)
    lib.mk_locate_points_q1(
        verts, len(verts), cells, len(cells), dim, points, len(points),
        tol, out_cell, out_xi,
    )
    return out_cell, out_xi
