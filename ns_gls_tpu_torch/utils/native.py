"""ctypes bindings for the native meshkit library (native/meshkit.cc).

The port builds its own copy of the library, ``libmeshkit-<hash>.so`` in
``build/torch_kernels/`` (git-ignored; the hash covers the source, the
flags and the compiler), at first use.  The build holds an exclusive
``fcntl`` lock on a lock file in that directory and links to a temporary
name that is renamed into place, so processes that start together wait
for one build and never load a partial file; the JAX package's own
``native/libmeshkit.so`` is never written here.  Every entry point has a
pure-numpy fallback, taken only where no C++ compiler is found; a build
or load that fails where one is found raises.  The native layer covers
the host-runtime hot loops the reference gets from deal.II/p4est C++:
unique-row topology extraction, transpose gather-map construction,
constraint chain resolution, point location.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "meshkit.cc")
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
# the flags of native/Makefile
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_LIB = None


def _compiler():
    for name in ("c++", "g++", "clang++"):
        path = shutil.which(name)
        if path is not None:
            return path
    return None


def build_library(build_dir: str = BUILD_DIR):
    """Path of the port's meshkit library in ``build_dir``, compiled first
    if it is not there; None where no C++ compiler is found.  Raises with
    the compiler's output when the build fails."""
    cxx = _compiler()
    if cxx is None:
        return None
    h = hashlib.sha1(" ".join([cxx, *CXX_FLAGS]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    so = os.path.join(build_dir, f"libmeshkit-{h.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "libmeshkit.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when closed
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                 capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"building {so} failed:\n{res.stdout}"
                                   f"{res.stderr}")
            os.replace(tmp, so)
    return so


def load_library(build_dir: str = BUILD_DIR):
    """The ctypes handle of the library :func:`build_library` gives, its
    entry points typed; None where no C++ compiler is found."""
    so = build_library(build_dir)
    if so is None:
        return None
    lib = ctypes.CDLL(so)

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
    return lib


def _lib():
    """The loaded library, or None where no C++ compiler is found (the
    numpy fallbacks); only a loaded library is kept."""
    global _LIB
    if _LIB is None:
        _LIB = load_library()
    return _LIB


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
