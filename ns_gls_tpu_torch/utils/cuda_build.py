"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries go to
``build/torch_kernels/`` at the repository root (git-ignored), named by a
hash of the sources, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict = {}
# per library: {"seconds": build time or 0.0 when reused, "log": nvcc output}
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _sources(name: str) -> list[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, h) for h in headers
    ]


def library_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_libraries(names) -> dict:
    """Compile every named source that has no current library, one
    ``nvcc`` process per source, all started together.  Returns
    {name: library path}; raises with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {}
    for name in names:
        so = library_path(name)
        paths[name] = so
        if os.path.exists(so):
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        path = build_libraries([name])[name]
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
