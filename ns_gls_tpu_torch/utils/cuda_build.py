"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries go to
``build/torch_kernels/`` at the repository root (git-ignored), named by a
hash of the sources, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time.

The fused sweeps are templates over the degree P.  Their library holds
the instances of ``KERNEL_DEGREES``; any other degree gets a library of its
own, compiled from the same source with ``-DNS_KERNEL_DEGREE=P``
(``csrc/sweep_common.cuh`` ``NS_FOR_DEGREES``) into
``lib<name>-p<P>-<hash>.so`` the first time that degree is asked for
(:func:`degree_library`), so only the users of a degree pay its build.
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

# the degrees built into every fused sweep's common library (six is where
# deal.II's precompiled matrix-free evaluators stop by default,
# FE_EVAL_FACTORY_DEGREE_MAX); any other degree builds a library of its own
KERNEL_DEGREES = (1, 2, 3, 4, 5, 6)

_loaded: dict = {}
# per library key (name, or name-p<P>): {"seconds": build time or 0.0 when
# reused, "log": nvcc output}
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


def _split(key) -> tuple:
    """A library key -> (source name, degree or None): ``"structured"``
    or ``("structured", 7)``, the library of that degree alone."""
    return (key, None) if isinstance(key, str) else (key[0], int(key[1]))


def library_key(name: str, degree: int | None = None) -> str:
    return name if degree is None else f"{name}-p{degree}"


def _flags(degree: int | None) -> list:
    return NVCC_FLAGS + ([] if degree is None
                         else [f"-DNS_KERNEL_DEGREE={degree}"])


def library_path(name: str, degree: int | None = None) -> str:
    h = hashlib.sha1(" ".join(_flags(degree)).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{library_key(name, degree)}-"
                                   f"{h.hexdigest()[:12]}.so")


def build_libraries(keys) -> dict:
    """Compile every library of ``keys`` (source names, or (name, degree)
    pairs for a library of one degree) that has no current build, one
    ``nvcc`` process per library, all started together.  Returns {library
    key: path}; raises with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {}
    for key in keys:
        name, degree = _split(key)
        lk = library_key(name, degree)
        so = library_path(name, degree)
        paths[lk] = so
        if os.path.exists(so):
            build_info.setdefault(lk, {"seconds": 0.0, "log": ""})
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(degree), "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[lk] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, time.perf_counter())
    failed = []
    for lk, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        build_info[lk] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{lk}:\n{log}")
            continue
        os.replace(tmp, paths[lk])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str, degree: int | None = None) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu`` (with ``degree``: its
    library of that degree alone), built at first use."""
    lk = library_key(name, degree)
    if lk not in _loaded:
        key = name if degree is None else (name, degree)
        _loaded[lk] = ctypes.CDLL(build_libraries([key])[lk])
    return _loaded[lk]


def degree_library(name: str, P: int) -> ctypes.CDLL:
    """The library of a fused sweep that holds its degree-P instance: the
    common one for ``KERNEL_DEGREES``, else the one built for P alone."""
    return load_library(name, None if P in KERNEL_DEGREES else P)
