#!/usr/bin/env python3
"""Where the 3D structured kernels' time goes, stage by stage, on the card.

    python3 tools/structured_stage_clocks.py [FILE.cu]
    python3 tools/structured_stage_clocks.py --batched [--degrees 1,2,...]

``structured3d_kernel`` (the first form): builds a copy of ``ns_gls_tpu_torch/csrc/structured.cu`` (or of FILE, another
revision of it) in which thread 0
of every block of ``structured3d_kernel`` reads ``clock64()`` after each
barrier of the slab loop (and after one more barrier behind the last
stage, I1), sums the cycles per stage over all blocks, and runs it once at
the channel's finest 3D level shape (128 x 32 x 32 cells of Q2, under
``brick_plan``) in the timing case of ``chip_smoke.py`` phase 9
(increment flavor, history), with q-wise and with cell-wise delta.
Prints each stage's share of the summed cycles:

    copy the next slab's copies issued
    top  this slab's copies awaited, the barrier
    E1   along z          E2  along x          E3a max |u*|^2 (cell-wise)
    E3b  along y and the physics               I3  along y
    I2   along x          I1  along z and the output writes

The extra barrier makes the instrumented kernel a little slower than the
real one; the shares, not the cycles, are the result.

``structured3d_batched_kernel`` (``--batched``): builds
``csrc/structured.cu`` twice with its own stage clocks on
(``SB_STAGE_CLOCKS``: thread 0 of every block reads ``clock64()`` after
each stage's barrier, one more barrier behind the output writes), once
with every contraction stage a product on the f64 tensor cores
(``SB_FMA_MASK=0``, what the kernel runs) and once with every one on f32
FMAs, one thread a row (``SB_FMA_MASK=0x3f``).  Each build is held to the
plain version (1e-5) and run under ``batched_plan`` on 16^3 cells at
every degree of ``--degrees`` (default 1-6) and on the channel's finest
level (128 x 32 x 32 cells of Q2), increment flavor with the history,
q-wise and cell-wise delta.  Prints, per case and build, the summed
cycles of each stage

    copy  the next slab's copies issued   top  copies awaited, the barrier
    E1    along z      E2  along x        E3   along y
    E3a   max |u*|^2 (cell-wise)          phys the q-point physics
    I3    back along y I2  back along x   I1   back along z
    out   the output writes (z carry)

and, per stage, the FMA build's cycles over the tensor-core build's
(above 1: the tensor cores are faster there).  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SC = dict(weight=140.0, stau=140.0, nu=0.0, c1=2.0, c2=1.0)
STAGES = ("copy", "top", "E1", "E2", "E3a", "E3b", "I3", "I2", "I1")
MARK = ("    if (threadIdx.x == 0) {{ long long t1 = clock64(); "
        "st[{k}] += t1 - t0; t0 = t1; }}")


def instrumented_source(src: str) -> str:
    """``structured.cu`` with a cycle count per stage of the 3D kernel's
    slab loop."""
    start = src.index("structured3d_kernel(const float* __restrict__ u")
    end = src.index("// structured3d_batched_kernel<P>:")
    end = src.rindex("// ====", 0, end)
    head, src, tail = src[:start], src[start:end], src[end:]
    out, k, in_loop = [], 0, False
    for line in src.split("\n"):
        if "cp_async_wait<1>();" in line and in_loop and k == 0:
            out.append(MARK.format(k=k))
            k += 1
        if "// the next iteration's barrier orders" in line:
            out += ["    __syncthreads();", MARK.format(k=k)]
            k += 1
        out.append(line)
        if "for (int s = 0; s < n_slabs; ++s) {" in line:
            in_loop = True
            continue
        if in_loop and k < len(STAGES) and line.strip() == "__syncthreads();":
            out.append(MARK.format(k=k))
            k += 1
    if k != len(STAGES):
        raise RuntimeError(f"found {k} stage barriers, want {len(STAGES)}: "
                           "csrc/structured.cu no longer has the stages "
                           "this tool knows")
    s = "\n".join(out)
    s = s.replace(
        "  const int n_slabs = (ze - lo + ZS - 1) / ZS;",
        "  const int n_slabs = (ze - lo + ZS - 1) / ZS;\n"
        "  long long st[9] = {0};\n  long long t0 = clock64();", 1)
    body = s.rstrip()
    assert body.endswith("}")
    s = (body[:-1] + "  if (threadIdx.x == 0)\n    for (int q = 0; q < 9; ++q)"
         "\n      atomicAdd(&g_stage[q], (unsigned long long)st[q]);\n}\n\n"
         + tail)
    return head.replace("namespace {\n", (
        "__device__ unsigned long long g_stage[9];\n"
        "extern \"C\" int stage_read(unsigned long long* h) {\n"
        "  return (int)cudaMemcpyFromSymbol(h, g_stage, sizeof(g_stage));\n}\n"
        "extern \"C\" int stage_zero() {\n  unsigned long long z[9] = {0};\n"
        "  return (int)cudaMemcpyToSymbol(g_stage, z, sizeof(z));\n}\n"
        "namespace {\n"), 1) + s


def finest_channel_tables():
    """The tables of the channel's finest 3D level: ``input/channel.json``
    with dim 3, degree 2, refinement 3 (its mesh, 4 x 1 x 1 cells refined
    five times)."""
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.models.channel import SimulationChannel
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    space = FESpace(SimulationChannel(3).create_mesh(3), 2)
    ca = AffineConstraints(space.n_nodes, 4).close(torch.float32, "cuda")
    ti = BDFIntegrator(1)
    ti.update_dt(0.1)
    op = NavierStokesOperator(space, ca, ca, nu=0.0, c_1=2.0, c_2=1.0,
                              time_integrator=ti, dtype=torch.float32,
                              device="cuda")
    return op._fast.tables


BATCHED_STAGES = ("copy", "top", "E1", "E2", "E3", "E3a", "phys", "I3",
                  "I2", "I1", "out")
# the contraction stages' bits in SB_FMA_MASK: all of them
ALL_FMA = 0x3F


def build_batched(mask: int):
    """``csrc/structured.cu`` with the batched kernel's stage clocks on and
    the stages of ``mask`` on FMAs; returns the ctypes library."""
    from ns_gls_tpu_torch.utils import cuda_build as cb

    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    so = os.path.join(cb.BUILD_DIR, f"libstructured_sb_clocks_{mask:x}.so")
    out = subprocess.run(
        [cb._nvcc(), *cb.NVCC_FLAGS, "-DSB_STAGE_CLOCKS",
         f"-DSB_FMA_MASK={mask}", "-o", so,
         os.path.join(cb.CSRC, "structured.cu")],
        capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    for line in (out.stdout + out.stderr).splitlines():
        if "batched" in line and ("registers" in line or "spill" in line):
            print(f"mask {mask:#x}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(so)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.structured3d_batched_launch
    fn.argtypes = [vp] * 10 + [ci] * 8 + [cf] * 5 + [ci] * 3 + [vp]
    fn.restype = ci
    return lib


def main_batched(degrees, card) -> int:
    import numpy as np
    import torch

    import bench_gpu
    from ns_gls_tpu_torch.ops import structured as st

    n_stages = len(BATCHED_STAGES)
    libs = {mask: build_batched(mask) for mask in (0, ALL_FMA)}
    cases = [(f"16^3 cells P={P}", bench_gpu.build(3, 4, P)[0]._fast.tables)
             for P in degrees]
    if 2 in degrees:
        cases.append(("channel 128 x 32 x 32 P=2", finest_channel_tables()))
    for label, T in cases:
        P = T.P
        nx, ny, nz = T.cell_shape
        plan = st.batched_plan(P, T.cell_shape)
        shp = st.lattice_shape(P, T.cell_shape)
        rng = np.random.default_rng(1)

        def lattice(lead):
            return torch.as_tensor(rng.standard_normal((lead,) + shp),
                                   dtype=torch.float32, device="cuda")

        u, ul, vo = lattice(4), lattice(4), lattice(3)
        for cw in (False, True):
            args = (T, SC, u, ul, vo, "increment", True, cw)
            ref = st.structured_sweep_plain(*args)
            mc = {}
            for mask, lib in libs.items():
                tiles = torch.empty((4, shp[0], ny, P + 1, shp[2]),
                                    dtype=torch.float32, device="cuda")
                seams = torch.empty((4, shp[0], ny, P + 1, plan.nbx),
                                    dtype=torch.float32, device="cuda")
                lib.stage_zero()
                err = lib.structured3d_batched_launch(
                    *(t.data_ptr() for t in (u, ul, vo, T.jinv, T.jxw, T.h,
                                             T.S1, T.D1, tiles, seams)),
                    P, T.NQ, nx, ny, nz, st.FLAVORS.index("increment"), 1,
                    int(cw), *(SC[k] for k in ("weight", "stau", "nu", "c1",
                                               "c2")),
                    plan.xb, plan.zs, plan.nzb,
                    torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"instrumented launch failed: {err}")
                out = st.fold_bricks(T, tiles, seams, plan.xb)
                rel = float((out - ref).abs().max() / ref.abs().max())
                if not rel <= 1e-5:
                    raise AssertionError(f"{label} mask {mask:#x}: rel err "
                                         f"{rel:.3e}")
                cycles = (ctypes.c_ulonglong * n_stages)()
                lib.stage_read(cycles)
                mc[mask] = [c / 1e6 for c in cycles]
                total = sum(mc[mask])
                print(json.dumps(dict(
                    card=card, case=label, cells=T.cell_shape,
                    plan=tuple(plan), cell_wise=cw,
                    build="fma" if mask else "tensor cores",
                    max_rel_err=rel, mcycles=total,
                    stage_mcycles={n: round(c, 4) for n, c in
                                   zip(BATCHED_STAGES, mc[mask])},
                    shares={n: round(100.0 * c / total, 1) for n, c in
                            zip(BATCHED_STAGES, mc[mask])})), flush=True)
            print(json.dumps(dict(
                card=card, case=label, cell_wise=cw,
                fma_over_tensor_cores={
                    n: round(f / t, 3) for n, f, t in
                    zip(BATCHED_STAGES, mc[ALL_FMA], mc[0])
                    if n in ("E1", "E2", "E3", "I3", "I2", "I1")})),
                flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("structured_stage_clocks: no CUDA device", file=sys.stderr)
        return 2
    if "--batched" in sys.argv[1:]:
        degrees = [1, 2, 3, 4, 5, 6]
        if "--degrees" in sys.argv:
            degrees = [int(x) for x in
                       sys.argv[sys.argv.index("--degrees") + 1].split(",")]
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        return main_batched(degrees, card)
    from ns_gls_tpu_torch.ops import structured as st
    from ns_gls_tpu_torch.utils import cuda_build as cb

    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        cb.CSRC, "structured.cu")
    with open(path) as f:
        src = instrumented_source(f.read())
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    cu = os.path.join(cb.BUILD_DIR, "structured_stage_clocks.cu")
    so = os.path.join(cb.BUILD_DIR, "libstructured_stage_clocks.so")
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-I", cb.CSRC, "-o",
                          so, cu], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.structured3d_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 10 + [ci] * 8 + [cf] * 5 + [ci] * 3 + [vp]
    fn.restype = ci

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    T = finest_channel_tables()
    P = T.P
    nx, ny, nz = T.cell_shape
    plan = st.brick_plan(P, T.cell_shape)
    shp = st.lattice_shape(P, T.cell_shape)
    rng = np.random.default_rng(1)

    def lattice(lead):
        return torch.as_tensor(rng.standard_normal((lead,) + shp),
                               dtype=torch.float32, device="cuda")

    u, ul, vo = lattice(4), lattice(4), lattice(3)
    tiles = torch.empty((4, shp[0], ny, P + 1, shp[2]), dtype=torch.float32,
                        device="cuda")
    seams = torch.empty((4, shp[0], ny, P + 1, plan.nbx),
                        dtype=torch.float32, device="cuda")
    for cw in (False, True):
        lib.stage_zero()
        err = fn(*(t.data_ptr() for t in (u, ul, vo, T.jinv, T.jxw, T.h,
                                          T.S1, T.D1, tiles, seams)),
                 P, T.NQ, nx, ny, nz, st.FLAVORS.index("increment"), 1,
                 int(cw), *(SC[k] for k in ("weight", "stau", "nu", "c1",
                                            "c2")),
                 plan.xb, plan.zs, plan.nzb,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"instrumented launch failed: {err}")
        cycles = (ctypes.c_ulonglong * 9)()
        lib.stage_read(cycles)
        total = sum(cycles)
        print(json.dumps(dict(
            card=card, cells=T.cell_shape, plan=tuple(plan), cell_wise=cw,
            mcycles=total / 1e6,
            shares={name: round(100.0 * c / total, 1)
                    for name, c in zip(STAGES, cycles)
                    if cw or name != "E3a"})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
