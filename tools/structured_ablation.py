#!/usr/bin/env python3
"""What the 3D structured kernel's time is made of: the kernel beside
copies of itself with one part taken out, on the card.

    python3 tools/structured_ablation.py

Builds ``ns_gls_tpu_torch/csrc/structured.cu`` and three copies of it in
which ``structured3d_kernel``

    no_node_copies  does not copy the slabs' node planes,
    no_copies       copies neither the node planes nor the cell geometry,
    no_physics      replaces the q-point physics by a few FMAs of the
                    same inputs,

and times each (device time by ``torch.profiler``, twice, in turns) at the
channel's finest 3D level shape (128 x 32 x 32 cells of Q2, under
``brick_plan``) in the timing case of ``chip_smoke.py`` phase 9
(increment flavor, history, cell-wise delta).  The copies compute garbage
(their relative error to the plain version is printed beside them); only
their times mean anything.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NODE_COPIES = '''      for (StridedDigits<2> e({zn, NF}, tg, n_grp); e.valid(); e.next()) {
        const int zl = e.d[0], f = e.d[1];
        cp_async4(dst0 + (f * ZN + zl) * PL,
                  sField[f] +
                      (cg_index(P, nz, zl0 + zl / P, zl % P) * YN + t_src));
      }'''
GEOMETRY_COPIES = "    for (StridedDigits<2> e({xb * 9, zs}); e.valid(); e.next())"
PHYSICS = '''      gls_physics<3>(flavor, consider_dt != 0, need_dt_old, sc, uvel, ug,
                     uv[3], pg, us, gus, gps, dto, d1, d2, vr, gr);'''
FEW_FMAS = '''#pragma unroll
      for (int c = 0; c < 4; ++c) {
        vr[c] = uv[c] * d1 + lv[c] * d2;
#pragma unroll
        for (int x = 0; x < 3; ++x)
          gr[c][x] = (c < 3 ? ug[c][x] + gus[c][x] : pg[x] + gps[x]) + dto[x];
      }'''


def variants(src: str) -> dict:
    """{name: source} of the kernel and its ablated copies."""
    for piece in (NODE_COPIES, GEOMETRY_COPIES, PHYSICS):
        if src.count(piece) != 1:
            raise RuntimeError("csrc/structured.cu no longer has the parts "
                               "this tool takes out")
    no_node = src.replace(NODE_COPIES, "      (void)dst0;")
    # the geometry copies: from the first of their loops to the end of the
    # stage lambda
    i0 = no_node.index(GEOMETRY_COPIES)
    i0 = no_node.rindex("    float* gJ = sGeo", 0, i0)
    i1 = no_node.index("  };\n", i0)
    return {"kernel": src, "no_node_copies": no_node,
            "no_copies": no_node[:i0] + no_node[i1:],
            "no_physics": src.replace(PHYSICS, FEW_FMAS)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("structured_ablation: no CUDA device", file=sys.stderr)
        return 2
    import structured_levels as sl
    from structured_stage_clocks import finest_channel_tables

    from ns_gls_tpu_torch.ops import structured as st
    from ns_gls_tpu_torch.utils import cuda_build as cb
    from ns_gls_tpu_torch.utils.timer import device_time_us

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with open(os.path.join(cb.CSRC, "structured.cu")) as f:
        srcs = variants(f.read())
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    fns = {}
    for name, src in srcs.items():
        cu = os.path.join(cb.BUILD_DIR, f"structured_ablation_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        fns[name] = sl.build_variant(cu)

    T = finest_channel_tables()
    rng = np.random.default_rng(1)
    shp = st.lattice_shape(T.P, T.cell_shape)
    u, ul, vo = (torch.as_tensor(rng.standard_normal((lead,) + shp),
                                 dtype=torch.float32, device="cuda")
                 for lead in (4, 4, 3))
    case = (T, sl.SC, u, ul, vo, "increment", True, True)
    ref = st.structured_sweep_plain(*case)
    rec = dict(card=card, cells=T.cell_shape,
               plan=tuple(st.brick_plan(T.P, T.cell_shape)))
    for rnd in range(2):
        for name, fn in fns.items():
            out = sl.variant_launch(fn, *case)
            err = sl.rel_err(st.fold_bricks(T, *out), ref)
            us = device_time_us(lambda: sl.variant_launch(fn, *case),
                                "structured3d_kernel")
            rec[f"{name}_us_{rnd}"] = us
            rec[f"{name}_max_rel_err"] = err
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
