"""GLS q-point physics on component lists, shared by the fused sweeps.

The q-point algebra of the fixed-point / residual and Newton-increment
flavors (mirrors ``qpoint_fixed_point`` / ``qpoint_increment`` of
``ops/navier_stokes.py``, which mirror ``operator_ns.cc:949-1182``) and the
stabilization parameters delta_1/delta_2 (``compute_penalty_parameters``,
``operator_ns.cc:357-420``).  Every argument is a list of tensors of one
common shape (one entry per component / direction), so the same code
runs on whole patch tiles in the plain version of the patch-2D sweep.
The CUDA kernels inline the same algebra from ``csrc/gls_qpoint.cuh``.
"""

from __future__ import annotations

import torch


def _physics(d, flavor, sc, u_val, u_grad, p_val, p_grad,
             u_star, gus, gps, dt_old, d1, d2, consider_dt):
    w = sc["weight"]
    nu = sc["nu"]

    if flavor in ("fixed", "residual"):
        residual = flavor == "residual"
        u_dt = [w * u_val[a] for a in range(d)]
        if residual and dt_old is not None:
            u_dt = [u_dt[a] + dt_old[a] for a in range(d)]
        div = sum(u_grad[a][a] for a in range(d))
        sgb = [sum(u_grad[a][b] * u_star[b] for b in range(d))
               for a in range(d)]
        val_res_u = [u_dt[a] + sgb[a] for a in range(d)]
        pspg = u_dt if consider_dt else [0.0 * u_dt[a] for a in range(d)]
        res0 = [d1 * (pspg[a] + p_grad[a] + sgb[a]) for a in range(d)]
        grad_res_u = [
            [
                nu * (u_grad[a][x] + u_grad[x][a])
                + res0[a] * u_star[x]
                + ((d2 * div - p_val) if a == x else 0.0)
                for x in range(d)
            ]
            for a in range(d)
        ]
        return val_res_u + [div], grad_res_u + [res0]

    # Newton increment flavor
    u_dt = [w * u_val[a] for a in range(d)]
    div = sum(u_grad[a][a] for a in range(d))
    sgu = [sum(u_grad[a][b] * u_star[b] for b in range(d)) for a in range(d)]
    ugs = [sum(gus[a][b] * u_val[b] for b in range(d)) for a in range(d)]
    sgs = [sum(gus[a][b] * u_star[b] for b in range(d)) for a in range(d)]
    val_res_u = [u_dt[a] + sgu[a] + ugs[a] for a in range(d)]
    if consider_dt:
        pspg0 = u_dt
        pspg1 = [w * u_star[a] + dt_old[a] for a in range(d)]
    else:
        pspg0 = [0.0 * u_dt[a] for a in range(d)]
        pspg1 = pspg0
    res0 = [d1 * (pspg0[a] + p_grad[a] + sgu[a] + ugs[a]) for a in range(d)]
    res1 = [d1 * (pspg1[a] + gps[a] + sgs[a]) for a in range(d)]
    grad_res_u = [
        [
            nu * (u_grad[a][x] + u_grad[x][a])
            + res0[a] * u_star[x]
            + res1[a] * u_val[x]
            + ((d2 * div - p_val) if a == x else 0.0)
            for x in range(d)
        ]
        for a in range(d)
    ]
    return val_res_u + [div], grad_res_u + [res0]


def _delta(sc, h1, hq, usq_max, usq_q, cell_wise):
    """delta_1/delta_2: cell-wise (from the cell's max |u*|^2, with the
    viscous switch nu >= h) or per q-point."""
    stau = sc["stau"]
    nu = sc["nu"]
    c1 = sc["c1"]
    c2 = sc["c2"]
    if cell_wise:
        d1_adv = c1 * torch.rsqrt(stau * stau + usq_max / (h1 * h1))
        visc = nu >= h1
        d1 = torch.where(visc, c1 * h1 * h1, d1_adv)
        d2 = torch.where(visc, c2 * h1 * h1, c2 * h1)
        return d1, d2
    u2 = 1e-12 + usq_q
    d1 = torch.rsqrt(stau * stau + 4.0 * u2 / (hq * hq)
                     + 9.0 * (4.0 * nu / (hq * hq)) ** 2)
    d2 = torch.sqrt(u2) * hq * 0.5
    return d1, d2
