"""Plain GLS-stabilized Navier-Stokes cell terms over hexahedral cells.

The reference that ``correct`` compares the program with.  It is written
from the weak form (Galerkin, SUPG, PSPG and grad-div terms, the
reference's ``operator_ns.cc`` ``do_vmult_cell``) in plain PyTorch:
gather a block of cells, evaluate values and gradients at the Gauss
points, form the q-point fluxes, integrate them back and add them into
the node vector.  It runs in whatever dtype its inputs have, in blocks of
cells so that it fits beside nothing else on the card.  It imports
nothing of the program.
"""

from __future__ import annotations

import torch


def evaluate(S, D, jinv, u_loc):
    """u_loc (n, loc, C) -> values (n, q, C), gradients (n, q, C, d)."""
    val = torch.einsum("qi,nic->nqc", S, u_loc)
    ref = torch.einsum("qir,nic->nqcr", D, u_loc)
    return val, torch.einsum("nqcr,nqrx->nqcx", ref, jinv)


def integrate(S, D, jinv, jxw, val_res, grad_res):
    """The adjoint of :func:`evaluate` with the quadrature weights."""
    vr = val_res * jxw[..., None]
    gr = torch.einsum("nqcx,nqrx->nqcr", grad_res * jxw[..., None, None],
                      jinv)
    return (torch.einsum("qi,nqc->nic", S, vr)
            + torch.einsum("qir,nqcr->nic", D, gr))


def fluxes(val, grad, u_star, weight, dt_old, delta1, delta2, nu, pspg):
    """q-point fluxes of the GLS form at the linearization point u_star:
    ``(w, (u_t + (grad u) u*)) + nu (grad w, grad u + grad u^T) - (div w, p)
    + (q, div u) + delta2 (div w, div u) + delta1 ((grad w) u* + grad q,
    r)`` with the strong residual ``r = [u_t] + grad p + (grad u) u*``;
    ``u_t = weight u + dt_old``, and ``pspg`` says whether u_t enters r."""
    d = val.shape[-1] - 1
    u, p = val[..., :d], val[..., d]
    gu, gp = grad[..., :d, :], grad[..., d, :]
    u_t = weight * u + dt_old
    div = torch.diagonal(gu, dim1=-2, dim2=-1).sum(-1)
    conv = torch.einsum("...ab,...b->...a", gu, u_star)
    strong = delta1[..., None] * ((u_t if pspg else 0.0) + gp + conv)
    eye = torch.eye(d, dtype=val.dtype, device=val.device)
    grad_u = (nu * (gu + gu.transpose(-1, -2))
              + (delta2 * div - p)[..., None, None] * eye
              + strong[..., :, None] * u_star[..., None, :])
    val_res = torch.cat([u_t + conv, div[..., None]], dim=-1)
    grad_res = torch.cat([grad_u, strong[..., None, :]], dim=-2)
    return val_res, grad_res


def delta_qwise(u_star, h, stau, nu):
    """delta_1, delta_2 at every q-point; h (n,) is the cell's
    measure-based size over the degree."""
    h = h[:, None]
    u2 = 1e-12 + (u_star ** 2).sum(-1)
    d1 = 1.0 / torch.sqrt(stau ** 2 + 4.0 * u2 / h ** 2
                          + 9.0 * (4.0 * nu / h ** 2) ** 2)
    return d1, torch.sqrt(u2) * h * 0.5


def delta_cellwise(u_star, h, stau, nu, c1, c2):
    """delta_1, delta_2 once a cell, from the largest |u*| at its
    q-points; h (n,) is the cell's smallest vertex distance."""
    u_max = torch.sqrt((u_star ** 2).sum(-1).amax(dim=1, keepdim=True))
    h = h[:, None]
    visc = nu >= h
    d1 = torch.where(visc, c1 * h * h,
                     c1 / torch.sqrt(stau ** 2 + u_max ** 2 / h ** 2))
    d2 = torch.where(visc, c2 * h * h, c2 * h)
    return d1, d2


def sweep(u, u_lin, vec_old, cells, S, D, geometry, params, block=8192):
    """Integrated GLS form over every cell, added into the node vector.

    ``u``: the vector the form is linear in, (n_nodes, C); ``u_lin``: the
    linearization point (the same tensor for a residual); ``vec_old``:
    the weighted BDF history, or None.  ``cells``: (n_c, loc) node ids;
    ``geometry(lo, hi)`` gives the block's (jinv (n, q, d, d), jxw (n, q),
    h (n,)).  ``params``: nu, c1, c2, weight, stau, cell_wise, pspg."""
    out = torch.zeros_like(u)
    d = u.shape[1] - 1
    for lo in range(0, cells.shape[0], block):
        hi = min(lo + block, cells.shape[0])
        idx = cells[lo:hi]
        jinv, jxw, h = geometry(lo, hi)
        val, grad = evaluate(S, D, jinv, u[idx])
        lval, _ = evaluate(S, D, jinv, u_lin[idx])
        u_star = lval[..., :d]
        dt_old = 0.0
        if vec_old is not None:
            dt_old = torch.einsum("qi,nic->nqc", S, vec_old[idx][..., :d])
        if params["cell_wise"]:
            d1, d2 = delta_cellwise(u_star, h, params["stau"], params["nu"],
                                    params["c1"], params["c2"])
            d1 = d1.expand(-1, S.shape[0])
            d2 = d2.expand(-1, S.shape[0])
        else:
            d1, d2 = delta_qwise(u_star, h, params["stau"], params["nu"])
        vr, gr = fluxes(val, grad, u_star, params["weight"], dt_old, d1, d2,
                        params["nu"], params["pspg"])
        r_loc = integrate(S, D, jinv, jxw, vr, gr)
        out.index_add_(0, idx.reshape(-1), r_loc.reshape(-1, u.shape[1]))
    return out
