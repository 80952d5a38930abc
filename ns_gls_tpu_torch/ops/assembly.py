"""Exact element matrices, operator diagonal, and dense global assembly,
derived from the *same* q-point physics as the matrix-free apply.

The element matrices come from forward-mode differentiation
(``torch.func.jacfwd``; the operator is linear, so the Jacobian of the
local apply *is* the element matrix).  The diagonal needs none of the
rest of them: entry (i, c) of a cell's diagonal is component c of the
local apply of basis function (i, c) at node i,

    sum_q S[q, i] jxw[q] v[q, c]
      + sum_(q, r) D[q, i, r] (g[q, c] . Jinv[q, r]) jxw[q],

where (v, g) is the q-point physics of (S[q, i] e_c, grad phi_i(x_q)
e_c), the value and gradient the evaluation gives that function.  So
the physics runs once a basis function, as under ``jacfwd``, but the
evaluation (a gather of the tables) and the integration (node i,
component c) are the diagonal's alone.  The numbers and the operations
are the element matrices', so in f32 on the CPU the diagonal is theirs
to the bit on the 2D elements; in 3D at Q2 the physics' contractions
pair the tables with all basis functions at once, and round otherwise
in about one q-point value in a hundred.

Replaces the reference's basis-vector tricks:
- ``MatrixFreeTools::compute_diagonal`` (``operator_ns.cc:195-225``)
- ``MatrixFreeTools::compute_matrix`` / ``initialize_system_matrix``
  (``operator_ns.cc:1303-1434``) used for the GMG coarse solve and the
  direct solver.

The element contributions are summed into the diagonal and the dense
matrix by the multiplicity-class sums of ``utils/segment.py``, each
target's contributions added one after the other in source order (the
order of a serial scatter-add) on every device and thread count: a
float32 ``index_put_(..., accumulate=True)`` with trailing dimensions
sums in a thread-dependent order on the CPU.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ns_gls_tpu_torch.ops.navier_stokes import (
    NavierStokesOperator,
    _apply_jinv,
    fe_evaluate,
    fe_integrate,
)
from ns_gls_tpu_torch.utils.segment import class_sum, target_sums
from ns_gls_tpu_torch.utils.timer import count, host_sync

_CHUNK = 2048
# numbers in the largest transient of a chunk of ``element_diagonals``
_DIAG_ELEMENTS = 1 << 25


def _sums(op, name: str, source: torch.Tensor, index=None):
    """The operator's ``target_sums`` tables of ``index(source)`` (of
    ``source`` itself by default), cached until ``source`` is replaced."""
    cache = op.__dict__.setdefault("_assembly_sums", {})
    hit = cache.get(name)
    if hit is None or hit[0] is not source:
        idx = source if index is None else index(source)
        hit = (source, target_sums(host_sync(idx.cpu).numpy(), op.device))
        cache[name] = hit
    return hit[1]


def _local_apply(op: NavierStokesOperator):
    """Single-cell linear apply: (u_loc, jinv, jxw, cq_cell) -> r_loc."""

    def f(u_loc, jinv, jxw, cq):
        val, grad = fe_evaluate(op.batch.S, op.batch.D, jinv, u_loc)
        if op.increment_form:
            val_res, grad_res = op.qpoint_increment(val, grad, cq)
        else:
            val_res, grad_res = op.qpoint_fixed_point(val, grad, cq,
                                                      residual=False)
        return fe_integrate(op.batch.S, op.batch.D, jinv, jxw, val_res,
                            grad_res)

    return f


def _cq_cell_tree(op: NavierStokesOperator) -> dict:
    """Per-cell linearization tables (leading axis n_c).  Fused-mode
    operators materialize them from the stored vectors."""
    s = op.state
    if op.fuse_tables:
        cq = op._fused_cq(op.batch, s)
        n_c = op.space.mesh.n_cells
        n_q = op.space.element.n_q
        d = op.dim
        if cq["u_old_grad"] is None:
            cq["u_old_grad"] = torch.zeros((n_c, n_q, d, d), dtype=op.dtype,
                                           device=op.device)
            cq["p_old_grad"] = torch.zeros((n_c, n_q, d), dtype=op.dtype,
                                           device=op.device)
        if op.cell_wise_stabilization:
            cq["delta1"] = s.delta1
            cq["delta2"] = s.delta2
        return cq
    return op._cq(s)


def _element_fn(op: NavierStokesOperator):
    """Batched (over cells) element matrix."""
    n_loc = op.space.element.n_loc
    C = op.n_comp
    f = _local_apply(op)

    def emat(jinv, jxw, cq):
        u0 = torch.zeros((n_loc, C), dtype=op.dtype, device=op.device)
        J = jacfwd(lambda u: f(u, jinv, jxw, cq))(u0)
        return J.reshape(n_loc * C, n_loc * C)

    cq_dims = {k: (None if k == "weight" else 0) for k in _cq_cell_tree(op)}
    return vmap(emat, in_dims=(0, 0, cq_dims))


def element_matrices(op: NavierStokesOperator):
    """Dense element matrices (n_c, n_loc*C, n_loc*C) in the flattened
    local dof order (i * C + c)."""
    fn = _element_fn(op)
    cq = _cq_cell_tree(op)
    b = op.batch
    n_c = op.space.mesh.n_cells
    parts = []
    for lo in range(0, n_c, _CHUNK):
        sl = slice(lo, min(lo + _CHUNK, n_c))
        cq_sl = {k: (v if k == "weight" else v[sl]) for k, v in cq.items()}
        parts.append(fn(b.jinv[sl], b.jxw[sl], cq_sl))
    return torch.cat(parts, dim=0)


def element_diagonals(op: NavierStokesOperator) -> torch.Tensor:
    """The element matrices' diagonals (n_c, n_loc, C), from the q-point
    physics of each basis function alone (the module docstring), in
    chunks of cells whose largest transient holds ``_DIAG_ELEMENTS``
    numbers."""
    b = op.batch
    cq = _cq_cell_tree(op)
    n_c, n_q = b.jxw.shape
    n_loc = b.S.shape[1]
    C, d = op.n_comp, op.dim
    T = n_loc * C
    chunk = max(1, _DIAG_ELEMENTS // (T * n_q * C * d))
    eye = torch.eye(C, dtype=op.dtype, device=op.device)
    # basis function t = i * C + c: val[t, q, c'] = S[q, i] delta(c, c')
    val1 = (b.S.T[:, None, :, None] * eye[None, :, None, :]).reshape(
        T, n_q, C)
    # ``fe_integrate``'s contractions, (n_loc, q) and (n_loc, (q, r))
    s_t = b.S.T[None]
    d_t = b.D.transpose(0, 1).reshape(1, n_loc, n_q * d)
    parts = []
    for lo in range(0, n_c, chunk):
        sl = slice(lo, min(lo + chunk, n_c))
        jinv, jxw = b.jinv[sl], b.jxw[sl]
        e = jxw.shape[0]
        # grad[e, t, q, c', x] = grad phi_i(x_q)[x] delta(c, c')
        g = _apply_jinv(b.D, jinv).transpose(1, 2)
        grad = (g[:, :, None, :, None, :]
                * eye[None, None, :, None, :, None]).reshape(
                    e, T, n_q, C, d)
        cq_sl = {k: (v if k == "weight" else v[sl].unsqueeze(1))
                 for k, v in cq.items()}
        val = val1.expand(e, T, n_q, C)
        if op.increment_form:
            val_res, grad_res = op.qpoint_increment(val, grad, cq_sl)
        else:
            val_res, grad_res = op.qpoint_fixed_point(val, grad, cq_sl,
                                                      residual=False)
        # component c of basis function (i, c)'s residual, weighted as
        # ``fe_integrate`` weights it: vr[e, i, q, c], gr[e, i, q, r, c]
        vr = val_res.reshape(e, n_loc, C, n_q, C).diagonal(dim1=2, dim2=4)
        vr = vr * jxw[:, None, :, None]
        gw = grad_res.reshape(e, n_loc, C, n_q, C, d).diagonal(
            dim1=2, dim2=4).movedim(-1, -2)
        gw = gw * jxw[:, None, :, None, None]
        gr = (gw.unsqueeze(-2) * jinv[:, None, :, None]).sum(dim=-1)
        gr = gr.transpose(-1, -2)
        # node i's C basis functions through the element matrices' own
        # (n_loc x K) (K x C) products; row i is the diagonal
        m = e * n_loc
        r = (torch.bmm(s_t.expand(m, -1, -1), vr.reshape(m, n_q, C))
             + torch.bmm(d_t.expand(m, -1, -1),
                         gr.reshape(m, n_q * d, C)))
        parts.append(torch.diagonal(r.reshape(e, n_loc, n_loc, C),
                                    dim1=1, dim2=2).transpose(1, 2))
    return torch.cat(parts, dim=0)


def compute_diagonal(op: NavierStokesOperator) -> torch.Tensor:
    """Diagonal of the (constrained) operator, shape (n_nodes, C).

    Constrained rows get 1.0.  (Approximation vs. deal.II's
    ``compute_diagonal``: contributions of constraint weights w_ri to
    unconstrained diagonal entries are dropped — exact for Dirichlet /
    pressure-pin constraints, approximate for slip/periodic rows; the
    Jacobi smoother tolerates this.)"""
    count("diagonal")
    d_loc = element_diagonals(op)
    diag = torch.zeros((op.n_nodes, op.n_comp), dtype=op.dtype,
                       device=op.device)
    ts = _sums(op, "diag", op.batch.cell_nodes)
    diag[ts.targets] = class_sum(ts.gather, d_loc.reshape(-1, op.n_comp),
                                   in_order=True)
    ca = op.constraints_homogeneous
    if ca.n:
        diag = diag.reshape(-1)
        # copies the number to the device and waits for the stream
        host_sync(diag.__setitem__, ca.rows, 1.0)
        diag = diag.reshape(op.n_nodes, op.n_comp)
    return diag


def compute_inverse_diagonal(op: NavierStokesOperator) -> torch.Tensor:
    """1/diag with the reference's safeguard (``operator_ns.cc:223-224``)."""
    d = compute_diagonal(op)
    return torch.where(d.abs() > 1e-10, 1.0 / d, torch.ones_like(d))


def assemble_dense(op: NavierStokesOperator) -> torch.Tensor:
    """Dense matrix of the *constrained* operator CᵀAC with identity on
    constrained rows/cols, in the operator's dtype on its device (small
    problems only: the GMG coarse level and the dense direct solver)."""
    C = op.n_comp
    n = op.n_nodes * C
    emat = element_matrices(op)
    gdofs = (op.batch.cell_nodes[:, :, None] * C
             + torch.arange(C, device=op.device)[None, None, :]
             ).reshape(emat.shape[0], -1)
    A = torch.zeros((n, n), dtype=op.dtype, device=op.device)
    # every update below is in place on the fresh matrix
    # the (row, column) pairs of the element matrices, flat in A
    ts = _sums(op, "dense", op.batch.cell_nodes,
               lambda _: gdofs[:, :, None] * n + gdofs[:, None, :])
    A.view(-1)[ts.targets] = class_sum(ts.gather, emat.reshape(-1),
                                       in_order=True)
    ca = op.constraints_homogeneous
    if ca.n:
        rows = ca.rows
        w = ca.weights.to(op.dtype)                            # (m, K)
        mk = w.numel()
        # the masters' current entries come first among their sources,
        # so each is updated in the order of a serial scatter-add
        tc = _sums(op, "masters", ca.cols, lambda c: torch.cat(
            [torch.unique(c), c.reshape(-1)]))
        # A C: move constrained columns onto their masters
        contrib = A[:, rows]                                   # (n, m)
        A[:, tc.targets] = class_sum(tc.gather, torch.cat(
            [A[:, tc.targets], (contrib[:, :, None] * w[None]).reshape(n, mk)],
            dim=1), dim=1, in_order=True)
        A[:, rows] = 0.0
        # Cᵀ A: same on the row side
        contrib_r = A[rows, :]                                 # (m, n)
        A[tc.targets, :] = class_sum(tc.gather, torch.cat(
            [A[tc.targets, :], (w[:, :, None] * contrib_r[:, None, :])
             .reshape(mk, n)]), in_order=True)
        A[rows, :] = 0.0
        A[rows, rows] = 1.0
    return A


def constrained_matrix(op: NavierStokesOperator, emat: torch.Tensor,
                       fmt: str = "csr"):
    """The operator's matrix on the host (scipy, f64) from its element
    matrices ``emat`` (n_c, n_loc*C, n_loc*C), constrained rows and
    columns zeroed with ones on their diagonal (the JAX package's
    Dirichlet-style condensation of its AMG and ILU); with the (row, col)
    of every element entry and the mask of unconstrained dofs.  ``fmt``:
    the sparse format the entries are summed into first, as each JAX
    caller does ("csr" its AMG, "csc" its ILU; the two sum duplicates in
    other orders, and SuperLU's incomplete factors follow the bits)."""
    import numpy as np
    import scipy.sparse as sp

    C = op.n_comp
    emat = host_sync(emat.detach().cpu).numpy().astype(np.float64)
    gdofs = (
        op.space.cell_nodes.astype(np.int64)[:, :, None] * C
        + np.arange(C)[None, None, :]
    ).reshape(len(emat), -1)
    nl = gdofs.shape[1]
    rows = np.repeat(gdofs, nl, axis=1).reshape(-1)
    cols = np.tile(gdofs, (1, nl)).reshape(-1)
    n = op.n_nodes * C
    A = sp.coo_matrix((emat.reshape(-1), (rows, cols)),
                      shape=(n, n)).asformat(fmt)
    ca = op.constraints_homogeneous
    mask = np.ones(n, dtype=bool)
    if ca.n:
        mask[host_sync(ca.rows.cpu).numpy()] = False
        D = sp.diags(mask.astype(np.float64))
        A = D @ A @ D + sp.diags((~mask).astype(np.float64))
    return A, rows, cols, mask
