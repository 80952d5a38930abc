"""Two-level MG transfers between nested uniformly-refined FE spaces.

Equivalent of deal.II ``MGTwoLevelTransfer`` +
``MGTransferGlobalCoarsening`` (reference ``main.cc:540-567``): transfers
are precomputed sparse gather maps —

- prolongation P: fine node <- one coarse cell's nodes with the embedding
  weights (coarse basis evaluated at the fine support point),
- restriction = Pᵀ (scatter-add),
- solution interpolation fine -> coarse ("interpolate_to_mg",
  ``main.cc:789-795``): coarse node <- fine basis evaluated at the coarse
  support point (NOT Pᵀ).

Both are row gathers / scatter-adds on tensors in a compact (rows, C)
layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.fem.element import embedding_matrix, tabulate_at
from ns_gls_tpu_torch.fem.space import FESpace
from ns_gls_tpu_torch.utils.segment import class_sum, fixed_scatter


class TwoLevelTransfer(NamedTuple):
    # prolongation: fine node <- coarse nodes
    p_cols: torch.Tensor   # (n_fine_nodes, n_loc) int64
    p_wts: torch.Tensor    # (n_fine_nodes, n_loc)
    # injection/interpolation: coarse node <- fine nodes
    i_cols: torch.Tensor   # (n_coarse_nodes, n_loc) int64
    i_wts: torch.Tensor    # (n_coarse_nodes, n_loc)

    @property
    def n_coarse(self) -> int:
        return self.i_cols.shape[0]

    @property
    def n_fine(self) -> int:
        return self.p_cols.shape[0]


def build_transfer(coarse: FESpace, fine: FESpace, dtype=torch.float32,
                   device: str | torch.device = "cpu") -> TwoLevelTransfer:
    """fine.mesh must be coarse.mesh.refine(flags) — uniform or adaptive.
    Uses fine.mesh.parent_cell/parent_child: refined parents transfer via
    the embedding, carried cells via identity."""
    dim = coarse.dim
    deg = coarse.degree
    n_children = 2**dim

    emb = embedding_matrix(deg, dim)  # (2^d, n_loc, n_loc)
    n_loc = emb.shape[1]
    eye = np.eye(n_loc)

    cn_c = coarse.cell_nodes  # (n_cc, n_loc)
    cn_f = fine.cell_nodes

    pc = fine.mesh.parent_child
    pp = fine.mesh.parent_cell
    if pc is None:  # uniform refinement without maps
        assert fine.mesh.n_cells == coarse.mesh.n_cells * n_children
        pp = np.repeat(np.arange(coarse.mesh.n_cells), n_children)
        pc = np.tile(np.arange(n_children), coarse.mesh.n_cells)

    # ---- prolongation map -------------------------------------------------
    p_cols = np.zeros((fine.n_nodes, n_loc), dtype=np.int32)
    p_wts = np.zeros((fine.n_nodes, n_loc), dtype=np.float64)
    for child in range(-1, n_children):
        sel = np.nonzero(pc == child)[0]
        if len(sel) == 0:
            continue
        rows = cn_f[sel]                # (n_sel, n_loc) fine nodes
        parents = cn_c[pp[sel]]         # (n_sel, n_loc) coarse nodes
        for i in range(n_loc):
            p_cols[rows[:, i]] = parents
            p_wts[rows[:, i]] = eye[i] if child < 0 else emb[child, i]

    # ---- injection map ----------------------------------------------------
    # coarse support point p lives in child c(p); fine local coords 2p-off
    sp = coarse.element.support_points  # (n_loc, dim)
    child_of = np.zeros(n_loc, dtype=np.int64)
    w_inj = np.zeros((n_loc, n_loc))
    for i in range(n_loc):
        p = sp[i]
        off = (p > 0.5).astype(np.float64)
        child_of[i] = int(sum(int(off[d]) << d for d in range(dim)))
        q = 2.0 * p - off
        S, _ = tabulate_at(deg, dim, q[None, :])
        w_inj[i] = S[0]

    # fine cell of (parent, child); -1 where the parent was carried
    fine_of = np.full((coarse.mesh.n_cells, n_children), -1, dtype=np.int64)
    refined = pc >= 0
    fine_of[pp[refined], pc[refined]] = np.nonzero(refined)[0]
    carried_fine = np.full(coarse.mesh.n_cells, -1, dtype=np.int64)
    carried_fine[pp[~refined]] = np.nonzero(~refined)[0]

    i_cols = np.zeros((coarse.n_nodes, n_loc), dtype=np.int32)
    i_wts = np.zeros((coarse.n_nodes, n_loc), dtype=np.float64)
    for i in range(n_loc):
        # refined parents: interpolate from the owning child
        sel = np.nonzero(fine_of[:, child_of[i]] >= 0)[0]
        if len(sel):
            fcells = fine_of[sel, child_of[i]]
            i_cols[cn_c[sel, i]] = cn_f[fcells]
            i_wts[cn_c[sel, i]] = w_inj[i]
        # carried parents: identity from the same cell
        sel = np.nonzero(carried_fine >= 0)[0]
        if len(sel):
            fcells = carried_fine[sel]
            i_cols[cn_c[sel, i]] = cn_f[fcells]
            i_wts[cn_c[sel, i]] = eye[i]

    return TwoLevelTransfer(
        p_cols=torch.as_tensor(p_cols.astype(np.int64), device=device),
        p_wts=torch.as_tensor(p_wts, dtype=dtype, device=device),
        i_cols=torch.as_tensor(i_cols.astype(np.int64), device=device),
        i_wts=torch.as_tensor(i_wts, dtype=dtype, device=device),
    )


def _row_gather_sum(cols, wts, u):
    """sum_k w[:, k] * u[cols[:, k], :], one ROW gather per local basis
    function, every intermediate in the compact (rows, C) layout."""
    n_loc = cols.shape[1]
    w = wts.to(u.dtype)
    acc = u[cols[:, 0]] * w[:, 0:1]
    for k in range(1, n_loc):
        acc = acc + u[cols[:, k]] * w[:, k: k + 1]
    return acc


def prolongate(t: TwoLevelTransfer, u_c: torch.Tensor) -> torch.Tensor:
    """(n_coarse, C) -> (n_fine, C)."""
    return _row_gather_sum(t.p_cols, t.p_wts, u_c)


def restrict(t: TwoLevelTransfer, r_f: torch.Tensor) -> torch.Tensor:
    """Pᵀ: (n_fine, C) -> (n_coarse, C) — one row scatter-add per local
    basis function, in the order of the JAX reference."""
    out = r_f.new_zeros((t.n_coarse, r_f.shape[1]))
    w = t.p_wts.to(r_f.dtype)
    if r_f.is_cuda:
        # fixed-order class sums (``index_add_`` on the card sums with
        # atomics in an order that changes from run to run)
        fs = fixed_scatter(t.p_cols, t.p_wts)
        src = (r_f[:, None, :] * w[:, :, None]).reshape(-1, r_f.shape[1])
        if fs.gather is not None:
            out[fs.targets] = class_sum(fs.gather, src)
        return out
    for k in range(t.p_cols.shape[1]):
        # in place on the fresh output
        out.index_add_(0, t.p_cols[:, k], r_f * w[:, k: k + 1])
    return out


def interpolate_to_coarse(t: TwoLevelTransfer, u_f: torch.Tensor) -> torch.Tensor:
    """Solution interpolation (pointwise), fine -> coarse."""
    return _row_gather_sum(t.i_cols, t.i_wts, u_f)
