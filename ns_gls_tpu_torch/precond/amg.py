"""Algebraic multigrid preconditioner (aggregation-based).

Port of ``ns_gls_tpu/precond/amg.py`` (the JAX package's stand-in for the
reference's Trilinos ML-AMG, ``preconditioner.cc:38-77``; coarse-solver
zoo ``multigrid.cc:372-433``):

- first setup on the host (scipy): assemble the constrained sparse
  matrix from the element matrices, build node aggregates on the
  strength-of-connection graph, P = piecewise constant per aggregate and
  component (the "constant modes" near-nullspace), Galerkin coarse
  matrices P^T A P, recurse until the level is small or coarsening
  stalls; the coarsest level is a dense LU in f64,
- later setups keep the aggregates and refresh every matrix value on the
  device from new element matrices (the structure-frozen refresh: fixed
  slot maps from element entries to the level matrices),
- apply on the device: a V-cycle with damped Jacobi smoothing (Gershgorin
  damping) on padded-ELL level matrices; level 0 applies the operator
  itself instead of its matrix (the unaggregated Q2 level would gather
  hundreds of entries per row, and the linearization stays current),
- "amg smoother": "ilu" (the reference's ML-AMG smooths with Ifpack ILU,
  ``preconditioner.cc:49-77``): every setup also assembles each stored
  level's matrix on the host, factors it with SuperLU's ILU (scipy) and
  takes the factors to the device as padded-ELL strict triangles, the
  inverted U diagonal and the two permutations; a smoothing step applies
  them with ``ILU_SWEEPS`` Jacobi-style sweeps a triangle (iterative
  triangular solves, parallel on the device, as the JAX package's
  ``ilu_apply`` runs them).

Every sum over a fixed map (assembly, Galerkin products, restriction)
goes through ``utils/segment.py``, so two setups or applies on the same
inputs give the same bits on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.utils.segment import class_gather, class_sum
from ns_gls_tpu_torch.utils.timer import host_sync, timer

# aggregation levels at most (the JAX package's default ``max_levels``)
MAX_LEVELS = 10
# sweeps a triangular solve of the ILU smoother (the JAX package's
# ``ilu_sweeps``)
ILU_SWEEPS = 3


class AMGLevel(NamedTuple):
    ell_cols: torch.Tensor   # (n, width) int64; width 0 on matrix-free level 0
    ell_vals: torch.Tensor   # (n, width)
    inv_diag: torch.Tensor   # (n,)
    omega: torch.Tensor      # ()
    agg: torch.Tensor        # (n,) int64 aggregate dof of each dof (next level)


class ILUFactors(NamedTuple):
    """SuperLU's incomplete factors of a level matrix, on the device: the
    apply is ``x = (U^-1 L^-1 r[ipr])[pc]``."""

    l_cols: torch.Tensor     # (n, kl) strict lower L, padded ELL
    l_vals: torch.Tensor
    u_cols: torch.Tensor     # (n, ku) strict upper U, padded ELL
    u_vals: torch.Tensor
    udi: torch.Tensor        # (n,) 1 / diag(U)
    ipr: torch.Tensor        # (n,) inverse row permutation
    pc: torch.Tensor         # (n,) column permutation


def _to_ell(A, dtype, device):
    """A scipy matrix as padded ELL (each row's columns in CSR order,
    padded with the row index and value 0)."""
    A = A.tocsr()
    A.sum_duplicates()
    n = A.shape[0]
    counts = np.diff(A.indptr)
    k = max(int(counts.max()), 1)
    row_of = np.repeat(np.arange(n), counts)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, k))
    vals = np.zeros((n, k))
    cols[row_of, pos] = A.indices
    vals[row_of, pos] = A.data
    return (torch.as_tensor(cols, device=device),
            torch.as_tensor(vals, dtype=dtype, device=device))


def ilu_factors(A, dtype, device) -> ILUFactors:
    """SuperLU's incomplete factors of the level matrix ``A`` (scipy;
    ``drop_tol=1e-5``, ``fill_factor=3``) in device form (the JAX
    package's ``_ilu_factors``)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    ilu = spla.spilu(A.tocsc(), drop_tol=1e-5, fill_factor=3.0)
    n = A.shape[0]
    Ls = (ilu.L.tocsr() - sp.eye(n)).tocsr()
    Ls.eliminate_zeros()
    U = ilu.U.tocsr()
    ud = U.diagonal()
    Us = (U - sp.diags(ud)).tocsr()
    Us.eliminate_zeros()
    ipr = np.empty(n, np.int64)
    ipr[ilu.perm_r] = np.arange(n)
    udi = np.where(np.abs(ud) > 1e-300, 1.0 / ud, 1.0)
    return ILUFactors(
        *_to_ell(Ls, dtype, device), *_to_ell(Us, dtype, device),
        torch.as_tensor(udi, dtype=dtype, device=device),
        torch.as_tensor(ipr, device=device),
        torch.as_tensor(ilu.perm_c.astype(np.int64), device=device),
    )


def ilu_apply(f: ILUFactors, r: torch.Tensor,
              sweeps: int = ILU_SWEEPS) -> torch.Tensor:
    """x ~= A^-1 r from the incomplete factors; the two triangular solves
    run as ``sweeps`` Jacobi-style sweeps each (approximate, as the
    reference's Ifpack ILU smoother is incomplete)."""
    rp = r[f.ipr]
    y = rp
    for _ in range(sweeps):
        y = rp - (f.l_vals * y[f.l_cols]).sum(dim=1)
    z = y * f.udi
    for _ in range(sweeps):
        z = (y - (f.u_vals * z[f.u_cols]).sum(dim=1)) * f.udi
    return z[f.pc]


def _strength_aggregates(A, theta=0.08):
    """Greedy aggregation on the strength graph of a CSR matrix."""
    n = A.shape[0]
    d = np.sqrt(np.abs(A.diagonal()) + 1e-300)
    agg = np.full(n, -1, dtype=np.int64)
    indptr, indices, data = A.indptr, A.indices, A.data
    next_agg = 0

    def strong_neighbors(i):
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        vals = np.abs(data[s:e])
        mask = (cols != i) & (vals > theta * d[i] * d[cols])
        return cols[mask]

    # pass 1: roots
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = strong_neighbors(i)
        if (agg[nbrs] == -1).all():
            agg[i] = next_agg
            agg[nbrs] = next_agg
            next_agg += 1
    # pass 2: attach leftovers to a neighboring aggregate
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = strong_neighbors(i)
        hit = nbrs[agg[nbrs] != -1]
        if len(hit):
            agg[i] = agg[hit[0]]
        else:
            agg[i] = next_agg
            next_agg += 1
    return agg, next_agg


def _csr_pattern(rows, cols, nn):
    """Canonical sorted CSR pattern of the (row, col) pairs, the row of
    each stored entry, and the sorted lookup key row * nn + col."""
    import scipy.sparse as sp

    P = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(nn, nn)
    ).tocsr()
    P.sum_duplicates()
    P.sort_indices()
    row_of = np.repeat(np.arange(nn), np.diff(P.indptr))
    key = row_of.astype(np.int64) * nn + P.indices
    return P, row_of, key


class PreconditionerAMG:
    """Aggregation AMG on the assembled (constrained) operator matrix."""

    def __init__(self, op, max_coarse: int = 500, n_smooth: int = 2,
                 theta: float = 0.08, smoother: str = "jacobi"):
        if smoother not in ("jacobi", "ilu"):
            raise ValueError(f"unknown AMG smoother '{smoother}'")
        self.smoother = smoother
        # per stored level, its ILU factors ("ilu" smoother)
        self.ilu = None
        self.op = op
        self.n_comp = op.n_comp
        self.max_coarse = max_coarse
        self.n_smooth = n_smooth
        self.theta = theta
        self.levels = None
        self.coarse_lu = None
        self._frozen_aggs = None
        self._maps = None

    # ------------------------------------------------------------------
    # first setup (host)
    # ------------------------------------------------------------------
    def _host_build(self, emat):
        """Assemble, aggregate and coarsen on the host; freezes the
        aggregates and builds the refresh maps (JAX ``initialize``)."""
        import scipy.sparse as sp

        from ns_gls_tpu_torch.ops.assembly import constrained_matrix

        C = self.n_comp
        # constraint rows/cols -> identity (Dirichlet-style condensation)
        A, rows, cols, mask = constrained_matrix(self.op, emat)
        n = A.shape[0]
        A0 = A
        frozen_aggs = []
        for _ in range(MAX_LEVELS):
            if A.shape[0] <= self.max_coarse * C:
                break
            nn = A.shape[0] // C
            # node-block strength graph: collapse components
            Ai = abs(A)
            comp_sum = None
            for c1 in range(C):
                for c2 in range(C):
                    blk = Ai[c1::C, c2::C]
                    comp_sum = blk if comp_sum is None else comp_sum + blk
            agg_nodes, n_agg = _strength_aggregates(comp_sum.tocsr(),
                                                    self.theta)
            if n_agg > 0.7 * nn:
                # coarsening stalled (the pressure block of the saddle-
                # point RAP has a useless strength graph): stop and let
                # the dense LU take this level
                break
            agg_dofs = np.repeat(agg_nodes, C) * C + np.tile(np.arange(C), nn)
            frozen_aggs.append((agg_dofs, n_agg))
            Pm = sp.coo_matrix(
                (np.ones(A.shape[0]), (np.arange(A.shape[0]), agg_dofs)),
                shape=(A.shape[0], n_agg * C),
            ).tocsr()
            A = (Pm.T @ A @ Pm).tocsr()
        self._frozen_aggs = frozen_aggs
        self._build_maps(rows, cols, mask, n)
        if self.smoother == "ilu":
            self._ilu_levels(A0)

    def _ilu_levels(self, A0):
        """ILU factors of every stored level: the constrained matrix
        ``A0`` (scipy) and its Galerkin products over the frozen
        aggregates, factored on the host."""
        import scipy.sparse as sp

        dtype = self.op.dtype
        dev = self.op.device
        A = A0.tocsr()
        ilu = []
        for agg_dofs, n_agg in self._frozen_aggs:
            ilu.append(ilu_factors(A, dtype, dev))
            Pm = sp.coo_matrix(
                (np.ones(A.shape[0]), (np.arange(A.shape[0]), agg_dofs)),
                shape=(A.shape[0], n_agg * self.n_comp),
            ).tocsr()
            A = (Pm.T @ A @ Pm).tocsr()
        self.ilu = tuple(ilu)

    def _build_maps(self, rows_e, cols_e, mask, n):
        """The slot-map chain of the refresh: element-matrix entries ->
        masked level-0 CSR -> Galerkin CSR per aggregation level (P has one
        unit entry per row, so P^T A P is a pure segment sum) -> ELL,
        diagonal, row sums and the coarsest dense matrix."""
        dev = self.op.device
        dtype = self.op.dtype
        C = self.n_comp
        P0, row_of0, key0 = _csr_pattern(rows_e, cols_e, n)
        slots_e = np.searchsorted(key0, rows_e.astype(np.int64) * n + cols_e)
        maskf = (mask[rows_e] & mask[cols_e]).astype(np.float64)
        base0 = np.zeros(P0.nnz)
        cdofs = np.nonzero(~mask)[0]
        if len(cdofs):
            base0[np.searchsorted(key0, cdofs.astype(np.int64) * n + cdofs)] = 1.0

        pats = [(P0, row_of0)]
        tmaps = []
        for agg_dofs, n_agg in self._frozen_aggs:
            P, row_of = pats[-1]
            nn_next = n_agg * C
            r1 = agg_dofs[row_of]
            c1 = agg_dofs[P.indices]
            P1, row_of1, key1 = _csr_pattern(r1, c1, nn_next)
            tmap = np.searchsorted(key1, r1.astype(np.int64) * nn_next + c1)
            tmaps.append(class_gather(tmap, P1.nnz, dev))
            pats.append((P1, row_of1))

        def t(a, dt=torch.int64):
            return torch.as_tensor(a, dtype=dt, device=dev)

        lvl_maps = []
        for k, (P, row_of) in enumerate(pats[:-1]):   # stored levels
            nn = P.shape[0]
            width = max(int(np.diff(P.indptr).max()), 1)
            pos = np.arange(P.nnz) - np.repeat(P.indptr[:-1], np.diff(P.indptr))
            cols = np.tile(np.arange(nn, dtype=np.int64)[:, None], (1, width))
            cols.reshape(-1)[row_of * width + pos] = P.indices
            diag = np.searchsorted(row_of.astype(np.int64) * nn + P.indices,
                                   np.arange(nn, dtype=np.int64) * (nn + 1))
            lvl_maps.append(dict(
                nn=nn, width=width,
                flat=t(row_of * width + pos),
                # level 0 is matrix-free: no ELL matrix
                cols=t(np.zeros((nn, 0), np.int64) if k == 0 else cols),
                diag=t(diag),
                rowsum=class_gather(row_of, nn, dev),
                agg=t(self._frozen_aggs[k][0]),
                restrict=class_gather(self._frozen_aggs[k][0],
                                      self._frozen_aggs[k][1] * C, dev),
            ))
        Pl, row_ofl = pats[-1]
        self._maps = dict(
            entries=class_gather(slots_e, P0.nnz, dev),
            maskf=t(maskf, dtype),
            base0=t(base0, dtype),
            tmaps=tmaps,
            levels=lvl_maps,
            coarse=dict(nn=Pl.shape[0], rows=t(row_ofl), cols=t(Pl.indices)),
        )

    # ------------------------------------------------------------------
    # value refresh (device)
    # ------------------------------------------------------------------
    def refresh(self, emat):
        """Level matrices, smoother state and the coarsest LU from the
        element matrices, on the device, with the frozen structure."""
        mp = self._maps
        dtype = self.op.dtype
        entries = emat.reshape(-1).to(dtype) * mp["maskf"]
        data = class_sum(mp["entries"], entries) + mp["base0"]
        datas = [data]
        for tmap in mp["tmaps"]:
            datas.append(class_sum(tmap, datas[-1]))
        levels = []
        for k, m in enumerate(mp["levels"]):
            d_k = datas[k]
            if k == 0:
                vals = d_k.new_zeros((m["nn"], 0))
            else:
                vals = d_k.new_zeros(m["nn"] * m["width"])
                vals[m["flat"]] = d_k          # in place on the fresh tensor
                vals = vals.reshape(m["nn"], m["width"])
            diag = d_k[m["diag"]]
            inv_diag = torch.where(diag.abs() > 1e-12, 1.0 / diag,
                                   torch.ones_like(diag))
            rs = class_sum(m["rowsum"], d_k.abs()) * inv_diag.abs()
            omega = 1.0 / torch.clamp(rs.max(), min=1.0)
            levels.append(AMGLevel(m["cols"], vals, inv_diag, omega,
                                   m["agg"]))
        c = mp["coarse"]
        dense = torch.zeros((c["nn"], c["nn"]), dtype=torch.float64,
                            device=data.device)
        dense[c["rows"], c["cols"]] = datas[-1].to(torch.float64)
        self.levels = tuple(levels)
        # its check of the factorization reads the device
        self.coarse_lu = host_sync(torch.linalg.lu_factor, dense)

    def initialize(self):
        from ns_gls_tpu_torch.ops.assembly import element_matrices

        with timer("amg_init::element_matrices"):
            emat = element_matrices(self.op)
        first = self._maps is None
        if first:
            with timer("amg_init::host_build"):
                self._host_build(emat)
        with timer("amg_init::refresh"):
            if not first and self.smoother == "ilu":
                from ns_gls_tpu_torch.ops.assembly import constrained_matrix

                self._ilu_levels(constrained_matrix(self.op, emat)[0])
            self.refresh(emat)

    # ------------------------------------------------------------------
    # apply
    # ------------------------------------------------------------------
    def _apply_level(self, k, x):
        if k == 0:
            return self.op.vmult(x.reshape(-1, self.n_comp)).reshape(-1)
        lvl = self.levels[k]
        return (lvl.ell_vals * x[lvl.ell_cols]).sum(dim=1)

    def _smooth(self, k, x, b):
        lvl = self.levels[k]
        for _ in range(self.n_smooth):
            r = b - self._apply_level(k, x)
            if self.ilu is not None:
                x = x + ilu_apply(self.ilu[k], r)
            else:
                x = x + lvl.omega * lvl.inv_diag * r
        return x

    def _lu_solve(self, r):
        lu, piv = self.coarse_lu
        x = torch.linalg.lu_solve(lu, piv, r.reshape(-1, 1).to(lu.dtype))
        return x.reshape(-1).to(r.dtype)

    def _down(self, k, b):
        x = self._smooth(k, torch.zeros_like(b), b)
        r = b - self._apply_level(k, x)
        rc = class_sum(self._maps["levels"][k]["restrict"], r)
        if k + 1 < len(self.levels):
            xc = self._down(k + 1, rc)
        else:
            xc = self._lu_solve(rc)
        x = x + xc[self.levels[k].agg]
        return self._smooth(k, x, b)

    def vmult(self, src):
        if self.levels is None:
            self.initialize()
        b0 = src.reshape(-1)
        out = self._down(0, b0) if self.levels else self._lu_solve(b0)
        return out.reshape(src.shape)

    @property
    def level_sizes(self) -> list:
        """Dofs per stored level, then the coarsest (dense LU) level."""
        return ([int(lv.inv_diag.shape[0]) for lv in self.levels]
                + [int(self.coarse_lu[0].shape[0])])
