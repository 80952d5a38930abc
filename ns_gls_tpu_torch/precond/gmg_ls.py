"""Local-smoothing geometric multigrid (the reference's "GMG-LS").

Port of ``ns_gls_tpu/precond/gmg_ls.py`` (reference ``main.cc:569-732``:
per-level float operators on the p4est levels, ``MGConstrainedDoFs``
refinement-edge bookkeeping and the interface corrections
``operator_ns.cc:734-787``).  It differs from the global-coarsening GMG
(``precond/gmg.py``) only on adaptively refined meshes:

- the hierarchy is the refinement FOREST: level ``l`` holds the cells at
  refinement level ``l`` (``mesh/forest.py``) and covers only the part of
  the domain refined that far,
- smoothing touches only the dofs inside a level's region: rows on the
  refinement edge (the interface to coarser active cells) are masked in
  the Jacobi update, so the level correction is conforming by zero
  extension,
- the interface coupling is carried by the TRUE level residual
  ``d - A_l x`` (the operator keeps the physical constraints only, not
  the edge rows): its edge rows are the fine-side flux the reference
  moves with ``vmult_interface_down``, and the restriction hands them to
  the coarser level where those dofs are smoothed,
- the global defect is injected at each dof's COARSEST active level
  (edge dofs belong to the coarse side; hanging-position edge nodes are
  constrained globally and enter nowhere), and the solution is collected
  finest level last, so hanging positions read the prolongated,
  constraint-consistent values.

On globally refined meshes every level covers the domain, the edge sets
are empty and the cycle is the global-coarsening V-cycle.  The cycle runs
on node-major (n_l, C) tensors.  Every index assignment has unique
targets, so the card gives the same bits on every run.
"""

from __future__ import annotations

import numpy as np
import torch

from ns_gls_tpu_torch.fem import transfer as tr
from ns_gls_tpu_torch.precond.gmg import PreconditionerGMG


def _assignment(target, source, device, what: str):
    """(target, source) index tensors of ``out[target] = v[source]``; the
    targets must be unique (an assignment with repeated indices keeps an
    arbitrary one of the values on the card)."""
    target = np.asarray(target, np.int64)
    if len(np.unique(target)) != len(target):
        raise ValueError(f"{what}: repeated target indices")
    return (torch.as_tensor(target, device=device),
            torch.as_tensor(np.asarray(source, np.int64), device=device))


class PreconditionerGMGLS(PreconditionerGMG):
    init_scope = "mg_ls_init"
    power_seed = 47

    def __init__(
        self,
        level_ops: list,        # NavierStokesOperator per forest level
        transfers: list,        # TwoLevelTransfer per gap (level meshes)
        inj_maps: list,         # per level: (rows_l, src_fin) defect injection
        copy_maps: list,        # per level: (rows_l, dst_fin) solution collect
        int_masks: list,        # per level: (n_nodes_l, 1), 0 on the edge
        constrained_rows=None,  # global dof rows constrained in the OUTER
                                # system (hanging/Dirichlet): the Krylov
                                # system carries them as identity rows, so
                                # the preconditioner must act as identity
                                # there, NOT return the conforming
                                # interpolated value (which is what the
                                # level prolongations produce at hanging
                                # positions, and which poisons GMRES)
        n_fine_nodes: int = 0,
        mg_dtype=torch.float32,
        smoothing_n_iterations: int = 5,
        smoothing_range: float = 20.0,
        smoothing_eig_n_iterations: int = 20,
        coarse_grid_solver: str = "direct",
        logger=None,
    ):
        super().__init__(
            level_ops, transfers, mg_dtype=mg_dtype,
            smoothing_n_iterations=smoothing_n_iterations,
            smoothing_range=smoothing_range,
            smoothing_eig_n_iterations=smoothing_eig_n_iterations,
            coarse_grid_solver=coarse_grid_solver, logger=logger,
            # the JAX package's parameters: the reference's tuned set
            coarse_amg_default_parameters=False,
        )
        # the masked cycle smooths no coarse level
        self._needs_level0_args = False
        dev = level_ops[0].device
        self.n_fine_nodes = int(n_fine_nodes)
        # (target, source): injection writes level rows, the collection
        # final nodes
        self.inj = [_assignment(r, s, dev, f"level {l} injection")
                    for l, (r, s) in enumerate(inj_maps)]
        self.cpy = [_assignment(d, r, dev, f"level {l} collection")
                    for l, (r, d) in enumerate(copy_maps)]
        self.masks = [torch.as_tensor(np.asarray(m), dtype=mg_dtype,
                                      device=dev) for m in int_masks]
        self.constrained_rows = (
            torch.as_tensor(np.asarray(constrained_rows, np.int64),
                            device=dev)
            if constrained_rows is not None and len(constrained_rows)
            else None
        )

    # ------------------------------------------------------------------
    def _coarse_setup(self):
        """A dense LU in f64 for "direct" and "ILU" alike, at any size (the
        JAX package's local-smoothing cycle factors its coarse level
        densely for any solver but AMG and identity); AMG as the global
        cycle's."""
        if self.coarse_grid_solver in ("direct", "ILU"):
            self._factor_coarse()
        else:
            super()._coarse_setup()

    # ------------------------------------------------------------------
    def _smooth_masked(self, level: int, x, b):
        """Damped Jacobi sweeps with the refinement-edge rows masked."""
        op = self.level_ops[level]
        inv_d = self.inv_diags[level]
        om = self.omegas[level]
        m = self.masks[level]
        for _ in range(self.n_smooth):
            x = x + om * inv_d * (m * (b - op.vmult(x)))
        return x

    def _cycle(self, level: int, d, prefill, x_fin):
        """The correction on ``level`` for the defect ``d`` (n_l, C); its
        values go into ``x_fin`` on the level's active nodes after the
        coarser levels' (finest last)."""
        dst, rows = self.cpy[level]
        if level == 0:
            x = self._coarse_solve(d)
            x_fin[dst] = x[rows]
            return x
        op = self.level_ops[level]
        x = self._smooth_masked(level, torch.zeros_like(d), d)
        # full-row residual: the edge rows carry the fine-side interface
        # flux down to the level where those dofs are smoothed
        t = d - op.vmult(x)
        d_c = prefill[level - 1] + tr.restrict(self.transfers[level - 1], t)
        x_c = self._cycle(level - 1, d_c, prefill, x_fin)
        x = x + tr.prolongate(self.transfers[level - 1], x_c)
        x = self._smooth_masked(level, x, d)
        x_fin[dst] = x[rows]
        return x

    def vmult(self, src):
        if self.inv_diags is None:
            self.initialize()
        C = self.level_ops[0].n_comp
        b = src.to(self.mg_dtype).reshape(-1, C)
        prefill = []
        for op, (rows, sf) in zip(self.level_ops, self.inj):
            d = b.new_zeros((op.n_nodes, C))
            d[rows] = b[sf]
            prefill.append(d)
        x_fin = b.new_zeros((self.n_fine_nodes, C))
        # every write into x_fin is in place on this fresh tensor
        self._cycle(self.n_levels - 1, prefill[-1], prefill, x_fin)
        if self.constrained_rows is not None:
            x_fin.view(-1)[self.constrained_rows] = (
                b.reshape(-1)[self.constrained_rows])
        return x_fin.reshape(src.shape).to(src.dtype)
