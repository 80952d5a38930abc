"""Matrix-based NS operator: assembled sparse matrix + SpMV apply.

Port of ``ns_gls_tpu/ops/matrix_based.py``, the counterpart of the
reference's fallback ``NavierStokesOperatorMatrixBased``
(``operator_ns.h:196-267``, assembly ``operator_ns.cc:1600-1756``): the
same GLS system in assembled form (fixed-point flavor only, as in the
reference), applied as a sparse matvec.  Selected by ``use matrix free ns
operator: false`` with a non-Newton solver.

The assembled matrix is stored as padded ELL (a fixed number of entries a
row, the pad columns pointing at the row itself with value 0), as the JAX
package stores it, and the apply is a gather and a row sum in plain
PyTorch, as JAX computes it outside any Pallas kernel.  The sparsity
pattern comes from the cell-node table once, on the host; each assembly
sums the element matrices (``ops/assembly.py`` ``element_matrices``) into
that pattern on the device with the fixed-order segment sums of
``utils/segment.py``, so two assemblies give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.fem import constraints as cstr
from ns_gls_tpu_torch.utils.segment import class_gather, class_sum


class ELLMatrix(NamedTuple):
    cols: torch.Tensor  # (n_rows, max_nnz) int64, padded with the row index
    vals: torch.Tensor  # (n_rows, max_nnz)

    @property
    def n_rows(self):
        return self.cols.shape[0]


def ell_spmv(m: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for flattened x (n_rows,)."""
    return (m.vals * x[m.cols]).sum(dim=1)


class ELLPattern(NamedTuple):
    """Where the element-matrix entries go in the padded ELL matrix."""

    cols: torch.Tensor      # (n_rows, width) column of every slot
    entries: object         # ClassGather: element entries -> CSR slots
    flat: torch.Tensor      # CSR slot -> flat ELL position


def ell_pattern(rows: np.ndarray, cols: np.ndarray, n: int,
                device) -> ELLPattern:
    """The padded-ELL pattern of the (row, col) pairs of the element
    matrices: each row's columns in ascending order (the CSR order of the
    JAX package's ``ell_from_coo``), padded with the row index."""
    import scipy.sparse as sp

    A = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    counts = np.diff(A.indptr)
    width = max(int(counts.max()), 1)
    row_of = np.repeat(np.arange(n), counts)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    ecols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, width))
    ecols[row_of, pos] = A.indices
    key = row_of.astype(np.int64) * n + A.indices
    slots = np.searchsorted(key, rows.astype(np.int64) * n + cols)
    return ELLPattern(
        cols=torch.as_tensor(ecols, device=device),
        entries=class_gather(slots, A.nnz, device),
        flat=torch.as_tensor(row_of * width + pos, device=device),
    )


class NavierStokesOperatorMatrixBased:
    """Assembles the linear(ized) GLS system from the matrix-free
    operator's element matrices (``torch.func.jacfwd``) and applies it as a
    padded-ELL SpMV.

    Wraps a matrix-free operator for state handling: assembly happens
    lazily per linearization point (``invalidate_system`` semantics,
    ``operator_ns.cc:227-232``).
    """

    def __init__(self, op):
        self.op = op  # a NavierStokesOperator holding space/state
        # what evaluates the residual and the rhs: the operator, or its
        # cell-sharded wrapper under sharding (``parallel/sharding.py``)
        self.residual_op = op
        self._ell: ELLMatrix | None = None
        self._pattern: ELLPattern | None = None

    # -- reference OperatorBase surface ----------------------------------
    @property
    def space(self):
        return self.op.space

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    @property
    def n_comp(self):
        return self.op.n_comp

    @property
    def n_nodes(self):
        return self.op.n_nodes

    @property
    def constraints_homogeneous(self):
        return self.op.constraints_homogeneous

    @property
    def constraints_inhomogeneous(self):
        return self.op.constraints_inhomogeneous

    @constraints_inhomogeneous.setter
    def constraints_inhomogeneous(self, value):
        self.op.constraints_inhomogeneous = value

    def set_linearization_point(self, u):
        self.op.set_linearization_point(u)
        self._ell = None

    def set_previous_solution(self, history):
        self.op.set_previous_solution(history)
        self._ell = None

    def invalidate_system(self):
        self.op.invalidate_system()
        self._ell = None

    def update_weight(self):
        self.op.update_weight()
        self._ell = None

    def evaluate_rhs(self):
        return self.residual_op.evaluate_rhs()

    def evaluate_residual(self, u):
        return self.residual_op.evaluate_residual(u)

    def get_max_u(self, u):
        return self.op.get_max_u(u)

    # -- assembled apply ---------------------------------------------------
    def assemble(self) -> ELLMatrix:
        """Raw (unconstrained) element matrices summed into the global ELL
        matrix; the constraint sandwich is applied around the SpMV,
        matching the matrix-free path exactly."""
        from ns_gls_tpu_torch.ops.assembly import element_matrices

        emat = element_matrices(self.op)  # (n_c, nl, nl)
        C = self.n_comp
        if self._pattern is None:
            gdofs = (
                self.space.cell_nodes.astype(np.int64)[:, :, None] * C
                + np.arange(C)[None, None, :]
            ).reshape(len(emat), -1)
            nl = gdofs.shape[1]
            rows = np.repeat(gdofs, nl, axis=1).reshape(-1)
            cols = np.tile(gdofs, (1, nl)).reshape(-1)
            self._pattern = ell_pattern(rows, cols, self.n_nodes * C,
                                        self.device)
        pat = self._pattern
        data = class_sum(pat.entries, emat.reshape(-1), in_order=True)
        vals = data.new_zeros(pat.cols.numel())
        vals[pat.flat] = data               # in place on the fresh tensor
        return ELLMatrix(cols=pat.cols, vals=vals.reshape(pat.cols.shape))

    @property
    def ell(self) -> ELLMatrix:
        if self._ell is None:
            self._ell = self.assemble()
        return self._ell

    def vmult(self, u):
        ch = self.constraints_homogeneous
        u_eff = cstr.distribute(ch, u, homogeneous=True)
        r = ell_spmv(self.ell, u_eff.reshape(-1)).reshape(u.shape)
        r = cstr.condense_transpose(ch, r)
        return cstr.copy_constrained(ch, r, u)
