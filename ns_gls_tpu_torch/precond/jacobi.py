"""Point-Jacobi / identity preconditioners (reference: DiagonalMatrix-based
smoother preconditioner, ``multigrid.h:67-69``; PreconditionIdentity)."""

from __future__ import annotations


class PreconditionerIdentity:
    def initialize(self):
        pass

    def vmult(self, x):
        return x


class PreconditionerJacobi:
    """M = diag(A)^{-1} of the (constrained) operator."""

    def __init__(self, op):
        self.op = op
        self.inv_diag = None

    def initialize(self):
        from ns_gls_tpu_torch.ops.assembly import compute_inverse_diagonal

        self.inv_diag = compute_inverse_diagonal(self.op)

    def vmult(self, x):
        if self.inv_diag is None:
            self.initialize()
        return self.inv_diag * x
