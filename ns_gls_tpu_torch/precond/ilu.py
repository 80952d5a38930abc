"""Incomplete-LU preconditioner (reference ``preconditioner.cc:5-34``,
Trilinos ILU(0)).

Port of ``ns_gls_tpu/precond/ilu.py``.  The factorization and the two
triangular solves are sequential; the JAX package runs both on the host
(SuperLU's ILU through scipy, with a drop tolerance that approximates
ILU(0)) and reaches the solve from its jitted GMRES through
``jax.pure_callback``.  The port does the same by design, not as a
fallback: the element matrices come from the device, the constrained
matrix is factored on the host, and every apply copies the vector from
the card to the host, runs SuperLU's solve in f64 there and copies the
result back (three host syncs an apply on the card: the wait and the two
copies).  The apply
counts its calls and their host seconds (``n_applies``,
``apply_seconds``), the copies and the wait for the card included, so a
run can state what the host solve costs.  A triangular solve on the
device is not part of the port (ROADMAP queue 1).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ns_gls_tpu_torch.utils.timer import host_sync


class PreconditionerILU:
    def __init__(self, op, fill_factor: float = 3.0, drop_tol: float = 1e-5):
        self.op = op
        self.fill_factor = fill_factor
        self.drop_tol = drop_tol
        self._ilu = None
        self.n_applies = 0
        self.apply_seconds = 0.0

    def initialize(self):
        import scipy.sparse.linalg as spla

        from ns_gls_tpu_torch.ops.assembly import (
            constrained_matrix,
            element_matrices,
        )

        A = constrained_matrix(self.op, element_matrices(self.op),
                               "csc")[0]
        self._ilu = spla.spilu(A.tocsc(), drop_tol=self.drop_tol,
                               fill_factor=self.fill_factor)

    def vmult(self, x):
        if self._ilu is None:
            self.initialize()
        if x.is_cuda:
            host_sync(torch.cuda.synchronize, x.device)
        t0 = time.perf_counter()
        y = self._ilu.solve(host_sync(x.detach().cpu).numpy()
                            .astype(np.float64).reshape(-1))
        out = host_sync(torch.as_tensor, y.reshape(tuple(x.shape)),
                        dtype=x.dtype, device=x.device)
        self.apply_seconds += time.perf_counter() - t0
        self.n_applies += 1
        return out
