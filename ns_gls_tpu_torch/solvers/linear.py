"""Linear solvers: right-preconditioned restarted GMRES, Richardson and a
dense direct solver (reference ``solver_l.cc``):

- GMRES: restart basis 30, right preconditioning, Givens-rotation residual
  tracking, tolerance max(rtol*||b||, abs)  (``solver_l.cc:46-74``),
- Richardson: x += M (b - A x)  (``solver_l.cc:97-120``),
- direct: dense LU of the assembled matrix — replaces Trilinos
  SolverDirect (``solver_l.cc:6-24``) on small problems.

Operators and preconditioners enter as callables on tensors shaped like
the right-hand side, or on distributed vectors (``parallel/dist.py``
``DistVector``) under sharding, where every dot product sums its
per-shard partials on the first device.  The loops run eagerly on the
host; each Arnoldi step reads its Hessenberg column on the host (the
Givens rotations, and the residual estimate that decides whether to go
on) and copies the rotated column back: two host syncs, counted by
``utils/timer.py`` ``host_sync``.  The JAX package's ``gmres_fixed`` (a
loop of a static length, which it takes only on a TPU backend) is not
ported: the port's multigrid coarse solve iterates with ``gmres``
everywhere, as the JAX package does off the TPU.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ns_gls_tpu_torch.parallel.dist import DistVector
from ns_gls_tpu_torch.utils.timer import host_sync


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int          # total inner iterations


def _identity(x):
    return x


def acc_dot(a, b):
    """Dot product with f64 accumulation for f32 vectors (the
    mixed-precision answer to ``config.h:6-7``'s f64 outer solve), rounded
    back to the vector dtype."""
    if isinstance(a, DistVector):
        return a.dot(b)
    if a.dtype == torch.float32:
        return torch.dot(a.reshape(-1).double(),
                         b.reshape(-1).double()).to(a.dtype)
    return torch.dot(a.reshape(-1), b.reshape(-1))


def acc_norm(a):
    """2-norm via :func:`acc_dot` (f64-accumulated sum of squares)."""
    if isinstance(a, DistVector):
        return a.norm()
    if a.dtype == torch.float32:
        a64 = a.reshape(-1).double()
        return torch.sqrt(torch.dot(a64, a64)).to(a.dtype)
    return torch.linalg.vector_norm(a.reshape(-1))


def gmres(A: Callable, b: torch.Tensor, x0: torch.Tensor,
          M: Callable = _identity, tol=1e-12, restart: int = 30,
          max_restarts: int = 100) -> SolveResult:
    """Right-preconditioned GMRES(restart): solves A x = b via x = M z.

    `A`, `M`: linear maps on tensors shaped like `b`.  `tol`: absolute
    residual tolerance (float or 0-dim tensor).  Same recursion as the
    JAX reference: every cycle restarts from the true residual, the
    Arnoldi step uses modified Gram-Schmidt with f64-accumulated dots,
    and a restart that no longer reduces the true residual stops.
    ``b`` and ``x0`` may be distributed vectors; the Arnoldi basis is then
    kept per shard and the small Hessenberg work on the first device.
    """
    dtype = b.dtype
    dev = b.device
    m = restart
    tol = float(tol)
    dist = isinstance(b, DistVector)
    if dist:
        mv, pc = A, M
        bf, x = b, x0
        V = b.basis(m + 1)
    else:
        shape = b.shape

        def mv(v):
            return A(v.reshape(shape)).reshape(-1)

        def pc(v):
            return M(v.reshape(shape)).reshape(-1)

        bf = b.reshape(-1)
        x = x0.reshape(-1)
        V = torch.zeros((m + 1, bf.numel()), dtype=dtype, device=dev)
    total_it = 0
    prev_beta = math.inf
    while total_it < m * max_restarts:
        r = bf - mv(x)
        beta_t = acc_norm(r)
        beta = host_sync(float, beta_t)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        cs = [0.0] * m
        sn = [0.0] * m
        g = [0.0] * (m + 1)
        g[0] = beta
        # rows of V are written before they are read within a cycle
        V[0] = (r / beta_t if beta > 0
                else r.zeros_like() if dist else torch.zeros_like(r))
        j = 0
        res = beta
        while j < m and res > tol:
            w = mv(pc(V[j]))
            hcol = torch.zeros(m + 1, dtype=dtype, device=dev)
            for k in range(j + 1):
                hk = acc_dot(V[k], w)
                w = w - hk * V[k]
                hcol[k] = hk
            hj1 = acc_norm(w)
            V[j + 1] = (w.div_or_zero(hj1) if dist else
                        torch.where(hj1 > 0, w / hj1, torch.zeros_like(w)))
            hcol[j + 1] = hj1
            hc = host_sync(torch.Tensor.tolist, hcol)
            # previous Givens rotations on entries 0..j (scalar work)
            for k in range(j):
                t0 = cs[k] * hc[k] + sn[k] * hc[k + 1]
                t1 = -sn[k] * hc[k] + cs[k] * hc[k + 1]
                hc[k], hc[k + 1] = t0, t1
            denom = math.sqrt(hc[j] ** 2 + hc[j + 1] ** 2)
            c_new = hc[j] / denom if denom > 0 else 1.0
            s_new = hc[j + 1] / denom if denom > 0 else 0.0
            cs[j], sn[j] = c_new, s_new
            hc[j] = c_new * hc[j] + s_new * hc[j + 1]
            hc[j + 1] = 0.0
            g_j1 = -s_new * g[j]
            g[j + 1] = g_j1
            g[j] = c_new * g[j]
            H[:, j] = host_sync(torch.tensor, hc, dtype=dtype, device=dev)
            j += 1
            res = abs(g_j1)
        if j > 0:
            y = torch.linalg.solve_triangular(
                H[:j, :j],
                host_sync(torch.tensor, g[:j], dtype=dtype,
                          device=dev).reshape(-1, 1),
                upper=True,
            ).reshape(-1)
            z = V.combine(y, j) if dist else (y[:, None] * V[:j]).sum(dim=0)
            x = x + pc(z)
        converged = beta <= tol
        stagnated = beta > 0.999 * prev_beta and total_it > 0
        total_it += j
        prev_beta = beta
        if converged or stagnated:
            break
    return SolveResult(x if dist else x.reshape(shape), total_it)


def richardson(A: Callable, b: torch.Tensor, x0: torch.Tensor,
               M: Callable = _identity, tol=1e-12,
               max_iter: int = 1000) -> SolveResult:
    """Preconditioned Richardson: x += M (b - A x) while the residual norm
    of the iterate before the update exceeds ``tol``, at most
    ``max_iter`` updates (``solver_l.cc:97-120``)."""
    tol = float(tol)
    x = x0
    it = 0
    res = host_sync(float, torch.linalg.vector_norm((b - A(x0)).reshape(-1)))
    while res > tol and it < max_iter:
        r = b - A(x)
        x = x + M(r)
        it += 1
        res = host_sync(float, torch.linalg.vector_norm(r.reshape(-1)))
    return SolveResult(x, it)


# --------------------------------------------------------------------------
# object layer (reference ``solver_l.h:17-27`` contract)
# --------------------------------------------------------------------------
class LinearSolverGMRES:
    def __init__(self, op, preconditioner, n_max_iterations=10000,
                 absolute_tolerance=1e-12, relative_tolerance=1e-8,
                 restart=30, logger=None):
        self.op = op
        self.preconditioner = preconditioner
        self.n_max_iterations = n_max_iterations
        self.abs_tol = absolute_tolerance
        self.rel_tol = relative_tolerance
        self.restart = restart
        self.logger = logger
        self.last_iterations = 0

    def initialize(self):
        pass

    def solve(self, b):
        tol = max(self.rel_tol * host_sync(float, acc_norm(b)), self.abs_tol)
        max_restarts = max(1, self.n_max_iterations // self.restart)
        op, pre = self.op, self.preconditioner
        if hasattr(op, "to_dist"):
            # halo-sharded operator: the Krylov loop runs on distributed
            # vectors; a distributed V-cycle takes them as they are, any
            # other preconditioner converts at its boundary
            # (``ns_gls_tpu/solvers/linear.py:379-404``)
            if getattr(pre, "distributed", False):
                M = pre.vmult
            else:
                def M(x):
                    return op.to_dist(pre.vmult(op.to_global(x)))
            bd = op.to_dist(b)
            res = gmres(op.vmult_dist, bd, bd.zeros_like(), M=M, tol=tol,
                        restart=self.restart, max_restarts=max_restarts)
            x = op.to_global(res.x)
        else:
            res = gmres(op.vmult, b, torch.zeros_like(b), M=pre.vmult,
                        tol=tol, restart=self.restart,
                        max_restarts=max_restarts)
            x = res.x
        self.last_iterations = res.iterations
        if self.logger:
            self.logger(f"    [L] solved in {res.iterations} iterations.")
        return x


class LinearSolverRichardson:
    def __init__(self, op, preconditioner, n_max_iterations=10000,
                 absolute_tolerance=1e-12, relative_tolerance=1e-8,
                 logger=None):
        self.op = op
        self.preconditioner = preconditioner
        self.n_max_iterations = n_max_iterations
        self.abs_tol = absolute_tolerance
        self.rel_tol = relative_tolerance
        self.logger = logger
        self.last_iterations = 0

    def initialize(self):
        pass

    def solve(self, b):
        tol = max(self.rel_tol * host_sync(float, torch.linalg.vector_norm(
            b.reshape(-1))), self.abs_tol)
        res = richardson(self.op.vmult, b, torch.zeros_like(b),
                         M=self.preconditioner.vmult, tol=tol,
                         max_iter=self.n_max_iterations)
        self.last_iterations = res.iterations
        if self.logger:
            self.logger(f"    [L] solved in {res.iterations} iterations.")
        return res.x


class LinearSolverDirect:
    """Dense LU of the assembled (constrained) system — replaces the
    Trilinos sparse direct solver for the small problems it is used on."""

    def __init__(self, op, logger=None):
        self.op = op
        self.logger = logger
        self._lu = None
        self.last_iterations = 0

    def initialize(self):
        from ns_gls_tpu_torch.ops.assembly import assemble_dense

        n = self.op.n_nodes * self.op.n_comp
        if n > 40000:
            raise ValueError(
                f"dense direct solver requested for {n} dofs; use GMRES with"
                " GMG instead (the sparse-direct equivalent is only provided"
                " for small/coarse problems)"
            )
        # its check of the factorization reads the device
        self._lu = host_sync(torch.linalg.lu_factor, assemble_dense(self.op))

    def solve(self, b):
        if self._lu is None:
            self.initialize()
        lu, piv = self._lu
        x = torch.linalg.lu_solve(lu, piv, b.reshape(-1, 1).to(lu.dtype))
        self.last_iterations = 1
        return x.reshape(b.shape).to(b.dtype)
