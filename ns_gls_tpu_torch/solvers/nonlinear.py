"""Nonlinear solvers: Newton (full step, optional inexact preconditioner
reuse), Picard fixed-point, and single linearized solve.

The reference's callback-decoupled design (``solver_nl.{h,cc}``): the
solver is wired to the operator / linear solver / preconditioner
exclusively through injected closures (``solver_nl.h:22-34``).
"""

from __future__ import annotations

from typing import Callable, Optional

from ns_gls_tpu_torch.solvers.linear import acc_norm
from ns_gls_tpu_torch.utils.timer import host_sync


class NonlinearSolverError(RuntimeError):
    pass


class NonLinearSolverBase:
    """Callback slots, mirroring ``solver_nl.h:22-34``."""

    setup_jacobian: Callable = None        # (u) -> None
    setup_preconditioner: Callable = None  # (u) -> None
    evaluate_rhs: Callable = None          # () -> rhs
    evaluate_residual: Callable = None     # (u) -> residual
    solve_with_jacobian: Callable = None   # (rhs) -> delta
    logger: Optional[Callable] = None

    def _log(self, msg: str):
        if self.logger:
            self.logger(msg)

    def solve(self, solution):
        raise NotImplementedError


class NonLinearSolverLinearized(NonLinearSolverBase):
    """One semi-implicit solve per step (``solver_nl.cc:7-24``)."""

    last_iterations = 1
    last_residual = float("nan")

    def solve(self, solution):
        self.setup_jacobian(solution)
        rhs = self.evaluate_rhs()
        self.setup_preconditioner(solution)
        return self.solve_with_jacobian(rhs)


class NonLinearSolverNewton(NonLinearSolverBase):
    """Full-step Newton, ||R||_2 < tol, <= max_iter iterations; `inexact`
    freezes the preconditioner after the first iteration
    (``solver_nl.cc:28-89``)."""

    def __init__(self, inexact: bool = False, tolerance: float = 1e-7,
                 max_iterations: int = 30, relative: bool = False):
        self.inexact = inexact
        self.tolerance = tolerance
        # relative mode: converge to tolerance * ||R_0|| per step — the
        # f32-honest criterion (the f32 residual-evaluation noise floor
        # scales with the step's residual magnitude; the reference's
        # absolute 1e-7 assumes the f64 outer solve of config.h:6-7)
        self.relative = relative
        self.max_iterations = max_iterations
        self.last_iterations = 0
        self.last_residual = float("nan")

    def solve(self, solution):
        self.setup_jacobian(solution)
        rhs = self.evaluate_residual(solution)
        l2 = host_sync(float, acc_norm(rhs))
        l2_0 = l2
        it = 0
        self._log(f"    [N] step {it}; residual = {l2:.6e}")
        tol = self.tolerance * (l2 if self.relative else 1.0)

        while l2 > tol:
            if it == 0 or not self.inexact:
                self.setup_preconditioner(solution)
            inc = self.solve_with_jacobian(rhs)
            solution = solution + inc
            self.setup_jacobian(solution)
            rhs = self.evaluate_residual(solution)
            l2_prev, l2 = l2, host_sync(float, acc_norm(rhs))
            it += 1
            self._log(f"    [N] step {it}; residual = {l2:.6e}")
            if (self.relative and it >= 2 and l2 >= l2_prev
                    and l2 <= 1e-2 * l2_0):
                # f32 residual-evaluation noise floor reached: the
                # residual stopped DECREASING AT ALL two orders below the
                # step's starting point.  Requiring an outright
                # non-decrease (not merely a missed halving) keeps slowly
                # but genuinely converging Newton phases (linear-rate
                # near shedding onset) iterating toward tol instead of
                # being cut off early.
                self._log("    [N] stalled at the f32 residual floor; "
                          "accepting.")
                break
            if l2 > tol and it > self.max_iterations:
                if l2 <= 3e-7 * l2_0:
                    # the ABSOLUTE tolerance sits below the f32
                    # relative evaluation floor for this step (the
                    # impulsive-start transient has ||R_0|| ~ 1e5+ at
                    # inflow scales where eps_f32 * ||R_0|| > tol): no
                    # iteration count can reach it.  3e-7 ~ 5 eps_f32
                    # is far below any physics-relevant level — accept
                    # (the reference never meets this case: its outer
                    # solve is f64, ``config.h:6-7``).
                    self._log("    [N] absolute tolerance below the f32 "
                              "relative floor; accepting.")
                    break
                # only an UNCONVERGED iteration budget is a failure: the
                # residual was just updated above, so a step whose final
                # allowed iteration lands below tol is accepted (the
                # reference throws only after its convergence loop
                # exhausts, ``solver_nl.cc:82-89``)
                raise NonlinearSolverError(
                    f"Newton iteration did not converge; residual {l2:.3e}"
                )

        self.last_iterations = it
        self.last_residual = l2
        self._log(f"    [N] solved in {it} iterations.")
        return solution


class NonLinearSolverPicard(NonLinearSolverBase):
    """Fixed-point iteration on the semi-implicit system
    (``solver_nl.cc:93-136``)."""

    def __init__(self, tolerance: float = 1e-7, max_iterations: int = 30,
                 relative: bool = False):
        self.tolerance = tolerance
        self.max_iterations = max_iterations
        # relative mode: the convergence metric is the fixed-point
        # increment ||u_{k+1} - u_k||, whose f32 evaluation floor scales
        # with ||u||; converge to tolerance * ||u|| instead (the criterion
        # NonLinearSolverNewton.relative applies to its residual)
        self.relative = relative
        self.last_iterations = 0
        self.last_residual = float("nan")

    def solve(self, solution):
        l2 = float("inf")
        it = 0
        while True:
            prev = solution
            self.setup_jacobian(solution)
            rhs = self.evaluate_rhs()
            self.setup_preconditioner(solution)
            solution = self.solve_with_jacobian(rhs)
            l2_prev, l2 = l2, host_sync(float, acc_norm(prev - solution))
            tol = self.tolerance
            if self.relative:
                tol = tol * host_sync(float, acc_norm(solution))
            it += 1
            self._log(f"    [P] step {it}; increment = {l2:.6e}")
            if l2 <= tol:
                break
            if (self.relative and it >= 2 and l2 >= l2_prev
                    and l2 <= 100.0 * tol):
                # increment stopped contracting within two orders of the
                # target (linear-solver noise floor): accept, as Newton's
                # relative mode does at its residual floor
                self._log("    [P] stalled at the solve noise floor; "
                          "accepting.")
                break
            if it > self.max_iterations:
                raise NonlinearSolverError(
                    f"Picard iteration did not converge; residual {l2:.3e}"
                )
        self.last_iterations = it
        self.last_residual = l2
        self._log(f"    [P] solved in {it} iterations.")
        return solution


def make_nonlinear_solver(kind: str, inexact: bool = False,
                          tolerance: float = 1e-7,
                          relative: bool = False,
                          max_iterations: int = 30) -> NonLinearSolverBase:
    if kind == "linearized":
        return NonLinearSolverLinearized()
    if kind == "Newton":
        return NonLinearSolverNewton(inexact=inexact, tolerance=tolerance,
                                     relative=relative,
                                     max_iterations=max_iterations)
    if kind == "Picard":
        return NonLinearSolverPicard(tolerance=tolerance,
                                     max_iterations=max_iterations,
                                     relative=relative)
    raise ValueError(f"unknown nonlinear solver '{kind}'")
