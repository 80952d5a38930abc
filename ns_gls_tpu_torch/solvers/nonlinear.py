"""Nonlinear solver: Newton (full step, optional inexact preconditioner
reuse).  The Picard fixed-point and single linearized solves of the JAX
package are not ported yet.

The reference's callback-decoupled design (``solver_nl.{h,cc}``): the
solver is wired to the operator / linear solver / preconditioner
exclusively through injected closures (``solver_nl.h:22-34``).
"""

from __future__ import annotations

from typing import Callable, Optional

from ns_gls_tpu_torch.solvers.linear import acc_norm


class NonlinearSolverError(RuntimeError):
    pass


class NonLinearSolverBase:
    """Callback slots, mirroring ``solver_nl.h:22-34``."""

    setup_jacobian: Callable = None        # (u) -> None
    setup_preconditioner: Callable = None  # (u) -> None
    evaluate_residual: Callable = None     # (u) -> residual
    solve_with_jacobian: Callable = None   # (rhs) -> delta
    logger: Optional[Callable] = None

    def _log(self, msg: str):
        if self.logger:
            self.logger(msg)

    def solve(self, solution):
        raise NotImplementedError


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
        l2 = float(acc_norm(rhs))
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
            l2_prev, l2 = l2, float(acc_norm(rhs))
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


def make_nonlinear_solver(kind: str, inexact: bool = False,
                          tolerance: float = 1e-7,
                          relative: bool = False,
                          max_iterations: int = 30) -> NonLinearSolverBase:
    if kind == "Newton":
        return NonLinearSolverNewton(inexact=inexact, tolerance=tolerance,
                                     relative=relative,
                                     max_iterations=max_iterations)
    if kind in ("linearized", "Picard"):
        raise NotImplementedError(
            f"nonlinear solver '{kind}' is not ported yet (Newton is)"
        )
    raise ValueError(f"unknown nonlinear solver '{kind}'")
