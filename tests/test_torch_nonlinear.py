"""The port's Picard and linearized nonlinear solvers against the JAX
package, in f64 on the CPU.

- Driver steps on ``input/channel.json`` at refinement 1 with f64 GMG
  levels, the multigrid's power iterations started from the JAX
  package's vectors: Picard (tight linear solves and the relative
  criterion, as ``tools/solver_stack_series.py`` sets them: Picard solves
  for the whole solution, so its increment cannot fall below the linear
  tolerance times the solution) for 2 steps, and the linearized solve for
  2 steps; the iterations of every step equal the JAX driver's stored
  runs and the solutions lie within 1e-10 of their max-abs (measured
  3.5e-15 and 2.7e-14).
- The solvers' control flow against the JAX classes on the same scripted
  callbacks: Picard's relative mode, its stall accept at the solve noise
  floor and its failure past the iteration budget; the linearized solve's
  one solve; the factory's kinds.
"""

import gzip
import json
import os

import numpy as np
import pytest

from ns_gls_tpu.solvers import nonlinear as jnl
from ns_gls_tpu_torch.solvers import nonlinear as tnl
from ns_gls_tpu_torch.utils.device import torch_threads
from ns_gls_tpu_torch.utils.logging import set_verbose
from test_torch_ilu_amg import check_run, port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIES = os.path.join(ROOT, "validation", "solver_stack_series.json.gz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    set_verbose(False)
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def series():
    with gzip.open(SERIES, "rt") as f:
        return json.load(f)["runs"]


@pytest.mark.parametrize("case", ["picard", "linearized"])
def test_driver_matches_jax(series, case):
    drv = port_run(series[case])
    kind = {"picard": tnl.NonLinearSolverPicard,
            "linearized": tnl.NonLinearSolverLinearized}[case]
    assert isinstance(drv.nonlinear_solver, kind)
    assert not drv.op.increment_form    # the fixed-point flavor
    check_run(drv, series[case])


def _scripted(solver, solutions):
    """Wire ``solver`` to callbacks that return ``solutions`` one after
    the other from the linear solve; records the calls."""
    calls = []
    it = iter(solutions)
    solver.setup_jacobian = lambda u: calls.append("jac")
    solver.setup_preconditioner = lambda u: calls.append("pre")
    solver.evaluate_rhs = lambda: calls.append("rhs") or 0.0
    solver.solve_with_jacobian = lambda rhs: next(it)
    return calls


def _both(make, solutions, start):
    """Run the JAX and the port solver (``make(module)``) on the same
    scripted solutions (numpy for JAX, torch for the port): (iterations,
    residual, calls, error) of each."""
    import jax.numpy as jnp
    import torch

    out = []
    for mod, conv in ((jnl, jnp.asarray), (tnl, torch.as_tensor)):
        s = make(mod)
        calls = _scripted(s, [conv(x) for x in solutions])
        try:
            s.solve(conv(start))
            err = None
        except RuntimeError as e:
            err = type(e).__name__
        out.append((getattr(s, "last_iterations", None),
                    float(getattr(s, "last_residual", np.nan)), calls, err))
    return out


def _seq(norms):
    """Solutions whose successive increments have the given norms."""
    x = np.zeros(4)
    out = []
    for n in norms:
        x = x + np.array([n, 0.0, 0.0, 0.0])
        out.append(x.copy() + 1e3)
    return out


@pytest.mark.parametrize("norms,relative", [
    ([1.0, 1e-3, 1e-6, 1e-9], False),          # converges absolutely
    ([1.0, 1e-3, 1e-6], True),                  # relative: 1e-7 * ||u||
    ([1.0, 1e-2, 1e-3, 5e-3], True),            # stalls, accepted
    ([1.0] * 40, False),                        # budget exhausted
])
def test_picard_control_flow_matches_jax(norms, relative):
    js, ts = _both(lambda m: m.make_nonlinear_solver(
        "Picard", tolerance=1e-7, relative=relative, max_iterations=30),
        _seq(norms), np.full(4, 1e3))
    assert ts[3] == js[3]
    assert ts[2] == js[2]
    if js[3] is None:
        assert ts[0] == js[0]
        assert ts[1] == pytest.approx(js[1], rel=1e-12)


def test_linearized_and_factory():
    js, ts = _both(lambda m: m.make_nonlinear_solver("linearized"),
                   [np.ones(4)], np.zeros(4))
    assert ts[2] == js[2] == ["jac", "rhs", "pre"]
    assert isinstance(tnl.make_nonlinear_solver("Newton"),
                      tnl.NonLinearSolverNewton)
    with pytest.raises(ValueError):
        tnl.make_nonlinear_solver("Anderson")
