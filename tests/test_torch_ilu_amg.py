"""The port's ILU preconditioner, the AMG's ILU smoother, standalone AMG,
the ILU GMG coarse solver and Richardson against the JAX package, in f64
on the CPU.

- ILU: the port's apply (SuperLU's solve on the host) equals the JAX
  ``PreconditionerILU.vmult`` to 1e-12 relative: both factor the same
  constrained matrix, which the two packages assemble from element
  matrices that agree to round-off.
- The AMG's ILU smoother: the port's ``ilu_apply`` on its level-0
  factors equals the JAX package's ``ilu_apply`` on its own to 1e-12
  relative, and one V-cycle of each (matrix-free level 0, as the driver
  builds the standalone AMG) to 1e-12 relative.
- Standalone AMG with the ILU smoother as GMRES's preconditioner: the
  iteration counts of the two packages within 1.
- Driver steps under ILU, the ILU GMG coarse solver and Richardson (f64
  GMG levels, so that no f32 rounding decides a count; the multigrid's
  power iterations started from the JAX package's vectors): the nonlinear
  and linear iterations of every step equal the JAX driver's, stored by
  ``tools/solver_stack_series.py``, and the solutions within 1e-10 of their
  max-abs (measured 2.7e-15, 2.3e-15 and 2.2e-15).
"""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.fem.constraints import AffineConstraints as JAff
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh import generators as jgen
from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator as JOp
from ns_gls_tpu.ops.time_integration import (
    BDFIntegrator as JBDF,
    SolutionHistory as JHist,
)
from ns_gls_tpu.precond.amg import PreconditionerAMG as JAMG
from ns_gls_tpu.precond.ilu import PreconditionerILU as JILU
from ns_gls_tpu.solvers.linear import gmres as jgmres
from ns_gls_tpu_torch.config import Parameters
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.fem.constraints import AffineConstraints as TAff
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh import generators as tgen
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
)
from ns_gls_tpu_torch.precond.gmg import PreconditionerGMG
from ns_gls_tpu_torch.precond.amg import PreconditionerAMG as TAMG
from ns_gls_tpu_torch.precond.amg import ilu_apply
from ns_gls_tpu_torch.precond.ilu import PreconditionerILU as TILU
from ns_gls_tpu_torch.solvers.linear import gmres as tgmres
from ns_gls_tpu_torch.utils.device import torch_threads
from ns_gls_tpu_torch.utils.logging import set_verbose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIES = os.path.join(ROOT, "validation", "solver_stack_series.json.gz")
F64 = torch.float64
TOL = 1e-12
# a small coarsest AMG level, so that this small problem aggregates
MAX_COARSE = 40


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


def _ops(cells=(12, 8), increment=True):
    """The JAX and port f64 operators of Q1 on a rectangle of ``cells``
    (no-slip on boundary 0 and a pressure pin, BDF-2), at one seeded
    linearization point."""
    def mesh(gen):
        m = gen.subdivided_hyper_rectangle(cells, (0.0, 0.0), (1.2, 1.0),
                                           colorize=True)
        m.lattice = None
        return m

    sj, st = JSpace(mesh(jgen), 1), TSpace(mesh(tgen), 1)
    bn = st.boundary_nodes([0])
    bj = JAff(sj.n_nodes, 3)
    bj.add_dirichlet(bn, [0, 1])
    bj.add_line(bj.dof(0, 2))
    bt = TAff(st.n_nodes, 3)
    bt.add_dirichlet(bn, [0, 1])
    bt.add_line(bt.dof(0, 2))
    caj, cat = bj.close(jnp.float64), bt.close(F64, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.1, 0.08):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0, increment_form=increment)
    opj = JOp(sj, caj, caj, time_integrator=tij, dtype=jnp.float64, **kw)
    opt = TOp(st, cat, cat, time_integrator=tit, dtype=F64, device="cpu",
              **kw)
    opj.constraints_inhomogeneous = caj
    opt.constraints_inhomogeneous = cat
    rng = np.random.default_rng(0)
    hist = [rng.standard_normal((st.n_nodes, 3)) for _ in range(3)]
    opj.set_previous_solution(JHist([jnp.asarray(h) for h in hist]))
    opt.set_previous_solution(THist.from_numpy(hist, F64, "cpu"))
    u = rng.standard_normal((st.n_nodes, 3))
    opj.set_linearization_point(jnp.asarray(u))
    opt.set_linearization_point(torch.as_tensor(u))
    return opj, opt, rng


def _close(a, ref, tol=TOL):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def test_ilu_apply_equals_jax():
    opj, opt, rng = _ops()
    x = rng.standard_normal((opt.n_nodes, 3))
    ref = JILU(opj).vmult(jnp.asarray(x))
    pre = TILU(opt)
    got = pre.vmult(torch.as_tensor(x))
    _close(got.numpy(), ref)
    assert pre.n_applies == 1 and pre.apply_seconds > 0.0


def _jax_ilu_apply(amg):
    """The JAX package's ``ilu_apply``: a closure of the AMG's V-cycle."""
    fn = amg.vmult_pure
    return fn.__closure__[fn.__code__.co_freevars.index("ilu_apply")] \
        .cell_contents


def test_amg_ilu_smoother_equals_jax():
    opj, opt, rng = _ops()
    amj = JAMG(opj, max_coarse=MAX_COARSE, matrix_free_fine=True,
               smoother="ilu")
    amt = TAMG(opt, max_coarse=MAX_COARSE, smoother="ilu")
    args = amj.vmult_args
    amt.initialize()
    assert len(args.levels) == len(amt.levels) == len(amt.ilu) >= 1
    r = rng.standard_normal(opt.n_nodes * 3)
    for lvl_j, f_t in zip(args.levels, amt.ilu):
        n = f_t.udi.shape[0]
        _close(ilu_apply(f_t, torch.as_tensor(r[:n])).numpy(),
               _jax_ilu_apply(amj)(lvl_j.ilu, jnp.asarray(r[:n])))
    x = rng.standard_normal((opt.n_nodes, 3))
    _close(amt.vmult(torch.as_tensor(x)).numpy(),
           amj.vmult(jnp.asarray(x)))


def test_standalone_amg_gmres_counts():
    """GMRES on the Newton system under standalone AMG with the ILU
    smoother: iteration counts within 1 of JAX's, and the same iterate.
    On this saddle-point system at a random state the aggregation AMG is
    a weak preconditioner in both packages: GMRES stops where a restart
    no longer reduces the residual, short of the tolerance.  The iterates
    are compared after 5 Arnoldi steps: on this ill-conditioned system
    each step amplifies the packages' round-off (measured 7.5e-12 after 5
    steps, 7.7e-10 after 10, 3.8e-6 after 30)."""
    opj, opt, rng = _ops()
    amj = JAMG(opj, max_coarse=MAX_COARSE, matrix_free_fine=True,
               smoother="ilu")
    amt = TAMG(opt, max_coarse=MAX_COARSE, smoother="ilu")
    amt.initialize()
    b = rng.standard_normal((opt.n_nodes, 3))
    tol = 1e-8 * float(np.linalg.norm(b))
    rj = jgmres(opj.vmult_pure, opj.vmult_args, jnp.asarray(b),
                jnp.zeros(b.shape), M=amj.vmult_pure, m_args=amj.vmult_args,
                tol=tol)
    rt = tgmres(opt.vmult, torch.as_tensor(b), torch.zeros(b.shape,
                                                           dtype=F64),
                M=amt.vmult, tol=tol)
    assert abs(int(rj.iterations) - rt.iterations) <= 1, (
        int(rj.iterations), rt.iterations)
    rj = jgmres(opj.vmult_pure, opj.vmult_args, jnp.asarray(b),
                jnp.zeros(b.shape), M=amj.vmult_pure, m_args=amj.vmult_args,
                tol=tol, restart=5, max_restarts=1)
    rt = tgmres(opt.vmult, torch.as_tensor(b), torch.zeros(b.shape,
                                                           dtype=F64),
                M=amt.vmult, tol=tol, restart=5, max_restarts=1)
    assert int(rj.iterations) == rt.iterations == 5
    _close(rt.x.numpy(), rj.x, tol=1e-10)


def jax_start(level, shape, dtype, device):
    """The JAX multigrid's power-iteration start vectors (PRNGKey(31 +
    level)) as the port's ``power_start``."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    v = jax.random.normal(jax.random.PRNGKey(31 + level), shape, jdt)
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def port_run(run):
    """The port's driver on the CPU on a stored run's configuration for
    its steps, the multigrid's power iterations started from the JAX
    package's vectors."""
    drv = Driver(Parameters.from_dict(run["config"]), device="cpu")
    drv.setup()
    drv._setup_done = True
    if isinstance(drv.preconditioner, PreconditionerGMG):
        drv.preconditioner.power_start = jax_start
    drv.run(max_steps=run["steps"])
    return drv


def check_run(drv, run, tol=1e-10):
    """Iterations per step equal to the stored JAX run's, the solution
    within ``tol`` of its max-abs."""
    assert [s["newton"] for s in drv.step_stats] == run["nonlinear"]
    assert [s["gmres"] for s in drv.step_stats] == run["linear"]
    _close(drv.solution.current.numpy(), run["solution"], tol=tol)


@pytest.mark.parametrize("case", ["ilu", "gmg_ilu_coarse", "richardson"])
def test_driver_counts_equal_jax(series, case):
    check_run(port_run(series[case]), series[case])
