"""The port's general-sweep GLS operator against the JAX operator in f64:
vmult, residual and rhs for every flavor x {cell-wise, q-wise} delta x
{consider_dt on, off}, plus the Jacobi diagonal, the dense (constrained)
coarse matrix and the dense direct solver.

Tolerance 1e-12 relative to the reference's max-abs: both sides evaluate
the same f64 formulas and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ns_gls_tpu.driver as jdrv
import ns_gls_tpu_torch.driver as tdrv
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh.cylinder import cylinder_mesh_2d as jmesh
from ns_gls_tpu.models.cylinder import SimulationCylinder as JCyl
from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator as JOp
from ns_gls_tpu.ops.time_integration import (
    BDFIntegrator as JBDF,
    SolutionHistory as JHist,
    ThetaIntegrator as JTheta,
)
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_2d as tmesh
from ns_gls_tpu_torch.models.cylinder import SimulationCylinder as TCyl
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
    ThetaIntegrator as TTheta,
)

TOL = 1e-12


def _refine(m, n):
    for _ in range(n):
        m = m.refine()
    return m


def make_pair(n_ref, increment, cell_wise, consider_dt, fuse=False,
              theta=None):
    """JAX and port operators on the Turek 2D mesh (curved cells), with
    the driver's constraints, a BDF-2 (or theta) history and a
    linearization point, all from one numpy seed."""
    sj = JSpace(_refine(jmesh(), n_ref), 2)
    st = TSpace(_refine(tmesh(), n_ref), 2)
    cj = jdrv.ConstraintSetBuilder(sj, JCyl(2).get_boundary_descriptor(),
                                   jnp.float64)
    ct = tdrv.ConstraintSetBuilder(st, TCyl(2).get_boundary_descriptor(),
                                   torch.float64, "cpu")
    if theta is None:
        tij, tit = JBDF(2), TBDF(2)
    else:
        tij, tit = JTheta(theta), TTheta(theta)
    for dt in (0.01, 0.008):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.001, c_1=0.2, c_2=0.3, consider_time_derivative=consider_dt,
              increment_form=increment, cell_wise_stabilization=cell_wise,
              fuse_tables=fuse)
    opj = JOp(sj, cj.homogeneous, cj.full, time_integrator=tij,
              dtype=jnp.float64, **kw)
    opt = TOp(st, ct.homogeneous, ct.full, time_integrator=tit,
              dtype=torch.float64, device="cpu", **kw)
    opj.constraints_inhomogeneous = cj.inhomogeneous_at(0.005)
    opt.constraints_inhomogeneous = ct.inhomogeneous_at(0.005)

    rng = np.random.default_rng(0)
    hist = [rng.standard_normal((st.n_nodes, 3)) for _ in range(3)]
    u = hist[0] * 1.5
    opj.set_previous_solution(JHist([jnp.asarray(h) for h in hist]))
    opt.set_previous_solution(THist.from_numpy(hist, torch.float64, "cpu"))
    opj.set_linearization_point(jnp.asarray(u))
    opt.set_linearization_point(torch.as_tensor(u))
    return opj, opt, u, rng


def _close(a, ref, tol=TOL):
    a = np.asarray(a)
    ref = np.asarray(ref)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("consider_dt", [True, False])
@pytest.mark.parametrize("cell_wise", [True, False])
@pytest.mark.parametrize("increment", [True, False])
def test_general_sweep_parity(increment, cell_wise, consider_dt):
    opj, opt, u, rng = make_pair(1, increment, cell_wise, consider_dt)
    assert opt._p2sweep is None               # f64: the general sweep
    v = rng.standard_normal(u.shape)
    _close(opt.vmult(torch.as_tensor(v)).numpy(), opj.vmult(jnp.asarray(v)))
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           opj.evaluate_residual(jnp.asarray(u)))
    _close(opt.evaluate_rhs().numpy(), opj.evaluate_rhs())
    assert opt.get_max_u(torch.as_tensor(u)) == pytest.approx(
        opj.get_max_u(jnp.asarray(u)), rel=TOL)


@pytest.mark.parametrize("fuse,theta", [(True, None), (False, 0.5),
                                        (True, 0.5)])
def test_fused_tables_and_theta(fuse, theta):
    """Fused (vector-stored) linearization and the theta method's old
    gradient tables."""
    opj, opt, u, rng = make_pair(1, False, False, True, fuse=fuse,
                                 theta=theta)
    v = rng.standard_normal(u.shape)
    _close(opt.vmult(torch.as_tensor(v)).numpy(), opj.vmult(jnp.asarray(v)))
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           opj.evaluate_residual(jnp.asarray(u)))


@pytest.mark.parametrize("increment", [True, False])
def test_diagonal_and_dense_matrix(increment):
    from ns_gls_tpu.ops.assembly import (
        assemble_dense_device,
        compute_diagonal,
        compute_inverse_diagonal,
    )
    from ns_gls_tpu_torch.ops import assembly as ta

    opj, opt, u, _ = make_pair(0, increment, False, True)
    _close(ta.compute_diagonal(opt).numpy(), compute_diagonal(opj))
    _close(ta.compute_inverse_diagonal(opt).numpy(),
           compute_inverse_diagonal(opj))
    A_t = ta.assemble_dense(opt).numpy()
    A_j = np.asarray(assemble_dense_device(opj))
    _close(A_t, A_j)
    # the dense matrix is the operator: A v == vmult(v)
    v = np.random.default_rng(3).standard_normal(u.shape)
    _close((A_t @ v.reshape(-1)).reshape(u.shape),
           opt.vmult(torch.as_tensor(v)).numpy())


def test_direct_solver_and_jacobi():
    """The dense direct solver and the Jacobi preconditioner against the
    JAX ones on the same operator (f64; the LU solves differ by pivoting
    round-off only, 1e-10 relative)."""
    from ns_gls_tpu.precond.jacobi import PreconditionerJacobi as JJac
    from ns_gls_tpu.solvers.linear import LinearSolverDirect as JDirect
    from ns_gls_tpu_torch.precond.jacobi import PreconditionerJacobi as TJac
    from ns_gls_tpu_torch.solvers.linear import LinearSolverDirect as TDirect

    opj, opt, u, rng = make_pair(0, True, False, True)
    b = rng.standard_normal(u.shape)
    x_t = TDirect(opt).solve(torch.as_tensor(b))
    _close(x_t.numpy(), JDirect(opj).solve(jnp.asarray(b)), tol=1e-10)
    _close(opt.vmult(x_t).numpy(), b, tol=1e-10)
    _close(TJac(opt).vmult(torch.as_tensor(b)).numpy(),
           JJac(opj).vmult(jnp.asarray(b)))
