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
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


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
    assert opt._fast is None                  # f64: the general sweep
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


def _port_operator(space, constraints, increment, cell_wise, fuse,
                   dtype=torch.float64):
    """A port operator (f64 unless ``dtype`` says) with a BDF-2 history
    and a linearization point from one numpy seed."""
    it = TBDF(2)
    for dt in (0.01, 0.008):
        it.update_dt(dt)
    op = TOp(space, constraints.homogeneous, constraints.full, nu=0.001,
             c_1=0.2, c_2=0.3, time_integrator=it,
             increment_form=increment, cell_wise_stabilization=cell_wise,
             fuse_tables=fuse, dtype=dtype, device="cpu")
    rng = np.random.default_rng(0)
    hist = [rng.standard_normal((space.n_nodes, space.dim + 1))
            for _ in range(3)]
    op.set_previous_solution(THist.from_numpy(hist, dtype, "cpu"))
    op.set_linearization_point(torch.as_tensor(hist[0] * 1.5, dtype=dtype))
    return op


@pytest.fixture(scope="module")
def diagonal_spaces():
    """The Turek 2D mesh at refinement 1 (Q1 and Q2) and the Turek 3D
    mesh (400 cells, Q2), with the driver's constraint sets, built once;
    by (dim, degree)."""
    from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_3d

    out = {}
    for dim, degree, mesh in ((2, 1, _refine(tmesh(), 1)),
                              (2, 2, _refine(tmesh(), 1)),
                              (3, 2, cylinder_mesh_3d())):
        space = TSpace(mesh, degree)
        out[dim, degree] = (space, tdrv.ConstraintSetBuilder(
            space, TCyl(dim).get_boundary_descriptor(), torch.float64,
            "cpu"))
    return out


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("cell_wise", [True, False])
@pytest.mark.parametrize("increment", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_diagonal_from_qpoint_blocks(diagonal_spaces, dim, increment,
                                     cell_wise, fuse):
    """``compute_diagonal`` (the q-point physics of each basis function
    alone) against the diagonals of the ``jacfwd`` element matrices
    summed into the nodes, with ones on the constrained rows."""
    from ns_gls_tpu_torch.ops import assembly as ta

    op = _port_operator(*diagonal_spaces[dim, 2], increment, cell_wise,
                        fuse)
    C = op.n_comp
    emat = ta.element_matrices(op)
    d_loc = torch.diagonal(emat, dim1=1, dim2=2).reshape(len(emat), -1, C)
    ref = np.zeros((op.n_nodes, C))
    np.add.at(ref, op.batch.cell_nodes.numpy(), d_loc.numpy())
    rows = op.constraints_homogeneous.rows.numpy()
    assert len(rows)
    ref.reshape(-1)[rows] = 1.0
    diag = ta.compute_diagonal(op).numpy()
    _close(diag, ref)
    assert np.all(diag.reshape(-1)[rows] == 1.0)


@pytest.mark.parametrize("cell_wise", [True, False])
@pytest.mark.parametrize("increment", [True, False])
@pytest.mark.parametrize("degree", [1, 2])
def test_element_diagonals_bits_f32(diagonal_spaces, degree, increment,
                                    cell_wise):
    """In f32, as the multigrid levels keep them, ``element_diagonals``
    gives the ``jacfwd`` element matrices' diagonals to the bit on the
    CPU: the same physics on the same numbers and the same
    (n_loc x K) (K x C) products.  The driver tests with f32 levels
    count GMRES iterations that follow the diagonal's last bit."""
    from ns_gls_tpu_torch.ops import assembly as ta

    op = _port_operator(*diagonal_spaces[2, degree], increment, cell_wise,
                        True, dtype=torch.float32)
    emat = ta.element_matrices(op)
    ref = torch.diagonal(emat, dim1=1, dim2=2).reshape(len(emat), -1,
                                                        op.n_comp)
    got = ta.element_diagonals(op)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref), (got != ref).sum().item()


def _qpoint_inputs(d, seed):
    """Random q-point component lists (64 points) for the physics of
    ``ops/structured.py`` in d dimensions, as numpy arrays."""
    rng = np.random.default_rng(seed)

    def v():
        return rng.standard_normal(64)

    return dict(
        u_val=[v() for _ in range(d)],
        u_grad=[[v() for _ in range(d)] for _ in range(d)],
        p_val=v(),
        p_grad=[v() for _ in range(d)],
        u_star=[v() for _ in range(d)],
        gus=[[v() for _ in range(d)] for _ in range(d)],
        gps=[v() for _ in range(d)],
        dt_old=[v() for _ in range(d)],
        d1=np.abs(v()),
        d2=np.abs(v()),
    )


def _tree(x, f):
    return [_tree(a, f) for a in x] if isinstance(x, list) else f(x)


SC_PHYS = dict(weight=187.5, stau=100.0, nu=0.001, c1=2.0, c2=1.0)


@pytest.mark.parametrize("consider_dt", [True, False])
@pytest.mark.parametrize("flavor", ["fixed", "increment", "residual"])
@pytest.mark.parametrize("d", [2, 3])
def test_qpoint_physics_parity(d, flavor, consider_dt):
    """The fused sweeps' q-point physics (``_physics``) in 2D and 3D
    against the JAX package's, every flavor with and without the time
    derivative in the stabilization."""
    from ns_gls_tpu.ops.structured import _physics as jphys
    from ns_gls_tpu_torch.ops.structured import _physics as tphys

    x = _qpoint_inputs(d, 7)
    keys = ("u_val", "u_grad", "p_val", "p_grad", "u_star", "gus", "gps",
            "dt_old", "d1", "d2")
    args_j = [_tree(x[k], jnp.asarray) for k in keys]
    args_t = [_tree(x[k], torch.as_tensor) for k in keys]
    sc_j = {k: jnp.asarray(v) for k, v in SC_PHYS.items()}
    sc_t = {k: torch.tensor(v, dtype=torch.float64) for k, v in SC_PHYS.items()}
    vj, gj = jphys(d, flavor, sc_j, *args_j, consider_dt)
    vt, gt = tphys(d, flavor, sc_t, *args_t, consider_dt)
    assert len(vt) == len(gt) == d + 1
    for c in range(d + 1):
        _close(vt[c].numpy(), vj[c])
        for x_ in range(d):
            _close(gt[c][x_].numpy(), gj[c][x_])


@pytest.mark.parametrize("cell_wise", [True, False])
def test_delta_parity(cell_wise):
    """delta_1 / delta_2, cell-wise (with the viscous switch: h on both
    sides of nu) and per q-point, against the JAX package's."""
    from ns_gls_tpu.ops.structured import _delta as jdelta
    from ns_gls_tpu_torch.ops.structured import _delta as tdelta

    rng = np.random.default_rng(11)
    h1 = np.concatenate([rng.uniform(1e-4, 5e-4, 32),
                         rng.uniform(2e-3, 5e-2, 32)])
    hq = rng.uniform(1e-3, 5e-2, 64)
    usq = rng.uniform(0.0, 6.0, 64)
    sc_j = {k: jnp.asarray(v) for k, v in SC_PHYS.items()}
    sc_t = {k: torch.tensor(v, dtype=torch.float64) for k, v in SC_PHYS.items()}
    mx, q = (usq, None) if cell_wise else (None, usq)
    dj = jdelta(sc_j, jnp.asarray(h1), jnp.asarray(hq),
                None if mx is None else jnp.asarray(mx),
                None if q is None else jnp.asarray(q), cell_wise)
    dt = tdelta(sc_t, torch.as_tensor(h1), torch.as_tensor(hq),
                None if mx is None else torch.as_tensor(mx),
                None if q is None else torch.as_tensor(q), cell_wise)
    for a, b in zip(dt, dj):
        _close(np.broadcast_to(a.numpy(), (64,)),
               np.broadcast_to(np.asarray(b), (64,)))


def make_pair_3d(increment, cell_wise):
    """JAX and port f64 operators on the Turek 3D mesh at refinement 0
    (400 cells, Q2), with the driver's constraint sets."""
    from ns_gls_tpu.models.cylinder import SimulationCylinder as JC
    from ns_gls_tpu_torch.models.cylinder import SimulationCylinder as TC

    sj = JSpace(JC(3).create_mesh(0), 2)
    st = TSpace(TC(3).create_mesh(0), 2)
    cj = jdrv.ConstraintSetBuilder(sj, JC(3).get_boundary_descriptor(),
                                   jnp.float64)
    ct = tdrv.ConstraintSetBuilder(st, TC(3).get_boundary_descriptor(),
                                   torch.float64, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.01, 0.008):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.001, c_1=2.0, c_2=1.0, consider_time_derivative=True,
              increment_form=increment, cell_wise_stabilization=cell_wise)
    opj = JOp(sj, cj.homogeneous, cj.full, time_integrator=tij,
              dtype=jnp.float64, **kw)
    opt = TOp(st, ct.homogeneous, ct.full, time_integrator=tit,
              dtype=torch.float64, device="cpu", **kw)
    opj.constraints_inhomogeneous = cj.inhomogeneous_at(0.05)
    opt.constraints_inhomogeneous = ct.inhomogeneous_at(0.05)
    rng = np.random.default_rng(0)
    hist = [rng.standard_normal((st.n_nodes, 4)) for _ in range(3)]
    u = hist[0] * 1.5
    opj.set_previous_solution(JHist([jnp.asarray(h) for h in hist]))
    opt.set_previous_solution(THist.from_numpy(hist, torch.float64, "cpu"))
    opj.set_linearization_point(jnp.asarray(u))
    opt.set_linearization_point(torch.as_tensor(u))
    return opj, opt, u, rng


@pytest.mark.parametrize("increment,cell_wise", [(True, False),
                                                 (False, True)])
def test_general_sweep_parity_3d(increment, cell_wise):
    """The f64 general sweep (the 3D fine level) on the Turek 3D mesh."""
    opj, opt, u, rng = make_pair_3d(increment, cell_wise)
    assert opt._fast is None                  # f64: the general sweep
    v = rng.standard_normal(u.shape)
    _close(opt.vmult(torch.as_tensor(v)).numpy(), opj.vmult(jnp.asarray(v)))
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           opj.evaluate_residual(jnp.asarray(u)))


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
