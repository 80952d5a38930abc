"""The port's aggregation AMG (Jacobi mode) against the JAX package's
``PreconditionerAMG`` on an extruded-mesh Q2 Newton operator in f64 on
the CPU: aggregates, level sizes, ELL matrices, inverse diagonals,
damping factors and one V-cycle apply agree to 1e-10 relative (both sides
assemble the same f64 element matrices and sum in other orders).  The
structure-frozen value refresh equals a host (scipy) Galerkin chain built
from the same aggregates at a new linearization point, and the GMG
coarse solver picks AMG above 8000 coarse DoFs, as in JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
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
from ns_gls_tpu_torch.fem.constraints import AffineConstraints as TAff
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh import generators as tgen
from ns_gls_tpu_torch.ops.assembly import element_matrices
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
)
from ns_gls_tpu_torch.precond.amg import PreconditionerAMG as TAMG
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


TOL = 1e-10
F64 = torch.float64
# the GMG coarse level's parameter set with a small coarsest level, so
# that this small problem aggregates (with q-wise delta 1620 -> 1044
# DoFs and the next coarsening stalls on the pressure block, as it does
# on Turek 3D)
AMG_KW = dict(theta=0.02, n_smooth=3, max_coarse=40)


def prism_mesh(gen, n_refine=1):
    m2 = gen.subdivided_hyper_rectangle((2, 2), (0.0, 0.0), (1.1, 0.9))
    m2.lattice = None
    mesh = gen.extrude(m2, 2, 0.7)
    for _ in range(n_refine):
        mesh = mesh.refine()
    return mesh


def _ops(dtype_j=jnp.float64, dtype_t=F64, n_refine=1, cell_wise=False):
    sj = JSpace(prism_mesh(jgen, n_refine), 2)
    st = TSpace(prism_mesh(tgen, n_refine), 2)
    bn = st.boundary_nodes([0])
    # no-slip on boundary 0 and a pressure pin, as the driver sets them:
    # without the pin the constant pressure mode makes the coarsest
    # matrix singular and the V-cycle ill-posed
    bj = JAff(sj.n_nodes, 4)
    bj.add_dirichlet(bn, [0, 1, 2])
    bj.add_line(bj.dof(0, 3))
    bt = TAff(st.n_nodes, 4)
    bt.add_dirichlet(bn, [0, 1, 2])
    bt.add_line(bt.dof(0, 3))
    caj = bj.close(dtype_j)
    cat = bt.close(dtype_t, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.1, 0.08):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0, increment_form=True,
              cell_wise_stabilization=cell_wise)
    opj = JOp(sj, caj, caj, time_integrator=tij, dtype=dtype_j, **kw)
    opt = TOp(st, cat, cat, time_integrator=tit, dtype=dtype_t,
              device="cpu", **kw)
    opj.constraints_inhomogeneous = caj
    opt.constraints_inhomogeneous = cat
    rng = np.random.default_rng(0)
    hist = [rng.standard_normal((st.n_nodes, 4)) for _ in range(3)]
    opj.set_previous_solution(JHist([jnp.asarray(h, dtype_j) for h in hist]))
    opt.set_previous_solution(THist.from_numpy(hist, dtype_t, "cpu"))
    return opj, opt, rng


def _lin(opj, opt, u):
    opj.set_linearization_point(jnp.asarray(u))
    opt.set_linearization_point(torch.as_tensor(u))


def _close(a, ref, tol=TOL):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, err


def _lu_matrix(lu, piv, base):
    """The matrix that LAPACK-style factors (lu, piv) stand for; ``base``
    is the index base of the pivots (torch 1, scipy/JAX 0).  Compared
    instead of the factors: the two LU routines may pick other pivots
    where candidates tie to round-off."""
    lu = np.asarray(lu, np.float64)
    L = np.tril(lu, -1) + np.eye(lu.shape[0])
    perm = np.arange(lu.shape[0])
    for i, p in enumerate(np.asarray(piv) - base):
        perm[[i, p]] = perm[[p, i]]
    return (L @ np.triu(lu))[np.argsort(perm)]


def _check_levels(jamg, tamg):
    ja = jamg.vmult_args
    assert len(ja.levels) == len(tamg.levels)
    assert tamg.level_sizes == ([int(lv.inv_diag.shape[0]) for lv in ja.levels]
                                + [int(ja.n_coarse)])
    for jl, tl in zip(ja.levels, tamg.levels):
        assert np.array_equal(np.asarray(jl.ell_cols), tl.ell_cols.numpy())
        if tl.ell_vals.numel():
            _close(tl.ell_vals.numpy(), jl.ell_vals)
        _close(tl.inv_diag.numpy(), jl.inv_diag)
        _close(float(tl.omega), float(jl.omega))
        assert np.array_equal(np.asarray(jl.agg), tl.agg.numpy())
    _close(_lu_matrix(*tamg.coarse_lu, 1), _lu_matrix(*ja.coarse_lu, 0))


@pytest.mark.parametrize("cell_wise", [False, True])
def test_amg_hierarchy_and_vcycle(cell_wise):
    """Level 0 applies the operator (matrix-free) in both packages; the
    two stabilization modes give other matrices on the same structure."""
    opj, opt, rng = _ops(cell_wise=cell_wise)
    u = rng.standard_normal((opt.n_nodes, 4))
    _lin(opj, opt, u)
    jamg = JAMG(opj, matrix_free_fine=True, **AMG_KW)
    tamg = TAMG(opt, **AMG_KW)
    jamg.initialize()
    tamg.initialize()
    # q-wise delta: the second coarsening stalls on the pressure block;
    # cell-wise: two aggregation levels
    assert tamg.level_sizes == ([1620, 696, 460] if cell_wise
                                else [1620, 1044])
    assert tamg.levels[0].ell_vals.numel() == 0
    for (ja, na), (ta, nt) in zip(jamg._frozen_aggs, tamg._frozen_aggs):
        assert na == nt and np.array_equal(ja, ta)
    _check_levels(jamg, tamg)
    b = rng.standard_normal((opt.n_nodes, 4))
    _close(tamg.vmult(torch.as_tensor(b)).numpy(), jamg.vmult(jnp.asarray(b)))

    # a later setup keeps the aggregates and refreshes the values
    u2 = 0.5 * rng.standard_normal((opt.n_nodes, 4))
    _lin(opj, opt, u2)
    jamg.initialize()
    tamg.initialize()
    _check_levels(jamg, tamg)
    _close(tamg.vmult(torch.as_tensor(b)).numpy(), jamg.vmult(jnp.asarray(b)))


def test_refresh_equals_host_galerkin_chain():
    """The slot-map refresh against scipy: masked assembly, P^T A P per
    frozen aggregation level, inverse diagonal, Gershgorin damping and the
    coarsest dense matrix, at a linearization point the aggregates were
    not built from.  Level 0 stores no ELL matrix (it is matrix-free);
    its assembly shows in its diagonal, its damping and the levels
    below it."""
    _, opt, rng = _ops()
    opt.set_linearization_point(torch.as_tensor(
        rng.standard_normal((opt.n_nodes, 4))))
    tamg = TAMG(opt, **AMG_KW)
    tamg.initialize()
    opt.set_linearization_point(torch.as_tensor(
        2.0 * rng.standard_normal((opt.n_nodes, 4))))
    tamg.initialize()                       # the frozen refresh

    C = 4
    emat = element_matrices(opt).numpy()
    g = (opt.space.cell_nodes.astype(np.int64)[:, :, None] * C
         + np.arange(C)).reshape(len(emat), -1)
    nl = g.shape[1]
    n = opt.n_nodes * C
    A = sp.coo_matrix((emat.reshape(-1), (np.repeat(g, nl, axis=1).reshape(-1),
                                          np.tile(g, (1, nl)).reshape(-1))),
                      shape=(n, n)).tocsr()
    mask = np.ones(n, bool)
    mask[opt.constraints_homogeneous.rows.numpy()] = False
    D = sp.diags(mask.astype(float))
    A = (D @ A @ D + sp.diags((~mask).astype(float))).tocsr()
    for lvl, (agg_dofs, n_agg) in zip(tamg.levels, tamg._frozen_aggs):
        vals, cols = lvl.ell_vals.numpy(), lvl.ell_cols.numpy()
        if vals.size:
            rows = np.repeat(np.arange(vals.shape[0]), vals.shape[1])
            E = sp.coo_matrix((vals.reshape(-1), (rows, cols.reshape(-1))),
                              shape=A.shape).toarray()
            _close(E, A.toarray())
        d = A.diagonal()
        inv = np.where(np.abs(d) > 1e-12, 1.0 / d, 1.0)
        _close(lvl.inv_diag.numpy(), inv)
        rs = np.asarray(abs(A).sum(axis=1)).ravel() * np.abs(inv)
        _close(float(lvl.omega), 1.0 / max(rs.max(), 1.0))
        Pm = sp.coo_matrix((np.ones(A.shape[0]),
                            (np.arange(A.shape[0]), agg_dofs)),
                           shape=(A.shape[0], n_agg * C)).tocsr()
        A = (Pm.T @ A @ Pm).tocsr()
    _close(_lu_matrix(*tamg.coarse_lu, 1), A.toarray())


def test_gmg_coarse_picks_amg_above_8000_dofs():
    """"direct" keeps the dense LU up to 8000 coarse DoFs and switches to
    AMG (matrix-free level 0) above, as the JAX package does; "AMG" asks
    for it at any size; the AMG takes the ILU smoother (since it was
    ported) and refuses a smoother it does not know."""
    from ns_gls_tpu_torch.precond.gmg import PreconditionerGMG

    _, big, rng = _ops(n_refine=2, dtype_t=torch.float32)
    assert big.n_nodes * 4 > 8000
    big.set_linearization_point(torch.as_tensor(
        rng.standard_normal((big.n_nodes, 4)), dtype=torch.float32))
    gmg = PreconditionerGMG([big], [], coarse_grid_solver="direct",
                            coarse_amg_default_parameters=False)
    gmg.initialize()
    assert gmg.coarse_lu is None and gmg.coarse_amg is not None
    assert gmg.coarse_amg.levels[0].ell_vals.numel() == 0   # matrix-free
    assert (gmg.coarse_amg.theta, gmg.coarse_amg.n_smooth,
            gmg.coarse_amg.max_coarse) == (0.02, 3, 1000)
    r = torch.as_tensor(rng.standard_normal((big.n_nodes, 4)),
                        dtype=torch.float32)
    assert torch.equal(gmg._coarse_apply(r), gmg.coarse_amg.vmult(r))

    _, small, _ = _ops(n_refine=0)
    assert small.n_nodes * 4 <= 8000
    for solver, lu in (("direct", True), ("AMG", False)):
        g = PreconditionerGMG([small], [], coarse_grid_solver=solver)
        g.initialize()
        assert (g.coarse_lu is not None) == lu
        assert (g.coarse_amg is None) == lu
    assert TAMG(small, smoother="ilu").smoother == "ilu"
    with pytest.raises(ValueError):
        TAMG(small, smoother="gauss-seidel")
