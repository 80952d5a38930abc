"""The port's prism sweep (its plain PyTorch version, which the CUDA
kernel is held to on the card) against the JAX package: at Q1 against the
Pallas prism kernel, run as the JAX package's own tests run it on the CPU
(interpret mode through ``use_structured=True``), and at Q2 against the
JAX general sweep (``use_structured=False``; the interpret-mode Q2 kernel
is slow-marked in the JAX tests).  Both on an extruded mesh whose 2D
factor is unstructured, refined once (patches of m = 2 cells per axis).

Both sides run in f32 with different summation orders: 5e-6 relative to
the reference's max-abs, as the JAX package's own prism tests use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.fem.constraints import AffineConstraints as JAff, distribute
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh import generators as jgen
from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator as JOp
from ns_gls_tpu.ops.time_integration import (
    BDFIntegrator as JBDF,
    SolutionHistory as JHist,
)
from ns_gls_tpu_torch.fem.constraints import AffineConstraints as TAff
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh import generators as tgen
from ns_gls_tpu_torch.ops import prism as tp
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
    ThetaIntegrator as TTheta,
)

TOL = 5e-6
F32 = torch.float32


def prism_mesh(gen, n_refine=1):
    """Extruded mesh with an unstructured 2D factor and a refinement
    chain (the JAX package's ``tests/test_prism.py`` mesh)."""
    m2 = gen.subdivided_hyper_rectangle((2, 2), (0.0, 0.0), (1.1, 0.9))
    m2.lattice = None  # force the unstructured (prism) code path
    mesh = gen.extrude(m2, 2, 0.7)
    for _ in range(n_refine):
        mesh = mesh.refine()
    return mesh


def _setup(degree, increment, cell_wise, consider_dt, jax_prism):
    """JAX operator (Pallas prism kernel in interpret mode, or the general
    sweep) and the port's prism operator, all f32, with one numpy seed."""
    sj = JSpace(prism_mesh(jgen), degree)
    st = TSpace(prism_mesh(tgen), degree)
    assert st.prism and not st.structured
    bn = st.boundary_nodes([0])
    vals = [[1.0, 0.0, 0.0]] * len(bn)
    bj = JAff(sj.n_nodes, 4)
    bj.add_dirichlet(bn, [0, 1, 2], values=vals)
    bt = TAff(st.n_nodes, 4)
    bt.add_dirichlet(bn, [0, 1, 2], values=vals)
    caj = bj.close(jnp.float32)
    cat = bt.close(F32, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.1, 0.08):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0, consider_time_derivative=consider_dt,
              increment_form=increment, cell_wise_stabilization=cell_wise)
    opj = JOp(sj, caj, caj, time_integrator=tij, fuse_tables=True,
              dtype=jnp.float32, use_structured=jax_prism, **kw)
    opt = TOp(st, cat, cat, time_integrator=tit, dtype=F32, device="cpu",
              **kw)
    assert (opj._psweep is not None) == jax_prism
    assert isinstance(opt._fast, tp.PrismSweep) and opt._fast.m == 2

    rng = np.random.default_rng(0)
    u = np.asarray(distribute(caj, jnp.asarray(
        rng.standard_normal((st.n_nodes, 4)), jnp.float32)))
    hist = [u] + [rng.standard_normal((st.n_nodes, 4)).astype(np.float32)
                  for _ in range(2)]
    opj.constraints_inhomogeneous = caj
    opj.set_previous_solution(JHist([jnp.asarray(h) for h in hist]))
    opj.set_linearization_point(jnp.asarray(u))
    opt.constraints_inhomogeneous = cat
    opt.set_previous_solution(THist.from_numpy(hist, F32, "cpu"))
    opt.set_linearization_point(torch.as_tensor(u))
    v = rng.standard_normal(u.shape).astype(np.float32)
    return opj, opt, u, v


def _close(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= TOL, err


@pytest.mark.parametrize("consider_dt,increment,cell_wise", [
    (True, False, True), (True, True, False), (True, True, True),
    (True, False, False), (False, True, True), (False, False, False),
])
def test_plain_prism_vs_pallas_q1(consider_dt, increment, cell_wise):
    """Flavors: increment / fixed vmult and the residual, both delta
    modes, with and without the time derivative in the stabilization."""
    opj, opt, u, v = _setup(1, increment, cell_wise, consider_dt, True)
    _close(opt.vmult(torch.as_tensor(v)).numpy(),
           opj.vmult(jnp.asarray(v)))
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           opj.evaluate_residual(jnp.asarray(u)))


@pytest.mark.parametrize("increment,cell_wise", [(True, True),
                                                 (False, False)])
def test_prism_q2_vs_general_sweep(increment, cell_wise):
    """Q2 (the Turek 3D degree) against the JAX general sweep."""
    opj, opt, u, v = _setup(2, increment, cell_wise, True, False)
    _close(opt.vmult(torch.as_tensor(v)).numpy(),
           opj.vmult(jnp.asarray(v)))
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           opj.evaluate_residual(jnp.asarray(u)))


def test_prism_gates():
    """The theta method and f64 keep the general sweep, as in JAX."""
    space = TSpace(prism_mesh(tgen, 0), 1)
    ca = TAff(space.n_nodes, 4).close(F32, "cpu")
    ti = TTheta(0.5)
    ti.update_dt(0.1)
    op = TOp(space, ca, ca, nu=0.02, c_1=4.0, c_2=2.0, time_integrator=ti,
             dtype=F32, device="cpu")
    assert op._fast is None and tp.prism_cell_geometry(op) is None
    ti2 = TBDF(1)
    ti2.update_dt(0.1)
    ca64 = TAff(space.n_nodes, 4).close(torch.float64, "cpu")
    op2 = TOp(space, ca64, ca64, nu=0.02, c_1=4.0, c_2=2.0,
              time_integrator=ti2, dtype=torch.float64, device="cpu")
    assert op2._fast is None
    op3 = TOp(space, ca, ca, nu=0.02, c_1=4.0, c_2=2.0, time_integrator=ti2,
              dtype=F32, device="cpu")
    assert isinstance(op3._fast, tp.PrismSweep)


@pytest.mark.parametrize("degree", [1, 2])
def test_seam_compress_is_multiplicity(degree):
    """Table parity: the patch gather, spread to cell rows and
    seam-compressed, gives each node its value times the number of
    cell-row tiles that hold it; at every node that number is at least
    the node's patch multiplicity, and the sweep's patch tiles agree with
    the JAX package's gather tables."""
    from ns_gls_tpu.ops.prism import build_prism_tables as jbuild

    st = TSpace(prism_mesh(tgen), degree)
    sj = JSpace(prism_mesh(jgen), degree)
    ti = TBDF(1)
    ti.update_dt(0.1)
    ca = TAff(st.n_nodes, 4).close(F32, "cpu")
    op = TOp(st, ca, ca, nu=0.02, c_1=4.0, c_2=2.0, time_integrator=ti,
             dtype=F32, device="cpu")
    sw = op._fast
    tab = sw.tables
    P, m = tab.P, tab.m
    rng = np.random.default_rng(5)
    vn = torch.as_tensor(rng.standard_normal((st.n_nodes, 4)), dtype=F32)
    v = vn.T.reshape(4, st.n2d, st.nz_nodes)        # the product layout
    tiles = sw.gather_nodes(vn, 4)
    rows = tiles[:, :, tp.cell_row_index(P, m)]       # (4, n_p, m, P+1, ...)
    out = sw.compress(rows)
    pn = tab.patch_nodes.numpy()
    count = np.bincount(pn[:, tp.cell_row_index(P, m)].reshape(-1),
                        minlength=st.n2d)
    np.testing.assert_allclose(out.numpy(), v.numpy() * count[None, :, None],
                               rtol=1e-6, atol=1e-6)
    assert (count >= st.node2d_mult).all()
    assert (count[st.node2d_mult == 1] <= 2).all()
    ones = sw.compress(torch.ones_like(rows))
    assert (ones.numpy() == count[None, :, None]).all()

    # the JAX tables: the same patch tiles, and JAX's seam-compress
    # classes give each node its patch multiplicity
    class _Op:
        space = sj
        theta = 1.0
        dtype = jnp.float32

    assert np.array_equal(np.asarray(sj.patch_nodes), pn)
    jt = jbuild(_Op)
    jmult = np.concatenate([np.full(len(idx), idx.shape[1])
                            for idx in jt.compress])
    assert np.array_equal(jmult, st.node2d_mult)
