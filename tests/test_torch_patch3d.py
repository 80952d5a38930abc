"""The port's patch-3D sweep (its plain PyTorch version, which the CUDA
kernel is held to on the card) against the Pallas patch-3D kernel, run as
the JAX package's own tests run it on the CPU (interpret mode through
``use_structured=True``), at Q1 on a general (non-extruded) 3D mesh
refined once (patches of m = 2 cells per axis): the three flavors (the
fixed or increment vmult and the residual of every case), both delta
modes and consider_dt on and off.  The operator's dispatch and gates.
``tests/test_torch_patch3d_sphere.py`` holds the single-cell patches
(m = 1) and the Gmsh sphere.

Both sides run in f32 with different summation orders: 5e-6 relative to
the reference's max-abs, as the JAX package's own patch-3D tests use.
"""

import dataclasses

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
from ns_gls_tpu_torch.mesh.gmsh import read_msh as tread
from ns_gls_tpu_torch.models.sphere import MESH_FILE
from ns_gls_tpu_torch.ops import patch2d as tp2
from ns_gls_tpu_torch.ops import patch3d as tp3
from ns_gls_tpu_torch.ops import prism as tpr
from ns_gls_tpu_torch.ops import structured as tst
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


TOL = 5e-6
F32 = torch.float32


def general3d_mesh(gen, n_refine=1):
    """General 3D mesh with a refinement chain and no extrusion metadata,
    so the prism path cannot claim it (the JAX package's
    ``tests/test_patch3d.py`` mesh)."""
    m2 = gen.subdivided_hyper_rectangle((2, 2), (0.0, 0.0), (1.1, 0.9))
    m2.lattice = None
    mesh = gen.extrude(m2, 2, 0.7)
    mesh = dataclasses.replace(mesh, extr_mesh2d=None, extr_cell2d=None,
                               extr_layer=None)
    for _ in range(n_refine):
        mesh = mesh.refine()
    return mesh


def sphere_mesh(read, n_refine=1):
    from ns_gls_tpu_torch.mesh.core import SphericalManifold

    mesh = read(MESH_FILE)
    mesh.manifolds[0] = SphericalManifold(np.zeros(3))
    mesh.attach_manifold_to_boundary_id(0, 0)
    return mesh.refine_global(n_refine)


def _setup(mesh_j, mesh_t, degree, increment, cell_wise, consider_dt,
           jax_patch3d, m):
    """JAX operator (Pallas patch-3D kernel in interpret mode, or the
    general sweep) and the port's patch-3D operator, all f32, with one
    numpy seed."""
    sj = JSpace(mesh_j, degree)
    st = TSpace(mesh_t, degree)
    assert st.patch3d and not st.prism and not st.structured
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
              dtype=jnp.float32, use_structured=jax_patch3d, **kw)
    opt = TOp(st, cat, cat, time_integrator=tit, dtype=F32, device="cpu",
              **kw)
    assert (opj._p3sweep is not None) == jax_patch3d
    assert isinstance(opt._fast, tp3.Patch3DSweep) and opt._fast.m == m

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


def _check(opj, opt, u, v):
    """vmult (the increment or fixed flavor) and the residual flavor."""
    _close(opt.vmult(torch.as_tensor(v)).numpy(),
           opj.vmult(jnp.asarray(v)))
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           opj.evaluate_residual(jnp.asarray(u)))


@pytest.mark.parametrize("consider_dt,increment,cell_wise", [
    (True, True, False), (True, False, True), (False, True, True),
    (False, False, False),
])
def test_plain_patch3d_vs_pallas_q1(consider_dt, increment, cell_wise):
    """Each case checks its vmult (increment or fixed flavor) and the
    residual: increment and fixed each in both delta modes and with
    consider_dt on and off, the residual in all four combinations.
    Without consider_dt the residual drops the BDF history on both sides
    (the JAX kernel's ``need_dt_old``; ROADMAP queue 3)."""
    opj, opt, u, v = _setup(general3d_mesh(jgen), general3d_mesh(tgen), 1,
                            increment, cell_wise, consider_dt, True, 2)
    _check(opj, opt, u, v)


def test_residual_without_consider_dt_drops_history():
    """The queue-3 entry itself: with consider_dt off the patch-3D
    residual equals the residual with a zero history (the Pallas kernel
    does the same: ``test_plain_patch3d_vs_pallas_q1[False-False-False]``),
    while the JAX general sweep keeps the history."""
    opg, opt, u, _ = _setup(general3d_mesh(jgen), general3d_mesh(tgen), 1,
                            True, False, False, False, 2)
    r_port = opt.evaluate_residual(torch.as_tensor(u)).numpy()
    r_general = np.asarray(opg.evaluate_residual(jnp.asarray(u)))
    assert np.abs(r_general - r_port).max() > 1e-2 * np.abs(r_port).max()
    opt.set_previous_vectors(torch.zeros_like(opt.state.u_lin),
                             torch.zeros_like(opt.state.u_lin))
    _close(r_port, opt.evaluate_residual(torch.as_tensor(u)).numpy())


def test_patch3d_gates_and_dispatch():
    """A sphere f32 operator picks patch-3D; f64, the theta method and
    an iso-Q1 space get None, as in JAX.  The prism and structured
    spaces keep their own sweeps."""
    mesh = sphere_mesh(tread)
    space = TSpace(mesh, 1)
    ti = TBDF(1)
    ti.update_dt(0.1)
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0)
    ca = TAff(space.n_nodes, 4).close(F32, "cpu")
    op = TOp(space, ca, ca, time_integrator=ti, dtype=F32, device="cpu", **kw)
    assert isinstance(op._fast, tp3.Patch3DSweep)
    ca64 = TAff(space.n_nodes, 4).close(torch.float64, "cpu")
    op64 = TOp(space, ca64, ca64, time_integrator=ti, dtype=torch.float64,
               device="cpu", **kw)
    assert op64._fast is None and tp3.build_patch3d_tables(op64) is None
    th = TTheta(0.5)
    th.update_dt(0.1)
    opth = TOp(space, ca, ca, time_integrator=th, dtype=F32, device="cpu",
               **kw)
    assert opth._fast is None and tp3.build_patch3d_tables(opth) is None
    iso = TSpace(mesh.prev, 2, iso_q1=True)
    assert not iso.patch3d
    caiso = TAff(iso.n_nodes, 4).close(F32, "cpu")
    opiso = TOp(iso, caiso, caiso, time_integrator=ti, dtype=F32,
                device="cpu", **kw)
    assert opiso._fast is None

    from ns_gls_tpu_torch.models.channel import SimulationChannel

    m2 = tgen.subdivided_hyper_rectangle((2, 2), (0.0, 0.0), (1.1, 0.9))
    m2.lattice = None
    prism_space = TSpace(tgen.extrude(m2, 2, 0.7).refine(), 1)
    cap = TAff(prism_space.n_nodes, 4).close(F32, "cpu")
    opp = TOp(prism_space, cap, cap, time_integrator=ti, dtype=F32,
              device="cpu", **kw)
    assert isinstance(opp._fast, tpr.PrismSweep)
    ch = TSpace(SimulationChannel(3).create_mesh(-2), 1)
    cac = TAff(ch.n_nodes, 4).close(F32, "cpu")
    opc = TOp(ch, cac, cac, time_integrator=ti, dtype=F32, device="cpu",
              **kw)
    assert isinstance(opc._fast, tst.StructuredSweep)


# the largest patch the JAX package's FESpace merges at each degree
# (``ns_gls_tpu/fem/space.py:482-484``)
M_CAP = {1: 64, 2: 32, 3: 32, 4: 16}


def covers_once(n: int, chunk: int, n_chunks: int) -> bool:
    """Chunks [k*chunk, min((k+1)*chunk, n)) own each of 0 .. n-1 once."""
    owned = []
    for k in range(n_chunks):
        lo, hi = k * chunk, min((k + 1) * chunk, n)
        if hi <= lo:
            return False
        owned += range(lo, hi)
    return owned == list(range(n))


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_patch3d_plan_covers_every_layer_once(P):
    """The CUDA kernel's split (``ops/patch3d.py`` ``patch3d_plan``: one
    block per patch, cell row, x brick and z chunk; a chunk that does not
    start the column also walks the layer below it) at every patch size
    the JAX package builds at this degree, in every flavor x consider_dt:
    a plan exists; one brick for every flavor, the whole row where it
    fits; the bricks own each cell column once and the chunks each cell
    layer once; a block owns at most two I1 columns a thread, a slab is no
    deeper than a walk and a block's shared memory fits the card."""
    m = 1
    while m <= M_CAP[P]:
        xb = tp3.patch3d_brick(P, m, 48)
        for flavor in tp3.FLAVORS:
            for cdt in (True, False):
                plan = tp3.patch3d_plan(P, m, 48, flavor, cdt)
                assert (plan.xb, plan.nbx) == (xb, m // xb)
                assert covers_once(m, plan.xb, plan.nbx)
                assert 4 * (P + 1) * (P * plan.xb + 1) <= 2 * 256
                assert covers_once(m, plan.zc, plan.nzb)
                walk = plan.zc + (1 if plan.nzb > 1 else 0)
                assert 1 <= plan.zs <= walk
                assert tp3.smem_bytes(P, plan.xb, plan.zs, walk, flavor,
                                      cdt) <= tp3.SMEM_PER_BLOCK
        if 4 * (P + 1) * (P * m + 1) <= 2 * 256 and (P, m) != (2, 32):
            assert xb == m
        m *= 2


def test_patch3d_bricks_match_whole_rows():
    """The plain sweep on tables split into x bricks of one cell (the
    layout the kernel writes at large patches), seam-summed, gives the
    nodes what the whole-row tables give, in every flavor."""
    from ns_gls_tpu_torch.utils.segment import seam_sum

    _, opt, u, v = _setup(general3d_mesh(jgen), general3d_mesh(tgen), 1,
                          True, False, True, False, 2)
    whole = opt._fast.tables
    bricks = tp3.build_patch3d_tables(opt, xb=1)
    assert whole.xb == 2 and bricks.xb == 1
    assert bricks.plans[("increment", True)].nbx == 2
    sc = dict(weight=18.75, stau=12.5, nu=0.02, c1=4.0, c2=2.0)
    rng = np.random.default_rng(3)
    u, ul, vo = (torch.as_tensor(rng.standard_normal((whole.n_nodes, 4)),
                                 dtype=F32) for _ in range(3))
    for flavor in tp3.FLAVORS:
        for cell_wise in (True, False):
            args = (sc, u, ul, vo, flavor, True, cell_wise)
            ref = seam_sum(whole.seams,
                           tp3.patch3d_sweep_plain(whole, *args).reshape(-1, 4))
            got = seam_sum(bricks.seams,
                           tp3.patch3d_sweep_plain(bricks, *args)
                           .reshape(-1, 4))
            _close(got.numpy(), ref.numpy())


@pytest.mark.parametrize("kind", ["patch3d", "prism", "patch2d",
                                  "structured"])
def test_degree_5_raises_at_table_build(kind):
    """The port's kernels take any degree whose smallest thread block fits
    the card's shared memory (degrees 1-6 from the common library, others
    from a library built for them; before that, degree 5 and then 7 was
    the first refused degree, hence the name).  An f32 operator of the
    first degree that does not fit raises when its tables are built,
    before any launch, naming the card's limit (on the CPU too): degree 8
    for the patch-3D kernel, 9 for the prism and structured 3D ones; the
    2D kernels' first such degree is far above any space the tests can
    build, so their plans are asked for it directly."""
    from ns_gls_tpu_torch.models.channel import SimulationChannel

    match = "the card's 232448 bytes a block"
    if kind == "patch2d":
        P = next(P for P in range(8, 100)
                 if tp2.smem_bytes(P, 1, 1, 1, "increment", True)
                 > tst.SMEM_PER_BLOCK)
        with pytest.raises(ValueError, match=match):
            tp2.patch2d_plan(P, 1, 1)
        tp2.patch2d_plan(P - 1, 1, 1)
        return
    if kind == "patch3d":
        mesh, P = general3d_mesh(tgen, 0), 8
    elif kind == "prism":
        m2 = tgen.subdivided_hyper_rectangle((2, 2), (0.0, 0.0), (1.1, 0.9))
        m2.lattice = None
        mesh, P = tgen.extrude(m2, 2, 0.7), 9
    else:
        mesh, P = SimulationChannel(3).create_mesh(-2), 9
    space = TSpace(mesh, P)
    ti = TBDF(1)
    ti.update_dt(0.1)
    ca = TAff(space.n_nodes, space.dim + 1).close(F32, "cpu")
    with pytest.raises(ValueError, match=match):
        TOp(space, ca, ca, nu=0.02, c_1=4.0, c_2=2.0, time_integrator=ti,
            dtype=F32, device="cpu")
