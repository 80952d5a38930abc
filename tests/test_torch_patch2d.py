"""The port's patch-2D sweep (its plain PyTorch version, which the CUDA
kernel is held to on the card) against the JAX package's Pallas patch-2D
kernel, run as the JAX package's own tests run it on the CPU (interpret
mode through ``use_structured=True``), and against the port's own f32
general sweep, on uniformly refined meshes and on adaptive ones of
several patch families; the kernel's split into thread blocks and the
seam table of its cell-row tiles.

Both sides run in f32 with different summation orders, so the tolerance
is 1e-5 relative to the max-abs of the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.fem.constraints import AffineConstraints as JAff, distribute
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh.cylinder import cylinder_mesh_2d as jmesh
from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator as JOp
from ns_gls_tpu.ops.time_integration import (
    BDFIntegrator as JBDF,
    SolutionHistory as JHist,
)
from ns_gls_tpu_torch.fem.constraints import AffineConstraints as TAff
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_2d as tmesh
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops import patch2d as tp2
from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
)
from ns_gls_tpu_torch.utils.device import torch_threads
from ns_gls_tpu_torch.utils.segment import seam_sum_plain
from ns_gls_tpu_torch.utils.timer import counters


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


TOL = 1e-5
F32 = torch.float32


def _refine(m, n):
    for _ in range(n):
        m = m.refine()
    return m


def _setup(n_ref, increment, cell_wise, consider_dt, degree=2):
    """JAX Pallas-interpret operator, port patch-2D operator and port
    general-sweep operator (all f32) on the curved Turek 2D mesh refined
    n_ref times (patches of m = 2**n_ref cells per axis), of ``degree``."""
    out = _setup_on(_refine(jmesh(), n_ref), _refine(tmesh(), n_ref),
                    increment, cell_wise, consider_dt, degree)
    assert out[1]._fast.m == 2**n_ref
    return out


def _setup_on(mj, mt, increment, cell_wise, consider_dt, degree):
    """The three operators of ``_setup`` on the JAX mesh ``mj`` and the
    port's equal mesh ``mt``."""
    sj = JSpace(mj, degree)
    st = TSpace(mt, degree)
    bn = st.boundary_nodes([0])
    vals = [[1.0, 0.0]] * len(bn)
    bj = JAff(sj.n_nodes, 3)
    bj.add_dirichlet(bn, [0, 1], values=vals)
    bt = TAff(st.n_nodes, 3)
    bt.add_dirichlet(bn, [0, 1], values=vals)
    caj = bj.close(jnp.float32)
    cat = bt.close(F32, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.1, 0.08):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0, consider_time_derivative=consider_dt,
              increment_form=increment, cell_wise_stabilization=cell_wise)
    opj = JOp(sj, caj, caj, time_integrator=tij, fuse_tables=True,
              dtype=jnp.float32, use_structured=True, **kw)
    opt = TOp(st, cat, cat, time_integrator=tit, dtype=F32, device="cpu",
              **kw)
    opg = TOp(st, cat, cat, time_integrator=tit, dtype=F32, device="cpu",
              use_structured=False, **kw)
    assert opj._p2sweep is not None and isinstance(opt._fast, Patch2DSweep)
    assert opg._fast is None

    rng = np.random.default_rng(0)
    u = np.asarray(distribute(caj, jnp.asarray(
        rng.standard_normal((st.n_nodes, 3)), jnp.float32)))
    hist = [u] + [rng.standard_normal((st.n_nodes, 3)).astype(np.float32)
                  for _ in range(2)]
    opj.constraints_inhomogeneous = caj
    opj.set_previous_solution(JHist([jnp.asarray(h) for h in hist]))
    opj.set_linearization_point(jnp.asarray(u))
    for op in (opt, opg):
        op.constraints_inhomogeneous = cat
        op.set_previous_solution(THist.from_numpy(hist, F32, "cpu"))
        op.set_linearization_point(torch.as_tensor(u))
    v = rng.standard_normal(u.shape).astype(np.float32)
    return opj, opt, opg, u, v


def _close(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= TOL, err


@pytest.mark.parametrize("cell_wise", [True, False])
@pytest.mark.parametrize("increment", [True, False])
@pytest.mark.parametrize("n_ref", [0, 1, 2])
def test_plain_patch2d_vs_pallas(n_ref, increment, cell_wise):
    """Flavors: increment (vmult of the Newton operator), fixed (vmult of
    the fixed-point operator) and residual, at m = 1, 2 and 4."""
    opj, opt, opg, u, v = _setup(n_ref, increment, cell_wise, True)
    ref_v = opj.vmult(jnp.asarray(v))
    _close(opt.vmult(torch.as_tensor(v)).numpy(), ref_v)
    _close(opg.vmult(torch.as_tensor(v)).numpy(), ref_v)
    if increment:
        ref_r = opj.evaluate_residual(jnp.asarray(u))
        _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(), ref_r)
        _close(opg.evaluate_residual(torch.as_tensor(u)).numpy(), ref_r)


@pytest.mark.parametrize("cell_wise", [True, False])
def test_plain_patch2d_vs_pallas_no_dt(cell_wise):
    """consider_dt off.  The Pallas kernel (and so the port) leaves the
    BDF history out of the residual flavor when consider_dt is off, where
    the general sweep keeps it (ROADMAP, faults); the increment flavor
    agrees with the general sweep as well."""
    opj, opt, opg, u, v = _setup(1, True, cell_wise, False)
    ref_v = opj.vmult(jnp.asarray(v))
    _close(opt.vmult(torch.as_tensor(v)).numpy(), ref_v)
    _close(opg.vmult(torch.as_tensor(v)).numpy(), ref_v)
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           opj.evaluate_residual(jnp.asarray(u)))


@pytest.mark.parametrize("cell_wise", [True, False])
@pytest.mark.parametrize("increment", [True, False])
@pytest.mark.parametrize("degree,n_ref", [(1, 1), (1, 2), (3, 0), (3, 1)])
def test_plain_patch2d_vs_pallas_degrees(degree, n_ref, increment,
                                         cell_wise):
    """The other degrees the kernel is built for: Q1 (``turek_2d_re20.json``)
    at m = 2 and 4, Q3 at m = 1 and 2; every flavor, both delta modes."""
    opj, opt, opg, u, v = _setup(n_ref, increment, cell_wise, True, degree)
    assert [t.P for t in opt._fast.tables.fams] == [degree]
    ref_v = opj.vmult(jnp.asarray(v))
    _close(opt.vmult(torch.as_tensor(v)).numpy(), ref_v)
    _close(opg.vmult(torch.as_tensor(v)).numpy(), ref_v)
    ref_r = opj.evaluate_residual(jnp.asarray(u))
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(), ref_r)


@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 6])
def test_patch2d_plan_covers_every_cell_row_once(P):
    """The CUDA kernel's split (``ops/patch2d.py`` ``patch2d_plan``: one
    block per patch, x brick and y chunk, walking slabs of cell rows) at
    every patch size m = 1-64, for one patch and for Turek 2D's 88: the
    bricks tile the cell row, the chunks own each cell row once, a slab is
    no deeper than its chunk, the launcher's own chunking agrees, the
    thread limits hold and a block's shared memory fits the card's 227 KB
    in every flavor."""
    for m in range(1, 65):
        for n_patches in (1, 88):
            plan = tp2.patch2d_plan(P, m, n_patches)
            assert m % plan.xb == 0 and plan.nbx * plan.xb == m
            owned = []
            for ky in range(plan.nyb):
                yb, ye = ky * plan.yc, min((ky + 1) * plan.yc, m)
                assert ye > yb
                owned += range(yb, ye)
            assert owned == list(range(m))
            # the launcher recomputes the chunk from nyb
            assert -(-m // plan.nyb) == plan.yc
            assert 1 <= plan.ys <= plan.yc
            assert tp2._plan_ok(P, plan.xb, plan.ys)
            for flavor in tp2.FLAVORS:
                for cdt in (True, False):
                    assert tp2.smem_bytes(P, plan.xb, plan.ys, plan.yc,
                                          flavor, cdt) <= 232448


def test_patch2d_plan_refuses_other_degrees():
    """A degree the kernel can have no instance for (below 1) is refused
    with a clear message when the plan is made, before any launch; a
    degree above the common library's 1-6 plans, its instance built on
    demand (the first degree whose block exceeds the card's shared
    memory is refused: ``test_torch_patch3d.py``,
    ``test_degree_5_raises_at_table_build``)."""
    for P in (0, -1):
        with pytest.raises(ValueError, match="degrees 1 and up"):
            tp2.patch2d_plan(P, 8, 88)
    assert tp2.patch2d_plan(7, 8, 88).xb >= 1


def _turek_tables(n_ref, degree=2):
    st = TSpace(_refine(tmesh(), n_ref), degree)
    ca = TAff(st.n_nodes, 3).close(F32, "cpu")
    ti = TBDF(2)
    ti.update_dt(0.1)
    op = TOp(st, ca, ca, time_integrator=ti, dtype=F32, device="cpu",
             nu=0.02, c_1=4.0, c_2=2.0)
    return op._fast.tables


@pytest.mark.parametrize("xb", [1, 2, 4])
def test_seam_rows_cover_every_node(xb):
    """Turek 2D ref 2 (m = 4, 88 patches in their coarse cells' own
    frames): the seam table lists every row of the cell-row tiles once,
    each under the node its lattice id names, ascending, and every node
    has as many rows as the tiles hold it: per patch, 1 or 2 cell rows
    (a node row between two cell rows) times 1 or 2 bricks (a node column
    between two bricks); the counts come from the lattices alone."""
    ft = tp2.replan(_turek_tables(2), tp2.Patch2DPlan(xb, 4 // xb, 1, 1, 4))
    (t,) = ft.fams
    P, m = t.P, t.m
    pn = t.patch_nodes.numpy().astype(np.int64)
    off = ft.seams.offsets.numpy().astype(np.int64)
    src = ft.seams.sources.numpy().astype(np.int64)
    rows = tp2.tile_nodes(pn, P, m, xb).reshape(-1)
    assert len(off) == t.n_nodes + 1 and off[-1] == len(rows)
    assert np.array_equal(np.sort(src), np.arange(len(rows)))
    node_of = np.repeat(np.arange(t.n_nodes), np.diff(off))
    assert np.array_equal(rows[src], node_of)
    for n in range(t.n_nodes):
        assert (np.diff(src[off[n]:off[n + 1]]) > 0).all()
    Xn = P * m + 1
    edge = np.arange(Xn)
    ry = np.where((edge % P == 0) & (edge > 0) & (edge < Xn - 1), 2, 1)
    rx = np.where((edge % (P * xb) == 0) & (edge > 0) & (edge < Xn - 1),
                  2, 1)
    want = np.zeros(t.n_nodes, np.int64)
    np.add.at(want, pn.reshape(-1),
              np.broadcast_to(ry[:, None] * rx[None, :], pn.shape[1:])
              .reshape(1, -1).repeat(pn.shape[0], 0).reshape(-1))
    assert np.array_equal(np.diff(off), want)
    assert (want >= 1).all()


def test_plain_bricks_agree():
    """The plain version under bricks of 1, 2 and 4 cells (1-4 tiles per
    cell row) at m = 4: the seam-summed sweeps agree with one another to
    f32 rounding in every flavor."""
    base = _turek_tables(2)
    rng = np.random.default_rng(3)
    u, ul, vo = (torch.as_tensor(rng.standard_normal((base.n_nodes, 3)),
                                 dtype=F32) for _ in range(3))
    sc = dict(weight=1.3, stau=2.0, nu=0.02, c1=4.0, c2=2.0)
    for flavor in tp2.FLAVORS:
        got = []
        for xb in (1, 2, 4):
            ft = tp2.replan(base, tp2.Patch2DPlan(xb, 4 // xb, 2, 2, 2))
            (t,) = ft.fams
            tiles = tp2.patch2d_sweep_plain(t, sc, u, ul, vo, flavor, True,
                                            False)
            assert tiles.shape == (t.jinv.shape[0], 4, 4 // xb, 3,
                                   2 * xb + 1, 3)
            got.append(seam_sum_plain(ft.seams, tiles.reshape(-1, 3)))
        for g in got[1:]:
            _close(g.numpy(), got[0].numpy())


def test_kernel_launch_raises_on_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only (the sweep runs the
    plain version for CPU tensors); it refuses before building anything."""
    (t,) = _turek_tables(1).fams
    u = torch.zeros((t.n_nodes, 3))
    sc = dict(weight=1.0, stau=1.0, nu=0.02, c1=4.0, c2=2.0)
    with pytest.raises(TypeError):
        tp2.Patch2DKernel.launch(t, sc, u, u, u, "increment", True, False)
    assert counters()["launch.patch2d_gls_sweep"] == 0


# ---------------------------------------------------------------------------
# adaptive meshes: several patch families
# ---------------------------------------------------------------------------
# the patch sizes of the families of each mesh
FAMILIES = {"adaptive": [1, 2, 4], "rotation": [1, 2]}


def _family_meshes(case):
    """(JAX mesh, port mesh, degree): the JAX package's
    ``tests/test_patch2d.py`` ``adaptive_mesh`` (Q2) or
    ``input/rotation.json``'s annulus at refinement 2 (Q1)."""
    if case == "rotation":
        from ns_gls_tpu.models.rotation import SimulationRotation as JRot
        from ns_gls_tpu_torch.models.rotation import SimulationRotation as TRot

        return JRot(2).create_mesh(2), TRot(2).create_mesh(2), 1
    from ns_gls_tpu.mesh.generators import subdivided_hyper_rectangle as jr
    from ns_gls_tpu_torch.mesh.generators import (
        subdivided_hyper_rectangle as tr,
    )

    out = []
    for rect in (jr, tr):
        m = rect((3, 2), (0.0, 0.0), (1.1, 0.9))
        m.lattice = None
        m = m.refine_global(1)
        c = m.vertices[m.cells].mean(1)
        out.append(m.refine(c[:, 0] < 0.5))
    return out[0], out[1], 2


@pytest.mark.parametrize("consider_dt", [True, False])
@pytest.mark.parametrize("cell_wise", [True, False])
@pytest.mark.parametrize("increment", [True, False])
@pytest.mark.parametrize("case", ["adaptive", "rotation"])
def test_plain_families_vs_pallas(case, increment, cell_wise, consider_dt):
    """Several patch families: the plain sweep of every family, then one
    seam sum over their concatenated tiles, against the JAX package's
    multi-family Pallas path (``Patch2DTablesAdaptive``, interpret mode)
    in every flavor (increment and fixed vmults, the residual), delta
    mode and consider_dt; the vmult also against the port's general
    sweep."""
    mj, mt, degree = _family_meshes(case)
    opj, opt, opg, u, v = _setup_on(mj, mt, increment, cell_wise,
                                    consider_dt, degree)
    assert [t.m for t in opt._fast.tables.fams] == FAMILIES[case]
    ref_v = opj.vmult(jnp.asarray(v))
    _close(opt.vmult(torch.as_tensor(v)).numpy(), ref_v)
    _close(opg.vmult(torch.as_tensor(v)).numpy(), ref_v)
    if increment:
        # the residual flavor (the same in both forms)
        _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
               opj.evaluate_residual(jnp.asarray(u)))


@pytest.mark.parametrize("case", ["adaptive", "rotation"])
def test_family_seam_rows_cover_every_node(case):
    """The one seam table of several families: every row of the
    concatenated tiles once, in family order (family f's rows start after
    the rows of the families before it), under the node its family's
    lattice names, ascending; every node has a row; and the whole sweep
    is the per-family plain sweeps summed."""
    _, mt, degree = _family_meshes(case)
    st = TSpace(mt, degree)
    ca = TAff(st.n_nodes, 3).close(F32, "cpu")
    ti = TBDF(2)
    ti.update_dt(0.1)
    op = TOp(st, ca, ca, time_integrator=ti, dtype=F32, device="cpu",
             nu=0.02, c_1=4.0, c_2=2.0)
    tables = op._fast.tables
    assert [t.m for t in tables.fams] == FAMILIES[case]
    rows = np.concatenate([
        tp2.tile_nodes(t.patch_nodes.numpy().astype(np.int64), t.P, t.m,
                       t.plan.xb).reshape(-1) for t in tables.fams])
    assert len(rows) == sum(tp2.tile_rows(t) for t in tables.fams)
    off = tables.seams.offsets.numpy().astype(np.int64)
    src = tables.seams.sources.numpy().astype(np.int64)
    assert len(off) == st.n_nodes + 1 and off[-1] == len(rows)
    assert (np.diff(off) >= 1).all()
    assert np.array_equal(np.sort(src), np.arange(len(rows)))
    node_of = np.repeat(np.arange(st.n_nodes), np.diff(off))
    assert np.array_equal(rows[src], node_of)
    for n in range(st.n_nodes):
        assert (np.diff(src[off[n]:off[n + 1]]) > 0).all()

    rng = np.random.default_rng(5)
    u, ul, vo = (torch.as_tensor(rng.standard_normal((st.n_nodes, 3)),
                                 dtype=F32) for _ in range(3))
    sc = dict(weight=1.3, stau=2.0, nu=0.02, c1=4.0, c2=2.0)
    for flavor in tp2.FLAVORS:
        tiles = tp2.patch2d_tiles(tables, sc, u, ul, vo, flavor, True, False)
        assert tiles.shape == (len(rows), 3)
        whole = seam_sum_plain(tables.seams, tiles)
        parts = torch.zeros_like(whole)
        for t in tables.fams:
            ft = tp2.patch2d_sweep_plain(t, sc, u, ul, vo, flavor, True,
                                         False).reshape(-1, 3)
            parts.index_add_(0, torch.as_tensor(tp2._tile_targets(t)), ft)
        _close(whole.numpy(), parts.numpy())
