"""The port's structured sweep (its plain PyTorch version, which the CUDA
kernels are held to on the card) against the JAX package, on the meshes of
the JAX package's ``tests/test_structured.py`` (3x2 and 3x2x2 cells, plain
and sheared): in 2D at Q1/Q2 and in 3D at Q1 against the Pallas kernels,
run as the JAX package's own tests run them on the CPU (interpret mode
through ``use_structured=True``), and in 3D at Q2 against the JAX general
sweep (``use_structured=False``; the interpret-mode Q2 3D kernel is
slow-marked in the JAX tests).

Both sides run in f32 with different summation orders (the Pallas
increment and fixed flavors also split their band products in bf16x3):
5e-6 relative to the reference's max-abs, as the JAX package's own
structured tests use.
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
from ns_gls_tpu_torch.ops import structured as ts
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


def lattice_mesh(gen, dim, shear=0.0, cells=(3, 2)):
    mesh = gen.subdivided_hyper_rectangle(
        cells + ((2,) if dim == 3 else ()),
        (0.0,) * dim,
        (1.2, 1.0) + ((0.8,) if dim == 3 else ()),
        colorize=True,
    )
    if shear:
        # sheared parallelogram lattice: structured and affine, with
        # off-diagonal Jacobian entries
        v = mesh.vertices.copy()
        v[:, 0] = v[:, 0] + shear * v[:, 1]
        mesh = dataclasses.replace(mesh, vertices=v)
    return mesh


def _setup(dim, degree, increment, cell_wise, consider_dt, jax_structured,
           shear=0.0, batched=False, cells=(3, 2)):
    """JAX operator (Pallas structured kernel in interpret mode, or the
    general sweep) and the port's structured operator, all f32, with one
    numpy seed."""
    C = dim + 1
    sj = JSpace(lattice_mesh(jgen, dim, shear, cells), degree)
    st = TSpace(lattice_mesh(tgen, dim, shear, cells), degree)
    assert st.structured
    bn = st.boundary_nodes([0])
    vals = [[1.0] + [0.0] * (dim - 1)] * len(bn)
    bj = JAff(sj.n_nodes, C)
    bj.add_dirichlet(bn, list(range(dim)), values=vals)
    bt = TAff(st.n_nodes, C)
    bt.add_dirichlet(bn, list(range(dim)), values=vals)
    caj = bj.close(jnp.float32)
    cat = bt.close(F32, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.1, 0.08):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0, consider_time_derivative=consider_dt,
              increment_form=increment, cell_wise_stabilization=cell_wise)
    opj = JOp(sj, caj, caj, time_integrator=tij, fuse_tables=True,
              dtype=jnp.float32, use_structured=jax_structured, **kw)
    opt = TOp(st, cat, cat, time_integrator=tit, dtype=F32, device="cpu",
              **kw)
    assert (opj._ssweep is not None) == jax_structured
    assert isinstance(opt._fast, ts.StructuredSweep)
    if batched:
        opt._fast = ts.StructuredSweep(opt, opt._fast.tables, batched=True)

    rng = np.random.default_rng(0)
    u = np.array(distribute(caj, jnp.asarray(
        rng.standard_normal((st.n_nodes, C)), jnp.float32)))
    hist = [u] + [rng.standard_normal((st.n_nodes, C)).astype(np.float32)
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
    _close(opt.vmult(torch.as_tensor(v)).numpy(), opj.vmult(jnp.asarray(v)))
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           opj.evaluate_residual(jnp.asarray(u)))


@pytest.mark.parametrize("degree,consider_dt,increment,cell_wise", [
    (1, True, False, True), (1, True, True, False), (2, True, True, True),
    (2, True, False, False), (1, False, True, True), (2, False, False, False),
    (2, False, True, False),
])
def test_plain_structured_2d_vs_pallas(degree, consider_dt, increment,
                                       cell_wise):
    """2D, Q1 and Q2: increment / fixed vmult and the residual, both
    delta modes, with and without the time derivative in the
    stabilization (without it the residual drops the history, in both
    packages)."""
    _check(*_setup(2, degree, increment, cell_wise, consider_dt, True))


@pytest.mark.parametrize("consider_dt,increment,cell_wise", [
    (True, False, False), (True, True, True), (False, True, False),
    (False, False, True),
])
def test_plain_structured_3d_q1_vs_pallas(consider_dt, increment, cell_wise):
    _check(*_setup(3, 1, increment, cell_wise, consider_dt, True))


@pytest.mark.parametrize("increment,cell_wise", [(True, True),
                                                 (False, False)])
def test_structured_3d_q2_vs_general_sweep(increment, cell_wise):
    """Q2 in 3D (the channel's and the operator benchmark's degree on the
    card) against the JAX general sweep."""
    _check(*_setup(3, 2, increment, cell_wise, True, False))


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_structured_sheared_vs_pallas(dim):
    """Sheared lattice: the full jinv contraction."""
    opj, opt, u, v = _setup(dim, 1, True, True, True, True, shear=0.35)
    ji = opt._fast.tables.jinv.reshape(-1, dim, dim)
    assert float(ji[:, 0, 1].abs().max()) > 0.1     # dxi_x/dx_y != 0
    _check(opj, opt, u, v)


def test_structured_q3_vs_general_sweep():
    """Degree 3 (two interior residue classes) against the JAX general
    sweep, 2D."""
    _check(*_setup(2, 3, True, True, True, False))


@pytest.mark.parametrize("increment", [True, False])
def test_batched_equals_unbatched_on_cpu(increment):
    """``batched=True`` picks another kernel on the card only; on the CPU
    both run the same plain version."""
    _, op_a, u, v = _setup(3, 1, increment, True, True, False)
    _, op_b, _, _ = _setup(3, 1, increment, True, True, False, batched=True)
    assert op_b._fast.batched and not op_a._fast.batched
    assert ts.StructuredKernel.kernel_name(3, True) == "structured3d_batched"
    assert ts.StructuredKernel.kernel_name(2, True) == "structured2d"
    a = op_a.vmult(torch.as_tensor(v))
    b = op_b.vmult(torch.as_tensor(v))
    assert torch.equal(a, b)


def _gate_op(space, ti, dtype):
    C = space.dim + 1
    ca = TAff(space.n_nodes, C).close(dtype, "cpu")
    return TOp(space, ca, ca, nu=0.02, c_1=4.0, c_2=2.0, time_integrator=ti,
               dtype=dtype, device="cpu")


@pytest.mark.parametrize("case", ["f64", "theta", "no_lattice", "curved",
                                  "off", "ok"])
def test_structured_gates(case):
    """f64, the theta method, a mesh without a lattice and a non-affine
    lattice give no structured sweep, as in the JAX package."""
    mesh = tgen.subdivided_hyper_rectangle((2, 2), (0.0, 0.0), (1.0, 1.0),
                                           colorize=True)
    ti = TBDF(1)
    ti.update_dt(0.1)
    dtype = F32
    if case == "f64":
        dtype = torch.float64
    elif case == "theta":
        ti = TTheta(0.5)
        ti.update_dt(0.1)
    elif case == "no_lattice":
        mesh.lattice = None
    elif case == "curved":
        v = mesh.vertices.copy()
        v[:, 0] = v[:, 0] * (1.0 + 0.2 * v[:, 1])
        mesh = dataclasses.replace(mesh, vertices=v)
    space = TSpace(mesh, 1)
    if case == "off":
        ca = TAff(space.n_nodes, 3).close(dtype, "cpu")
        op = TOp(space, ca, ca, nu=0.02, c_1=4.0, c_2=2.0,
                 time_integrator=ti, dtype=dtype, device="cpu",
                 use_structured=False)
    else:
        op = _gate_op(space, ti, dtype)
    if case == "ok":
        assert isinstance(op._fast, ts.StructuredSweep)
        assert op.state.u_linT.shape == (3, 3, 1, 3)
        assert op.state.vec_oldT.shape == (2, 3, 1, 3)
    else:
        # a mesh without a lattice still takes the patch-2D sweep
        assert not isinstance(op._fast, ts.StructuredSweep)
        assert (op._fast is None) == (case != "no_lattice")
        assert ts.build_structured_tables(op) is None or case == "off"


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (2, 3), (3, 1),
                                        (3, 2), (3, 3)])
def test_lattice_index_and_fold(dim, degree):
    """The class-grouped index map equals the FESpace numbering, and the
    kernel's output, folded, equals the scatter-add: in 3D the batched
    kernel's tiles and x seams under its own plan (:func:`brick_layout`),
    in 2D the lattice and x seams of the 2D kernel under its own plan
    (:func:`kernel_layout_2d`)."""
    st = TSpace(lattice_mesh(tgen, dim), degree)
    P = degree
    cs = tuple(st.cell_shape)
    lat = st.mesh.lattice
    perm = np.lexsort(tuple(lat[:, k] for k in range(dim)))
    idx = ts.lattice_cell_nodes(P, cs)
    assert np.array_equal(idx, st.cell_nodes[perm])
    shp = ts.lattice_shape(P, cs)
    assert int(np.prod(shp)) == st.n_nodes

    rng = np.random.default_rng(3)
    n1 = P + 1
    C = dim + 1
    r_loc = rng.standard_normal((C, idx.shape[0], n1 ** dim))
    ref = np.zeros((C, st.n_nodes))
    for c in range(C):
        np.add.at(ref[c], idx.reshape(-1), r_loc[c].reshape(-1))
    if dim == 2:
        plan = ts.slab_plan_2d(P, cs)
        lat, seams = kernel_layout_2d(r_loc, P, cs, plan)
        tab = ts.StructuredTables(d=2, P=P, NQ=n1, cell_shape=cs, S1=None,
                                  D1=None, jinv=None, jxw=None, h=None)
        out = ts.fold_seams_2d(tab, torch.as_tensor(lat),
                               torch.as_tensor(seams), plan.xb)
        assert tuple(out.shape) == (C,) + shp
        np.testing.assert_allclose(out.reshape(C, -1).numpy(), ref,
                                   rtol=1e-12, atol=1e-12)
        return
    # the 3D kernels' tiles and seams under the batched kernel's own plan
    plan = ts.batched_plan(P, cs)
    tiles, seams = brick_layout(r_loc, P, cs, plan)
    tab = ts.StructuredTables(d=dim, P=P, NQ=P + 1, cell_shape=cs,
                              S1=None, D1=None, jinv=None, jxw=None, h=None)
    out = ts.fold_bricks(tab, torch.as_tensor(tiles), torch.as_tensor(seams),
                         plan.xb)
    assert tuple(out.shape) == (C,) + shp
    np.testing.assert_allclose(out.reshape(C, -1).numpy(), ref, rtol=1e-12,
                               atol=1e-12)


def brick_layout(r_loc, P, cell_shape, plan):
    """Tiles (C, Zr, ny, P+1, Nx) and seams (C, Zr, ny, P+1, nbx) as the 3D
    kernels lay them out under ``plan`` from per-cell values ``r_loc`` (C,
    n_c, (P+1)^3): each cell row's integrals, z summed, the first node
    column of every brick but the first in the seams (seam entry 0 NaN:
    nothing writes it)."""
    C = r_loc.shape[0]
    nx, ny, nz = cell_shape
    n1 = P + 1
    shp = ts.lattice_shape(P, cell_shape)
    tiles = np.zeros((C, shp[0], ny, n1, shp[2]))
    seams = np.full((C, shp[0], ny, n1, plan.nbx), np.nan)
    seams[..., 1:] = 0.0
    cz = ts.class_index(P, nz)                       # (nz, P+1)
    rl = r_loc.reshape(C, nz, ny, nx, n1, n1, n1)    # local (k, j, i)
    for ez, ey, ex, k, j, i in np.ndindex(nz, ny, nx, n1, n1, n1):
        v = rl[:, ez, ey, ex, k, j, i]
        b = ex // plan.xb
        if i == 0 and b > 0 and ex == b * plan.xb:
            seams[:, cz[ez, k], ey, j, b] += v
        else:
            tiles[:, cz[ez, k], ey, j, P * ex + i] += v
    return tiles, seams


# the channel 3D level shapes (input/channel.json, dim 3, refinement 3),
# the gls-vmult lane's 32^3 and the ragged sheared lattice of chip_smoke
BRICK_SHAPES = [(4, 1, 1), (8, 2, 2), (16, 4, 4), (32, 8, 8), (64, 16, 16),
                (128, 32, 32), (32, 32, 32), (19, 3, 2)]


def plan_blocks(plan, cell_shape):
    """The cells each block of the 3D kernel owns under ``plan``, as
    ``csrc/structured.cu`` splits the lattice (block = (brick bx, cell row
    ey, z chunk kz)): [(x0, x1, ey, z0, z1)]."""
    nx, ny, nz = cell_shape
    return [(bx * plan.xb, min(nx, (bx + 1) * plan.xb), ey,
             kz * plan.zc, min(nz, (kz + 1) * plan.zc))
            for ey in range(ny) for bx in range(plan.nbx)
            for kz in range(plan.nzb)]


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_brick_plan_covers_every_cell_once(degree):
    """The 3D kernel's blocks under ``brick_plan`` own every cell of the
    lattice exactly once."""
    for cs in BRICK_SHAPES:
        plan = ts.brick_plan(degree, cs)
        nx, ny, nz = cs
        assert plan.nbx == -(-nx // plan.xb) and 1 <= plan.zs <= nz
        assert (plan.nzb - 1) * plan.zc < nz <= plan.nzb * plan.zc
        owned = np.zeros((nz, ny, nx), int)
        blocks = plan_blocks(plan, cs)
        assert len(blocks) == plan.nbx * ny * plan.nzb
        for x0, x1, ey, z0, z1 in blocks:
            assert x0 < x1 and z0 < z1
            owned[z0:z1, ey, x0:x1] += 1
        assert (owned == 1).all(), (cs, plan)


@pytest.mark.parametrize("degree,plan", [
    (1, None), (2, None), (3, None),
    (1, ts.BrickPlan(2, 2, 1, 1, 2)), (2, ts.BrickPlan(2, 2, 1, 2, 1)),
    (3, ts.BrickPlan(1, 3, 1, 1, 2)),
])
def test_brick_tiles_fold(degree, plan):
    """The 3D kernel's output, folded (``fold_bricks``), equals the
    scatter-add: tiles and seams are built here from per-cell values as
    the kernel lays them out (each cell row's integrals, z summed, the
    first node column of every brick but the first in the seams)."""
    st = TSpace(lattice_mesh(tgen, 3), degree)
    P = degree
    cs = tuple(st.cell_shape)
    nx, ny, nz = cs
    plan = plan or ts.brick_plan(P, cs)
    idx = ts.lattice_cell_nodes(P, cs)
    shp = ts.lattice_shape(P, cs)
    rng = np.random.default_rng(4)
    n1 = P + 1
    C = 4
    r_loc = rng.standard_normal((C, idx.shape[0], n1 ** 3))
    ref = np.zeros((C, st.n_nodes))
    for c in range(C):
        np.add.at(ref[c], idx.reshape(-1), r_loc[c].reshape(-1))

    tiles, seams = brick_layout(r_loc, P, cs, plan)
    tab = ts.StructuredTables(d=3, P=P, NQ=n1, cell_shape=cs, S1=None,
                              D1=None, jinv=None, jxw=None, h=None)
    out = ts.fold_bricks(tab, torch.as_tensor(tiles), torch.as_tensor(seams),
                         plan.xb)
    assert tuple(out.shape) == (C,) + shp
    np.testing.assert_allclose(out.reshape(C, -1).numpy(), ref, rtol=1e-12,
                               atol=1e-12)


# the channel 2D level shapes (input/channel.json, dim 2, refinement 6),
# the gls-vmult lane 2 9 2's 512 x 512, chip_smoke's sheared 37 x 5 and
# odd ones
SLAB_SHAPES = [(4, 1), (8, 2), (16, 4), (32, 8), (64, 16), (128, 32),
               (256, 64), (512, 128), (1024, 256), (512, 512), (37, 5),
               (1, 1), (1, 6), (3, 2), (3, 7), (7, 1), (7, 13)]


def plan_blocks_2d(plan, cell_shape):
    """The cells each block of the 2D kernel owns under ``plan``, as
    ``csrc/structured.cu`` splits the lattice (block = (brick bx, y chunk
    ky)): [(x0, x1, y0, y1)]."""
    nx, ny = cell_shape
    return [(bx * plan.xb, min(nx, (bx + 1) * plan.xb),
             ky * plan.yc, min(ny, (ky + 1) * plan.yc))
            for ky in range(plan.nyb) for bx in range(plan.nbx)]


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_slab_plan_2d_covers_every_cell_once(degree):
    """The 2D kernel's blocks under ``slab_plan_2d`` own every cell of the
    lattice exactly once, and the plan is one the launcher takes (at most
    two I1 columns and four E2 passes per thread; a warp takes one cell a
    pass above 32 q-points)."""
    cpw = max(1, 32 // (degree + 1) ** 2)
    for cs in SLAB_SHAPES:
        plan = ts.slab_plan_2d(degree, cs)
        nx, ny = cs
        assert plan.nbx == -(-nx // plan.xb) and 1 <= plan.xb <= nx
        assert (plan.nyb - 1) * plan.yc < ny <= plan.nyb * plan.yc
        assert 1 <= plan.ys <= plan.yc + 1
        assert 3 * (degree * plan.xb + 1) <= 2 * 256
        assert -(-plan.xb * plan.ys // cpw) <= 4 * 8
        owned = np.zeros((ny, nx), int)
        blocks = plan_blocks_2d(plan, cs)
        assert len(blocks) == plan.nbx * plan.nyb
        for x0, x1, y0, y1 in blocks:
            assert x0 < x1 and y0 < y1
            owned[y0:y1, x0:x1] += 1
        assert (owned == 1).all(), (cs, plan)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_slab_plan_2d_fits_shared_memory(degree):
    """No plan of ``slab_plan_2d`` needs more shared memory per block
    (``slab_smem_2d``, the launcher's formula) than the two blocks per SM
    it assumes, in any flavor; the finest channel level's plan needs the
    bytes the kernel's comment states."""
    for cs in SLAB_SHAPES:
        plan = ts.slab_plan_2d(degree, cs)
        for flavor in ts.FLAVORS:
            for consider_dt in (True, False):
                assert ts.slab_smem_2d(degree, plan.xb, plan.ys, flavor,
                                       consider_dt) <= ts.SMEM_2D
    assert 2 * ts.SMEM_2D <= 228 * 1024
    if degree == 2:
        fine = ts.slab_plan_2d(2, (1024, 256))
        assert ts.slab_smem_2d(2, fine.xb, fine.ys, "increment",
                               True) == 103424


def kernel_layout_2d(r_loc, P, cell_shape, plan):
    """The lattice (C, Yr, 1, Nx) and seams (C, Yr, nbx) as
    ``structured2d_kernel`` writes them from per-cell values ``r_loc``
    (C, n_c, (P+1)^2): each block sums its brick's cells along x, walks
    its y chunk from the cell row below it (for the carry only) with the
    shared node row carried, and writes its own node rows; the first node
    column of brick b > 0 goes to the seams.  Every entry is written
    exactly once (checked)."""
    C = r_loc.shape[0]
    nx, ny = cell_shape
    n1 = P + 1
    cy = ts.class_index(P, ny)
    lat = np.full((C, P * ny + 1, 1, P * nx + 1), np.nan)
    seams = np.full((C, P * ny + 1, plan.nbx), np.nan)
    rl = r_loc.reshape(C, ny, nx, n1, n1)            # local (j, i)
    for ky in range(plan.nyb):
        yb, ye = ky * plan.yc, min(ny, (ky + 1) * plan.yc)
        for bx in range(plan.nbx):
            x0 = bx * plan.xb
            xb = min(plan.xb, nx - x0)
            xn = P * xb + 1
            s0 = 1 if bx > 0 else 0

            def put(row, v):
                dst = lat[:, row, 0, P * x0 + s0:P * x0 + xn]
                assert np.isnan(dst).all()
                dst[...] = v[:, s0:]
                if bx > 0:
                    assert np.isnan(seams[:, row, bx]).all()
                    seams[:, row, bx] = v[:, 0]

            carry = np.zeros((C, xn))
            for eg in range(max(yb - 1, 0), ye):
                rows = np.zeros((C, n1, xn))
                for ex in range(xb):
                    rows[:, :, P * ex:P * ex + n1] += rl[:, eg, x0 + ex]
                for k in range(n1):
                    if k == 0:
                        acc = rows[:, 0] + carry
                    elif k == P:
                        carry = rows[:, P]
                        continue
                    else:
                        acc = rows[:, k]
                    if eg >= yb:
                        put(cy[eg, k], acc)
            if ye == ny:
                put(cy[ny - 1, P], carry)
    assert not np.isnan(lat).any() and not np.isnan(seams[..., 1:]).any()
    return lat, seams


@pytest.mark.parametrize("degree,plan", [
    (1, None), (2, None),
    (1, ts.SlabPlan2D(3, 3, 2, 2, 3)), (2, ts.SlabPlan2D(2, 4, 1, 1, 5)),
    (2, ts.SlabPlan2D(7, 1, 3, 5, 1)), (3, ts.SlabPlan2D(4, 2, 2, 3, 2)),
    (4, ts.SlabPlan2D(5, 2, 1, 2, 3)),
])
def test_slab_layout_fold_2d(degree, plan):
    """The 2D kernel's output, folded (``fold_seams_2d``), equals the
    scatter-add of per-cell values on a 7 x 5 lattice: lattice and seams
    built as the kernel lays them out, under forced plans with ragged last
    bricks and several y chunks (each recomputing the row below it)."""
    P = degree
    cs = (7, 5)
    plan = plan or ts.slab_plan_2d(P, cs)
    idx = ts.lattice_cell_nodes(P, cs)
    shp = ts.lattice_shape(P, cs)
    rng = np.random.default_rng(5)
    C = 3
    r_loc = rng.standard_normal((C, idx.shape[0], (P + 1) ** 2))
    ref = np.zeros((C, int(np.prod(shp))))
    for c in range(C):
        np.add.at(ref[c], idx.reshape(-1), r_loc[c].reshape(-1))
    lat, seams = kernel_layout_2d(r_loc, P, cs, plan)
    tab = ts.StructuredTables(d=2, P=P, NQ=P + 1, cell_shape=cs, S1=None,
                              D1=None, jinv=None, jxw=None, h=None)
    out = ts.fold_seams_2d(tab, torch.as_tensor(lat), torch.as_tensor(seams),
                           plan.xb)
    assert tuple(out.shape) == (C,) + shp
    np.testing.assert_allclose(out.reshape(C, -1).numpy(), ref, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_launch_raises_on_cpu_tensors(dim):
    """The kernels' wrapper takes CUDA tensors only (the sweep runs the
    plain version for CPU tensors); it refuses before building anything."""
    cells = (2, 2) if dim == 2 else (2, 2, 1)
    mesh = tgen.subdivided_hyper_rectangle(cells, (0.0,) * dim, (1.0,) * dim,
                                           colorize=True)
    ti = TBDF(1)
    ti.update_dt(0.1)
    op = _gate_op(TSpace(mesh, 1), ti, F32)
    tables = op._fast.tables
    shp = ts.lattice_shape(1, tables.cell_shape)
    u = torch.zeros((dim + 1,) + shp)
    vo = torch.zeros((dim,) + shp)
    sc = dict(weight=1.0, stau=1.0, nu=0.02, c1=4.0, c2=2.0)
    with pytest.raises(TypeError):
        ts.StructuredKernel.launch(tables, sc, u, u, vo, "increment", True,
                                   True)
    assert ts.StructuredKernel.launches == {
        "structured2d": 0, "structured3d": 0, "structured3d_batched": 0}
