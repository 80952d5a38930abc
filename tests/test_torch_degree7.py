"""The fused sweeps at degree 7, the first degree above those built into
the kernels' common library (P = 1-6): each kernel's plain version, which
its degree-7 instance (a library built for that degree alone at first
use) is held to on the card, against the JAX package's general sweep
(``use_structured=False``) on the same numpy inputs, in f32.

- Rows 1-5 of the kernel table: patch-2D on the curved Turek 2D mesh (88
  patches of one cell), prism on an extruded mesh (8 cells, one patch
  column), patch-3D on a general 3D mesh (8 cells), the 2D structured
  kernel on a sheared 3 x 2 lattice and the 3D one on a sheared 2 x 1 x 2
  lattice; each in one flavor pair (the increment vmult with the
  residual, or the fixed-point vmult with the residual) and one delta
  mode, with the BDF history.  Tolerance 1e-5 relative to the
  reference's max-abs: both sides sum (P+1)^d-term contractions in f32
  in different orders.
- The structured cases build the JAX space without the lattice (its
  lattice numbering merges nodes from P = 7 on, ROADMAP queue 3; the
  port's does not) and match the two packages' nodes by position.
- A degree-7 table build on the CPU no longer raises, on every fused
  sweep, and its plans fit the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.fem.constraints import AffineConstraints as JAff
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh import generators as jgen
from ns_gls_tpu.mesh.cylinder import cylinder_mesh_2d as jcyl
from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator as JOp
from ns_gls_tpu.ops.time_integration import (
    BDFIntegrator as JBDF,
    SolutionHistory as JHist,
)
from ns_gls_tpu_torch.fem.constraints import AffineConstraints as TAff
from ns_gls_tpu_torch.fem.constraints import distribute as cstr_distribute
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh import generators as tgen
from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_2d as tcyl
from ns_gls_tpu_torch.ops import patch2d as tp2
from ns_gls_tpu_torch.ops import patch3d as tp3
from ns_gls_tpu_torch.ops import prism as tpr
from ns_gls_tpu_torch.ops import structured as tst
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
)
from ns_gls_tpu_torch.utils.device import torch_threads

TOL = 1e-5
F32 = torch.float32
DEGREE = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


def _lattice(gen, dim):
    cells = (3, 2) if dim == 2 else (2, 1, 2)
    mesh = gen.subdivided_hyper_rectangle(
        cells, (0.0,) * dim, (1.2, 1.0, 0.8)[:dim], colorize=True)
    v = mesh.vertices.copy()
    v[:, 0] = v[:, 0] + 0.3 * v[:, 1]       # sheared: off-diagonal J^-1
    return dataclasses.replace(mesh, vertices=v)


def _prism(gen):
    m2 = gen.subdivided_hyper_rectangle((2, 2), (0.0, 0.0), (1.1, 0.9))
    m2.lattice = None
    return gen.extrude(m2, 2, 0.7)


def _general3d(gen):
    mesh = _prism(gen)
    return dataclasses.replace(mesh, extr_mesh2d=None, extr_cell2d=None,
                               extr_layer=None)


def _curved2d(_gen):
    return (jcyl if _gen is jgen else tcyl)()


# kind: (mesh builder, dim, the port's sweep class)
KINDS = {
    "patch2d": (_curved2d, 2, tp2.Patch2DSweep),
    "prism": (_prism, 3, tpr.PrismSweep),
    "patch3d": (_general3d, 3, tp3.Patch3DSweep),
    "structured2d": (lambda g: _lattice(g, 2), 2, tst.StructuredSweep),
    "structured3d": (lambda g: _lattice(g, 3), 3, tst.StructuredSweep),
}


def _by_position(sj, st):
    """perm with st's node i at sj's node perm[i] (equal positions)."""
    kj = np.lexsort(np.round(np.asarray(sj.node_pos), 9).T)
    kt = np.lexsort(np.round(np.asarray(st.node_pos), 9).T)
    perm = np.empty(st.n_nodes, np.int64)
    perm[kt] = kj
    assert np.abs(np.asarray(sj.node_pos)[perm]
                  - np.asarray(st.node_pos)).max() < 1e-9
    return perm


def _setup(kind, increment, cell_wise):
    """The JAX operator on its general sweep and the port's operator on
    its fused sweep (plain version on the CPU), both f32 at degree 7,
    with the BDF-2 history, from one numpy seed; JAX's vectors are the
    port's permuted to its numbering (``perm``)."""
    build, dim, sweep = KINDS[kind]
    C = dim + 1
    mj = build(jgen)
    mj.lattice = None
    sj = JSpace(mj, DEGREE)
    st = TSpace(build(tgen), DEGREE)
    perm = _by_position(sj, st)
    bn = st.boundary_nodes([0])
    vals = [[1.0] + [0.0] * (dim - 1)] * len(bn)
    bj = JAff(sj.n_nodes, C)
    bj.add_dirichlet(perm[bn], list(range(dim)), values=vals)
    bt = TAff(st.n_nodes, C)
    bt.add_dirichlet(bn, list(range(dim)), values=vals)
    caj = bj.close(jnp.float32)
    cat = bt.close(F32, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.1, 0.08):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0, consider_time_derivative=True,
              increment_form=increment, cell_wise_stabilization=cell_wise)
    opj = JOp(sj, caj, caj, time_integrator=tij, fuse_tables=True,
              dtype=jnp.float32, use_structured=False, **kw)
    opt = TOp(st, cat, cat, time_integrator=tit, dtype=F32, device="cpu",
              **kw)
    assert type(opt._fast) is sweep

    rng = np.random.default_rng(0)
    u = rng.standard_normal((st.n_nodes, C)).astype(np.float32)
    u = np.array(cstr_distribute(cat, torch.as_tensor(u)))
    hist = [u] + [rng.standard_normal((st.n_nodes, C)).astype(np.float32)
                  for _ in range(2)]
    inv = np.argsort(perm)
    opj.constraints_inhomogeneous = caj
    opj.set_previous_solution(JHist([jnp.asarray(h[inv]) for h in hist]))
    opj.set_linearization_point(jnp.asarray(u[inv]))
    opt.constraints_inhomogeneous = cat
    opt.set_previous_solution(THist.from_numpy(hist, F32, "cpu"))
    opt.set_linearization_point(torch.as_tensor(u))
    v = rng.standard_normal(u.shape).astype(np.float32)
    return opj, opt, u, v, perm, inv


def _close(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= TOL, err


@pytest.mark.parametrize("kind,increment,cell_wise", [
    ("patch2d", True, False), ("prism", True, False),
    ("patch3d", False, True), ("structured2d", True, True),
    ("structured3d", False, False)])
def test_plain_sweep_degree7_vs_jax(kind, increment, cell_wise):
    opj, opt, u, v, perm, inv = _setup(kind, increment, cell_wise)
    _close(opt.vmult(torch.as_tensor(v)).numpy(),
           np.asarray(opj.vmult(jnp.asarray(v[inv])))[perm])
    _close(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
           np.asarray(opj.evaluate_residual(jnp.asarray(u[inv])))[perm])


def test_degree7_tables_build():
    """Every fused sweep builds its tables at degree 7 on the CPU (the
    port refused degrees above 6 before they built on demand), under
    plans whose shared memory fits the card; the batched 3D kernel's plan
    too."""
    for kind, (build, dim, sweep) in KINDS.items():
        st = TSpace(build(tgen), DEGREE)
        ca = TAff(st.n_nodes, dim + 1).close(F32, "cpu")
        ti = TBDF(1)
        ti.update_dt(0.1)
        op = TOp(st, ca, ca, nu=0.02, c_1=4.0, c_2=2.0, time_integrator=ti,
                 dtype=F32, device="cpu")
        assert type(op._fast) is sweep, kind
    cells = (2, 1, 2)
    for plan, smem in ((tst.brick_plan, tst.brick_smem),
                       (tst.batched_plan, tst.batched_smem)):
        p = plan(DEGREE, cells)
        assert smem(DEGREE, p.xb, p.zs, "increment", True) \
            <= tst.SMEM_PER_BLOCK
    p = tst.slab_plan_2d(DEGREE, (3, 2))
    assert tst.slab_smem_2d(DEGREE, p.xb, p.ys, "increment", True) \
        <= tst.SMEM_PER_BLOCK


def test_degree7_patch3d_bricks_are_contiguous():
    """At P = 7 a patch of 2^3 cells takes x bricks of one cell (two a
    cell row), and every table the kernel reads is contiguous: ``h`` was
    a strided view of its brick transpose there, which the kernel's
    wrapper refused on the card."""
    mesh = _general3d(tgen).refine()
    st = TSpace(mesh, DEGREE)
    ca = TAff(st.n_nodes, 4).close(F32, "cpu")
    ti = TBDF(1)
    ti.update_dt(0.1)
    op = TOp(st, ca, ca, nu=0.02, c_1=4.0, c_2=2.0, time_integrator=ti,
             dtype=F32, device="cpu")
    t = op._fast.tables
    assert t.m == 2 and {p.nbx for p in t.plans.values()} == {2}
    for name in ("jinv", "jxw", "h", "S1", "D1", "patch_nodes"):
        assert getattr(t, name).is_contiguous(), name
