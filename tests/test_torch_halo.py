"""The port's halo-exchange operator (``ns_gls_tpu_torch/parallel/halo.py``)
against the JAX package's on 4 shards: four CPU shards on the port's
side, four of the 8 virtual CPU devices (``tests/conftest.py``) on JAX's.

- The layout: the partition, the owners, ``own_global``, ``g2l`` and the
  exchange rounds' pairs and send/receive maps equal JAX's exactly (a
  patch partition where the JAX operator holds its fused patch sweep:
  Turek 2D Q2, Turek 3D, the sphere; Morton chunks on f64 levels and on
  a mesh with hanging nodes).
- The applies: vmult, residual and rhs of the port's halo operator equal
  the JAX halo operator's on the same numpy inputs (JAX on its general
  sweep), 1e-12 relative in f64 and 2e-5 (the JAX halo tests' bound) in
  f32, where each shard runs the plain version of its fused kernel:
  patch-2D, prism, patch-3D.  In f32 the sharded apply also equals the
  port's single-device fused operator within 1e-5.  The Hoffmann 2D
  Nitsche outflow covers the face terms.
- ``to_dist`` then ``to_global`` gives the input back, and distributed
  dot products equal global ones.

The case builders here serve ``test_torch_sharding.py`` and
``test_torch_halo_transfer.py`` as well.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ns_gls_tpu.driver as jdrv
import ns_gls_tpu_torch.driver as tdrv
from ns_gls_tpu.fem.constraints import AffineConstraints as JAff
from ns_gls_tpu.fem.constraints import distribute as jdistribute
from ns_gls_tpu.fem.hanging import hanging_node_constraints as jhanging
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh import generators as jgen
from ns_gls_tpu.mesh.cylinder import cylinder_mesh_2d as jcyl2
from ns_gls_tpu.mesh.cylinder import cylinder_mesh_3d as jcyl3
from ns_gls_tpu.mesh.gmsh import read_msh as jread
from ns_gls_tpu.models.cylinder import SimulationCylinder as JCyl
from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator as JOp
from ns_gls_tpu.ops.time_integration import (
    BDFIntegrator as JBDF,
    SolutionHistory as JHist,
)
from ns_gls_tpu_torch.fem.constraints import AffineConstraints as TAff
from ns_gls_tpu_torch.fem.hanging import hanging_node_constraints as thanging
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh import generators as tgen
from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_2d as tcyl2
from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_3d as tcyl3
from ns_gls_tpu_torch.mesh.gmsh import read_msh as tread
from ns_gls_tpu_torch.models.cylinder import SimulationCylinder as TCyl
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
)
from ns_gls_tpu_torch.parallel.halo import HaloShardedOperator
from ns_gls_tpu_torch.utils.device import torch_threads
from tests.test_torch_patch3d import sphere_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


N_DEV = 4
CPU4 = ["cpu"] * N_DEV
F32, F64 = torch.float32, torch.float64
TOL = {F64: 1e-12, F32: 2e-5}


def jax_mesh():
    from ns_gls_tpu.parallel.sharding import make_device_mesh

    devs = jax.devices()
    if len(devs) < N_DEV:
        pytest.skip(f"needs {N_DEV} virtual devices")
    return make_device_mesh(devs[:N_DEV])


def _refine(m, n):
    for _ in range(n):
        m = m.refine()
    return m


def _hanging_mesh(gen):
    m = gen.subdivided_hyper_rectangle((4, 4), (0.0, 0.0), (1.0, 1.0))
    m.lattice = None
    flags = np.zeros(m.n_cells, bool)
    flags[:6] = True
    return m.refine(flags)


def _dirichlet_sets(sj, st, dim, hanging, jdt, tdt):
    """Inflow (boundary 0, values (1, 0, ...)) and no-slip walls (2, 3),
    plus the hanging-node constraints: both packages' sets."""
    out = []
    for space, Aff, hang, close in (
            (sj, JAff, jhanging, lambda b: b.close(jdt)),
            (st, TAff, thanging, lambda b: b.close(tdt, "cpu"))):
        b = Aff(space.n_nodes, dim + 1)
        bn = space.boundary_nodes([0])
        b.add_dirichlet(bn, list(range(dim)),
                        values=[[1.0] + [0.0] * (dim - 1)] * len(bn))
        walls = space.boundary_nodes([2, 3])
        if len(walls):
            b.add_dirichlet(walls, list(range(dim)))
        if hanging:
            for node, masters, weights in hang(space):
                b.add_hanging_node(node, None, masters, weights)
        ca = close(b)
        out.append((ca, ca, ca))
    return out


@functools.lru_cache(maxsize=None)
def _spaces(case):
    """(JAX space, port space, dim, constraint-set maker, outflow kwargs
    maker) of a case."""
    if case == "nitsche":
        from tests.test_torch_outflow import _drivers

        _, jd, td = _drivers("nitsche")
        return jd.space, td.space, 2, ("driver", jd.bcs, td.bcs)
    if case.startswith("turek2d"):
        ref, deg = (1, 1) if case == "turek2d_q1" else (1, 2)
        return (JSpace(_refine(jcyl2(), ref), deg),
                TSpace(_refine(tcyl2(), ref), deg), 2,
                ("driver", JCyl(2).get_boundary_descriptor(),
                 TCyl(2).get_boundary_descriptor()))
    if case == "turek3d_q1":
        return (JSpace(jcyl3(), 1), TSpace(tcyl3(), 1), 3,
                ("driver", JCyl(3).get_boundary_descriptor(),
                 TCyl(3).get_boundary_descriptor()))
    if case == "sphere_q1":
        return (JSpace(sphere_mesh(jread), 1), TSpace(sphere_mesh(tread), 1),
                3, ("dirichlet", False))
    if case == "hanging_q1":
        return (JSpace(_hanging_mesh(jgen), 1), TSpace(_hanging_mesh(tgen), 1),
                2, ("dirichlet", True))
    raise KeyError(case)


def make_pair(case, dtype, increment=True, cell_wise=False,
              jax_fused=False):
    """A JAX and a port operator on the case's space (JAX on its general
    sweep unless ``jax_fused``; the port in f32 on its fused sweep), with
    the same constraints, BDF-2 history and linearization point from one
    numpy seed.  Returns (JAX op, port op, u, v) with u, v numpy."""
    sj, st, dim, cons = _spaces(case)
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    outflow_j, outflow_t = {}, {}
    if cons[0] == "driver":
        jcs = jdrv.ConstraintSetBuilder(sj, cons[1], jdt)
        tcs = tdrv.ConstraintSetBuilder(st, cons[2], dtype, "cpu")
        t_in = 0.03
        sets = [(jcs.homogeneous, jcs.full, jcs.inhomogeneous_at(t_in)),
                (tcs.homogeneous, tcs.full, tcs.inhomogeneous_at(t_in))]
        if case == "nitsche":
            outflow_j = dict(outflow_bcs_cut=cons[1].all_outflow_bcs_cut,
                             outflow_bcs_nitsche=cons[1]
                             .all_outflow_bcs_nitsche)
            outflow_t = dict(outflow_bcs_cut=cons[2].all_outflow_bcs_cut,
                             outflow_bcs_nitsche=cons[2]
                             .all_outflow_bcs_nitsche)
    else:
        sets = _dirichlet_sets(sj, st, dim, cons[1], jdt, dtype)
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.1, 0.08):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0, consider_time_derivative=True,
              increment_form=increment, cell_wise_stabilization=cell_wise)
    (hj, fj, ij), (ht, ft, it) = sets
    opj = JOp(sj, hj, fj, time_integrator=tij, dtype=jdt,
              use_structured=jax_fused, fuse_tables=jax_fused,
              **kw, **outflow_j)
    opt = TOp(st, ht, ft, time_integrator=tit, dtype=dtype, device="cpu",
              **kw, **outflow_t)
    opj.constraints_inhomogeneous = ij
    opt.constraints_inhomogeneous = it
    rng = np.random.default_rng(0)
    C = dim + 1
    n = st.n_nodes
    u = np.array(jdistribute(ij, jnp.asarray(rng.standard_normal((n, C)),
                                              jdt)))
    hist = [u] + [rng.standard_normal((n, C)) for _ in range(2)]
    opj.set_previous_solution(JHist([jnp.asarray(h, jdt) for h in hist]))
    opj.set_linearization_point(jnp.asarray(u, jdt))
    opt.set_previous_solution(THist.from_numpy(hist, dtype, "cpu"))
    opt.set_linearization_point(torch.as_tensor(u, dtype=dtype))
    return opj, opt, u, rng.standard_normal(u.shape)


def close(a, ref, tol):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def check_applies(jw, tw, u, v, dtype, tol, ref_t=None):
    """vmult, residual and rhs of the port's wrapper ``tw`` against the
    JAX wrapper ``jw`` (and against ``ref_t``, the port's single-device
    operator, within 1e-5 when given)."""
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    tv = tw.vmult(torch.as_tensor(v, dtype=dtype)).numpy()
    tr = tw.evaluate_residual(torch.as_tensor(u, dtype=dtype)).numpy()
    trhs = tw.evaluate_rhs().numpy()
    close(tv, np.asarray(jw.vmult(jnp.asarray(v, jdt))), tol)
    close(tr, np.asarray(jw.evaluate_residual(jnp.asarray(u, jdt))), tol)
    close(trhs, np.asarray(jw.evaluate_rhs()), tol)
    if ref_t is not None:
        close(tv, ref_t.vmult(torch.as_tensor(v, dtype=dtype)).numpy(), 1e-5)
        close(tr, ref_t.evaluate_residual(
            torch.as_tensor(u, dtype=dtype)).numpy(), 1e-5)


# the fused sweep each case's f32 port operator holds, run per shard
KINDS = {"turek2d_q2": "patch2d", "turek3d_q1": "prism",
         "sphere_q1": "patch3d"}


@pytest.mark.parametrize("case,dtype", [
    ("turek2d_q2", F32), ("turek3d_q1", F32), ("sphere_q1", F32),
    ("hanging_q1", F64), ("turek2d_q1", F64)])
def test_layout_equals_jax(case, dtype):
    """Partition, owners, owned lists, global-to-window maps and exchange
    rounds equal JAX's exactly."""
    from ns_gls_tpu.parallel.halo import HaloShardedOperator as JHalo

    opj, opt, _, _ = make_pair(case, dtype, jax_fused=dtype == F32)
    jh = JHalo(opj, jax_mesh())
    th = HaloShardedOperator(opt, CPU4)
    assert th.partition.kind == KINDS.get(case, "cells")
    for a, b in zip(th.partition.cells_of, jh._cells_of):
        assert np.array_equal(a, b)
    assert np.array_equal(th.owner, jh.owner)
    assert np.array_equal(th.own_global, np.asarray(jh._own_global))
    assert np.array_equal(th.g2l, jh._g2l)
    assert (th.n_own_max, th.n_loc) == (jh.n_own_max, jh.n_loc)
    assert len(th.rounds) == len(jh._rounds) > 0
    for (pt, st, rt), (pj, sj, rj) in zip(th.rounds, jh._rounds):
        assert pt == pj
        assert np.array_equal(st, np.asarray(sj))
        assert np.array_equal(rt, np.asarray(rj))
    assert th.halo_bytes == jh.halo_bytes


@pytest.mark.parametrize("case,dtype,increment", [
    ("turek2d_q1", F64, True), ("turek2d_q2", F64, False),
    ("hanging_q1", F64, True), ("nitsche", F64, True),
    ("turek2d_q2", F32, True), ("turek3d_q1", F32, False),
    ("sphere_q1", F32, True), ("nitsche", F32, False)])
def test_halo_applies_equal_jax(case, dtype, increment):
    """The sharded applies against JAX's halo operator; in f32 each shard
    runs its fused kernel's plain version, and the result also equals
    the port's single-device operator."""
    from ns_gls_tpu.parallel.halo import HaloShardedOperator as JHalo

    opj, opt, u, v = make_pair(case, dtype, increment,
                               cell_wise=not increment)
    th = HaloShardedOperator(opt, CPU4)
    if dtype == F32 and case in KINDS:
        assert th.local_sweep == KINDS[case]
    if dtype == F64:
        assert th.local_sweep == "general"
    check_applies(JHalo(opj, jax_mesh()), th, u, v, dtype, TOL[dtype],
                  ref_t=opt if dtype == F32 else None)
    # a new linearization point reaches the shards
    u2 = 1.3 * u
    opt.set_linearization_point(torch.as_tensor(u2, dtype=dtype))
    close(th.evaluate_residual(torch.as_tensor(u2, dtype=dtype)).numpy(),
          opt.evaluate_residual(torch.as_tensor(u2, dtype=dtype)).numpy(),
          1e-12 if dtype == F64 else 1e-5)


@pytest.mark.parametrize("case", ["turek2d_q2", "hanging_q1"])
def test_layout_round_trip_and_dots(case):
    """to_dist then to_global gives the input back; distributed dots and
    norms equal the global ones; the pads are zero."""
    _, opt, _, v = make_pair(case, F64)
    th = HaloShardedOperator(opt, CPU4)
    vt = torch.as_tensor(v, dtype=F64)
    vd = th.to_dist(vt)
    assert torch.equal(th.to_global(vd), vt)
    for s, p in zip(th.shards, vd.parts):
        assert p.shape == (th.n_own_max, opt.n_comp)
        assert not p[s.own.shape[0]:].any()
    assert abs(float(vd.dot(vd)) - float((vt * vt).sum())) \
        <= 1e-12 * float((vt * vt).sum())
    assert abs(float(vd.norm()) - float(torch.linalg.vector_norm(vt))) \
        <= 1e-12 * float(torch.linalg.vector_norm(vt))
    st = th.stats()
    assert st["rounds"] == len(th.rounds) and 0 < st["halo_share"] < 1
