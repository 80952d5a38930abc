"""The port's patch-2D sweep (its plain PyTorch version, which the CUDA
kernel is held to on the card) against the JAX package's Pallas patch-2D
kernel, run as the JAX package's own tests run it on the CPU (interpret
mode through ``use_structured=True``), and against the port's own f32
general sweep.

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
from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
)

TOL = 1e-5
F32 = torch.float32


def _refine(m, n):
    for _ in range(n):
        m = m.refine()
    return m


def _setup(n_ref, increment, cell_wise, consider_dt):
    """JAX Pallas-interpret operator, port patch-2D operator and port
    general-sweep operator (all f32) on the curved Turek 2D mesh refined
    n_ref times (patches of m = 2**n_ref cells per axis)."""
    sj = JSpace(_refine(jmesh(), n_ref), 2)
    st = TSpace(_refine(tmesh(), n_ref), 2)
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
    assert opt._fast.m == 2**n_ref

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
