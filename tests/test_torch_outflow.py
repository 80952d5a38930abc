"""The weak outflow slice (``input/hoffmann_2d_reinf.json``): the port's
face terms (``ops/navier_stokes.py`` ``face_block_terms``,
``_boundary_sweep``) and its driver against the JAX package, on the
configuration of the JAX package's slow test ``tests/test_hoffmann.py``
(its ``BASE``: Q1, refinement 1, slip cylinder and walls, nu = 0, BDF-2,
inexact Newton to an absolute 1e-5), with the Nitsche and with the
directional do-nothing ("cut") outflow.

- Operator level, the same numpy inputs through both packages: the
  residual and the vmult in fixed and increment form, on the f64 fine
  level (both on the general sweep, 1e-12 relative to the reference's
  max-abs: the same arithmetic in another order) and on an f32 patch-2D
  level (the port's plain patch-2D sweep against the JAX Pallas kernel in
  interpret mode, 1e-5 relative: f32 in other summation orders).
- Driver level: the port's ``Driver`` on the CPU against the JAX driver's
  runs stored by ``tools/hoffmann_series.py`` in
  ``validation/hoffmann_2d_reinf_ref1_q1_series.json`` (the JAX driver
  takes ~28 s single-threaded on a CPU for the Nitsche run): equal Newton
  and GMRES iterations per step, the final solution within 1e-9 of the
  reference's max-abs (both GMG smoothers' power iterations start from
  the JAX package's vectors, so the two preconditioners differ only by
  f32 round-off), no flux through the slip cylinder.
- The Nitsche targets follow the inflow's time, once per time value; the
  JAX package keeps those of its first linearization (ROADMAP queue 3),
  so the stored JAX runs take the port's rule (see the tool).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.config import Parameters as JParams
from ns_gls_tpu.driver import ConstraintSetBuilder as JCsets
from ns_gls_tpu.driver import Driver as JDriver
from ns_gls_tpu.fem.constraints import distribute as jdistribute
from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator as JOp
from ns_gls_tpu.ops.time_integration import (
    BDFIntegrator as JBDF,
    SolutionHistory as JHist,
)
import ns_gls_tpu.utils.logging as jlog
from ns_gls_tpu_torch.config import Parameters as TParams
from ns_gls_tpu_torch.driver import ConstraintSetBuilder as TCsets
from ns_gls_tpu_torch.driver import Driver as TDriver
from ns_gls_tpu_torch.ops.assembly import compute_diagonal
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
)
import ns_gls_tpu_torch.utils.logging as tlog
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


jlog.set_verbose(False)
tlog.set_verbose(False)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "validation",
                       "hoffmann_2d_reinf_ref1_q1_series.json")) as _f:
    SERIES = json.load(_f)
F32 = torch.float32
F64 = torch.float64
# the variants' outflow keys, as the stored series ran them
OUTFLOW = {name: v["overrides"] for name, v in SERIES["variants"].items()}
# the time at which the operator tests take the inflow (and so the
# Nitsche targets): past the start-up ramp's first steps
T_INFLOW = 0.03


def _config(variant: str) -> dict:
    return SERIES["config"] | OUTFLOW[variant]


def _jax_start(level, shape, dtype, device):
    """The JAX GMG power iteration's start vector on ``level``."""
    v = jax.random.normal(jax.random.PRNGKey(31 + level), shape, jnp.float32)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _drivers(variant):
    """Both packages' drivers set up on the variant's configuration (their
    spaces, boundary descriptors and constraint sets are reused)."""
    cfg = _config(variant)
    jd = JDriver(JParams.from_dict(cfg))
    jd.setup()
    td = TDriver(TParams.from_dict(cfg), device="cpu")
    td.setup()
    assert td.op.needs_face_integrals and td.op.face_blocks
    return variant, jd, td


@pytest.fixture(scope="module", params=["nitsche", "cut"])
def drivers(request):
    return _drivers(request.param)


def _operators(jd, td, dtype, increment):
    """A JAX and a port operator on the fine space with the variant's
    outflow, ``dtype`` (f64: both on the general sweep; f32: the JAX
    Pallas patch-2D kernel in interpret mode and the port's plain
    patch-2D sweep), set up with one numpy seed."""
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    jcs = JCsets(jd.space, jd.bcs, jdt)
    tcs = TCsets(td.space, td.bcs, dtype, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (1e-3, 8e-4):
        tij.update_dt(dt)
        tit.update_dt(dt)
    kw = dict(nu=0.0, c_1=1.0, c_2=1.0, consider_time_derivative=True,
              increment_form=increment, cell_wise_stabilization=True)
    opj = JOp(jd.space, jcs.homogeneous, jcs.full, time_integrator=tij,
              outflow_bcs_cut=jd.bcs.all_outflow_bcs_cut,
              outflow_bcs_nitsche=jd.bcs.all_outflow_bcs_nitsche,
              dtype=jdt, fuse_tables=dtype == F32,
              use_structured=dtype == F32, **kw)
    opt = TOp(td.space, tcs.homogeneous, tcs.full, time_integrator=tit,
              outflow_bcs_cut=td.bcs.all_outflow_bcs_cut,
              outflow_bcs_nitsche=td.bcs.all_outflow_bcs_nitsche,
              dtype=dtype, device="cpu", **kw)
    if dtype == F32:
        assert opj._p2sweep is not None
        assert isinstance(opt._fast, Patch2DSweep)
    else:
        assert opt._fast is None
    assert len(opt.face_blocks) == len(opj.face_blocks) > 0
    # the inflow at T_INFLOW on both sides (the Nitsche targets are
    # evaluated at the first linearization, from the same function)
    opj.constraints_inhomogeneous = jcs.inhomogeneous_at(T_INFLOW)
    opt.constraints_inhomogeneous = tcs.inhomogeneous_at(T_INFLOW)

    rng = np.random.default_rng(0)
    n = td.space.n_nodes
    u = np.asarray(jdistribute(opj.constraints_inhomogeneous, jnp.asarray(
        39.0 * rng.standard_normal((n, 3)), jdt)))
    hist = [u] + [39.0 * rng.standard_normal((n, 3)) for _ in range(2)]
    opj.set_previous_solution(JHist([jnp.asarray(h, jdt) for h in hist]))
    opj.set_linearization_point(jnp.asarray(u, jdt))
    opt.set_previous_solution(THist.from_numpy(hist, dtype, "cpu"))
    opt.set_linearization_point(torch.as_tensor(u, dtype=dtype))
    v = rng.standard_normal(u.shape)
    return opj, opt, u, v


def _close(a, ref, tol):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("increment", [True, False])
@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-5)])
def test_face_terms_vs_jax(drivers, dtype, tol, increment):
    """vmult (the increment or fixed flavor) and residual with the weak
    outflow faces, against the JAX operator on the same inputs; the face
    terms themselves are a sizable part of both (the operator without
    them differs far beyond the tolerance)."""
    variant, jd, td = drivers
    opj, opt, u, v = _operators(jd, td, dtype, increment)
    jdt = opj.dtype
    rv = np.asarray(opj.vmult(jnp.asarray(v, jdt)))
    rr = np.asarray(opj.evaluate_residual(jnp.asarray(u, jdt)))
    _close(opt.vmult(torch.as_tensor(v, dtype=dtype)).numpy(), rv, tol)
    _close(opt.evaluate_residual(torch.as_tensor(u, dtype=dtype)).numpy(),
           rr, tol)
    if variant == "nitsche":
        assert any(float(t.abs().max()) > 0 for t in opt.state.face_target)
    # the same operator without its face terms is far from the reference
    opt.needs_face_integrals = False
    r0 = opt.evaluate_residual(torch.as_tensor(u, dtype=dtype)).numpy()
    assert np.abs(r0 - rr).max() > 100 * tol * np.abs(rr).max()


def test_diagonal_is_cell_only(drivers):
    """The GMG diagonal stays cell-only, as the JAX package's
    ``compute_diagonal`` differentiates the cell-local apply only
    (``ns_gls_tpu/ops/assembly.py:200-229``): the operator with weak
    outflow faces has the diagonal of the operator without them, on the
    same state."""
    _, jd, td = drivers
    _, opt, u, _ = _operators(jd, td, F32, True)
    plain = TOp(td.space, opt.constraints_homogeneous, opt.constraints_full,
                nu=0.0, c_1=1.0, c_2=1.0,
                time_integrator=opt.time_integrator, increment_form=True,
                dtype=F32, device="cpu")
    plain.set_previous_vectors(opt.state.vec_old, opt.state.u_old)
    plain.set_linearization_point(opt.state.u_lin)
    assert plain.face_blocks == ()
    assert torch.equal(compute_diagonal(opt), compute_diagonal(plain))
    v = torch.as_tensor(u, dtype=F32)
    assert not torch.equal(opt.vmult(v), plain.vmult(v))


def test_nitsche_targets_follow_the_inflow_time():
    """The Nitsche targets are the inflow at its current time: taken once
    per time value (a second linearization at the same time reuses them),
    and taken anew when the time moves, as the reference does."""
    _, jd, td = _drivers("nitsche")
    _, opt, u, _ = _operators(jd, td, F64, True)
    (fn,) = opt.outflow_bcs_nitsche.values()
    first = opt.state.face_target
    assert fn.time == T_INFLOW and float(first[0][..., 0].abs().max()) > 0
    opt.set_linearization_point(torch.as_tensor(u, dtype=F64))
    assert all(a is b for a, b in zip(opt.state.face_target, first))
    fn.set_time(T_INFLOW / 2)
    opt.set_linearization_point(torch.as_tensor(u, dtype=F64))
    moved = opt.state.face_target
    # the ramp is linear in time up to its end
    assert torch.allclose(moved[0], first[0] / 2, rtol=1e-14, atol=0)


def _port_run(variant):
    """The port's driver on the stored variant, its power iterations
    started from the JAX vectors; (driver, Newton and GMRES per step)."""
    ref = SERIES["variants"][variant]
    drv = TDriver(TParams.from_dict(_config(variant)), device="cpu")
    drv.setup()
    drv._setup_done = True
    drv.preconditioner.power_start = _jax_start
    recs = drv.run(max_steps=ref["steps"])
    assert len(recs) == len(ref["series"])
    newton = [s["newton"] for s in drv.step_stats]
    gmres = [s["gmres"] for s in drv.step_stats]
    return drv, recs, newton, gmres


def test_nitsche_driver_against_stored_series():
    """Three steps of the Nitsche variant: the JAX driver's iterations,
    its solution within 1e-9, converged steps, a slip cylinder."""
    ref = SERIES["variants"]["nitsche"]
    drv, recs, newton, gmres = _port_run("nitsche")
    assert newton == ref["newton"] and gmres == ref["gmres"]
    tol = drv.params.nonlinear_tolerance
    assert all(s["newton_residual"] <= tol for s in drv.step_stats)
    u = drv.solution.current.numpy()
    _close(u, ref["solution"], 1e-9)
    for r, q in zip(recs, ref["series"]):
        assert r["t"] == pytest.approx(q["t"], rel=1e-14)
        for key in ("drag", "lift", "p_diff"):
            assert abs(r[key] - q[key]) <= 1e-6 * max(abs(q[key]), 1.0)
    nodes, normals = drv.space.boundary_node_normals([2])
    assert np.abs((u[nodes, :2] * normals).sum(axis=1)).max() < 1e-9


def test_cut_driver_against_stored_series():
    """Two steps of the directional do-nothing variant: finite, and the
    JAX driver's iterations."""
    ref = SERIES["variants"]["cut"]
    drv, _, newton, gmres = _port_run("cut")
    assert newton == ref["newton"] and gmres == ref["gmres"]
    u = drv.solution.current.numpy()
    assert np.isfinite(u).all()
    _close(u, ref["solution"], 1e-9)
