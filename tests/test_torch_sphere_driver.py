"""The sphere end to end: ``input/sphere_amg.json`` at refinement 1 (Q1
and Q2; one stationary exact-Newton solve, f64 outer, f32 GMG levels over
an iso-Q1 coarsest level with AMG, iterated), ``input/sphere_direct.json``
at refinement 1, Q1 (the non-default AMG parameters) and
``input/sphere.json`` as given (Q1, refinement 0, BDF-2, inexact Newton,
direct coarse) for 2 steps, through the JAX ``Driver`` and the port's
``Driver`` on the CPU.

The JAX driver on the CPU runs its f32 levels on the general sweep (its
fused sweeps are picked on the TPU only); the port runs them on the
patch-3D sweep's plain version (the iso-Q1 coarsest level on the general
sweep in both), so the two preconditioners differ by f32 round-off; both
power iterations start from the JAX package's start vectors.  The two
spaces share their numbering (``tests/test_torch_sphere.py``), so the
solution vectors compare row for row.  Tolerances: Newton iterations
equal per step, GMRES iterations within 1 per step (the f32 round-off of
the two levels' sweeps: the first step of ``sphere.json`` takes 132 on
both at one torch thread, 131 on the port at eight); the solution within 1e-6
of its max-abs (the Newton tolerance bounds what two converged solves may
differ by).  Measured on a CPU, both sides: Newton 5 and GMRES 14 (ref-1
Q1, AMG and direct), Newton 5 and GMRES 19 (ref-1 Q2), Newton 9, 8 and
GMRES 132, 48 (``sphere.json``); solution gaps 2.1e-12, 8.5e-11,
2.1e-12 and 3.5e-11 of the max-abs.  The
boundary conditions as the JAX package's ``tests/test_sphere_checkpoint.py``
checks them: n.u below 1e-9 on the slip walls (id 2), |u| below 1e-12
on the sphere (id 0).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.config import Parameters as JParams
from ns_gls_tpu.driver import Driver as JDriver
import ns_gls_tpu.utils.logging as jlog
from ns_gls_tpu_torch.config import Parameters as TParams
from ns_gls_tpu_torch.driver import Driver as TDriver
from ns_gls_tpu_torch.ops import patch3d as tp3
import ns_gls_tpu_torch.utils.logging as tlog
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


jlog.set_verbose(False)
tlog.set_verbose(False)

REL = 1e-6
INPUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "input")


def _raw(name, overrides):
    with open(os.path.join(INPUT, name)) as f:
        raw = json.load(f)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    raw.update(overrides)
    return raw


def _jax_start(level, shape, dtype, device):
    """The JAX GMG power iteration's start vector on ``level``."""
    v = jax.random.normal(jax.random.PRNGKey(31 + level), shape, jnp.float32)
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def _run_jax(raw, steps):
    """Newton and GMRES iterations per step, and the solution."""
    drv = JDriver(JParams.from_dict(raw))
    drv.setup()
    drv._setup_done = True
    nl = drv.nonlinear_solver
    gmres, newton = [0], []
    solve = nl.solve_with_jacobian

    def counted_solve(rhs):
        x = solve(rhs)
        gmres[-1] += drv.linear_solver._last_it
        return x

    nl.solve_with_jacobian = counted_solve
    post = drv.sim.postprocess

    def recorded_post(t, sol):
        newton.append(nl.last_iterations)
        gmres.append(0)
        return post(t, sol)

    drv.sim.postprocess = recorded_post
    drv.run(max_steps=steps)
    return newton[1:], gmres[1:-1], np.asarray(drv.solution.current)


def _check_bcs(drv, u):
    nodes, normals = drv.space.boundary_node_normals([2])
    assert len(nodes) > 0
    assert np.abs((u[nodes, :3] * normals).sum(axis=1)).max() < 1e-9
    assert np.abs(u[drv.space.boundary_nodes([0]), :3]).max() < 1e-12


@pytest.mark.parametrize("name,overrides,steps,n_dofs", [
    ("sphere_amg.json", {"n global refinements": 1, "fe degree": 1}, 1,
     1960),
    ("sphere_amg.json", {"n global refinements": 1}, 1, 13896),
    ("sphere_direct.json", {"n global refinements": 1, "fe degree": 1}, 1,
     1960),
    ("sphere.json", {}, 2, 312),
], ids=["amg_ref1_q1", "amg_ref1_q2", "direct_ref1_q1", "bdf2_ref0_q1"])
def test_sphere_driver_against_jax(name, overrides, steps, n_dofs,
                                   monkeypatch):
    raw = _raw(name, overrides)
    newton_j, gmres_j, u_j = _run_jax(raw, steps)

    calls = {"patch3d": 0}
    sweep = tp3.patch3d_sweep

    def counted_sweep(*a, **kw):
        calls["patch3d"] += 1
        return sweep(*a, **kw)

    monkeypatch.setattr(tp3, "patch3d_sweep", counted_sweep)
    drv = TDriver(TParams.from_dict(raw), device="cpu")
    drv.setup()
    drv._setup_done = True
    drv.preconditioner.power_start = _jax_start
    drv.run(max_steps=steps)

    assert drv.space.n_nodes * 4 == n_dofs == u_j.size
    # f32 levels on the patch-3D sweep, but an iso-Q1 coarsest level on
    # the general one; the f64 outer operator on the general sweep
    for op in drv.mg_ops:
        if op.space.iso_q1:
            assert op._fast is None
        else:
            assert isinstance(op._fast, tp3.Patch3DSweep)
    assert drv.mg_ops[0].space.iso_q1 == raw.get(
        "gmg coarse grid use fe q iso q1", False)
    assert drv.op._fast is None
    assert calls["patch3d"] > 0

    stats = drv.step_stats
    assert len(stats) == steps
    tol = drv.params.nonlinear_tolerance
    assert all(s["newton_residual"] <= tol for s in stats)
    assert [s["newton"] for s in stats] == newton_j
    assert len(gmres_j) == steps
    assert all(abs(s["gmres"] - g) <= 1 for s, g in zip(stats, gmres_j))

    u_t = drv.solution.current.numpy()
    assert np.isfinite(u_t).all()
    assert np.abs(u_t - u_j).max() <= REL * np.abs(u_j).max()
    _check_bcs(drv, u_t)


def test_sphere_first_step_is_deterministic():
    """Two runs of the first ``input/sphere.json`` step in one process, with
    torch's intra-op pool at four threads, give bit-identical solutions and
    the same GMRES count: the sums into the Jacobi diagonal and the dense
    coarse matrix do not depend on the thread schedule (a float32
    ``index_put_(..., accumulate=True)`` there gave GMRES 132 in one run,
    134 in another)."""
    raw = _raw("sphere.json", {})
    runs = []
    with torch_threads(4):
        for _ in range(2):
            drv = TDriver(TParams.from_dict(raw), device="cpu")
            drv.setup()
            drv._setup_done = True
            drv.run(max_steps=1)
            runs.append((drv.step_stats[0]["gmres"],
                         drv.solution.current.clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
