"""The slice end to end: Turek 2D-2 (``input/turek_2d_re100.json``) at
refinement 1 for three BDF-2 steps through the JAX ``Driver`` (CPU, f64
outer solve, f32 GMG levels on the general sweep) and through the port's
``Driver`` on the CPU (f64 outer, f32 GMG levels on the patch-2D sweep's
plain version), and a restart of the port from the JAX state after step 2.

Both power iterations (the GMG smoother damping) start from the JAX
package's start vectors, fed to the port, so the two preconditioners
differ only by f32 round-off.  Tolerances: Newton iterations equal per
step; GMRES iterations within 1 per step; drag, lift and pressure drop
within 1e-6 relative.  Measured on a CPU: Newton 0, 7, 5 and GMRES 0,
91, 17 on both sides; the largest gap is 2.9e-9 relative (lift, step 3),
drag and pressure drop agree to 2.4e-10.
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
import ns_gls_tpu_torch.utils.logging as tlog

jlog.set_verbose(False)
tlog.set_verbose(False)

N_STEPS = 3
REL = 1e-6
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "input", "turek_2d_re100.json")


def _raw():
    with open(CONFIG) as f:
        raw = json.load(f)
    raw.update({"n global refinements": 1, "paraview prefix": "",
                "output granularity": 0.0})
    return raw


def _jax_start(level, shape, dtype, device):
    """The JAX GMG power iteration's start vector on ``level``."""
    v = jax.random.normal(jax.random.PRNGKey(31 + level), shape, jnp.float32)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


def _counting(drv, gmres_its, newton_its, states, jax_side):
    """Wrap the solvers' callbacks to record per-step iteration counts
    (and, for JAX, the state after each step)."""
    nl = drv.nonlinear_solver
    solve = nl.solve_with_jacobian

    def counted_solve(rhs):
        x = solve(rhs)
        ls = drv.linear_solver
        gmres_its[-1] += ls._last_it if jax_side else ls.last_iterations
        return x

    nl.solve_with_jacobian = counted_solve
    post = drv.sim.postprocess

    def recorded_post(t, sol):
        rec = post(t, sol)
        newton_its.append(nl.last_iterations)
        gmres_its.append(0)
        if jax_side:
            states.append((
                [np.asarray(v) for v in drv.solution.vectors],
                list(drv.time_integrator._dt), t,
            ))
        return rec

    drv.sim.postprocess = recorded_post


@pytest.fixture(scope="module")
def jax_run():
    drv = JDriver(JParams.from_dict(_raw()))
    drv.setup()
    drv._setup_done = True
    gm, nw, states = [0], [], []
    _counting(drv, gm, nw, states, True)
    recs = drv.run(max_steps=N_STEPS)
    return recs, nw[1:], gm[1:-1], states


def _port_driver(gm, nw):
    drv = TDriver(TParams.from_dict(_raw()), device="cpu")
    drv.setup()
    drv._setup_done = True
    drv.preconditioner.power_start = _jax_start
    _counting(drv, gm, nw, None, False)
    return drv


def _check_records(recs_t, recs_j):
    assert len(recs_t) == len(recs_j)
    for rt, rj in zip(recs_t, recs_j):
        assert rt["t"] == pytest.approx(rj["t"], rel=1e-14)
        for key in ("drag", "lift", "p_diff"):
            assert np.isfinite(rt[key])
            assert abs(rt[key] - rj[key]) <= REL * abs(rj[key]), key


def test_turek2d_ref1_three_steps(jax_run):
    recs_j, newton_j, gmres_j, _ = jax_run
    gm, nw = [0], []
    drv = _port_driver(gm, nw)
    recs_t = drv.run(max_steps=N_STEPS)
    assert [s["newton"] for s in drv.step_stats] == newton_j
    assert nw[1:] == newton_j
    gmres_t = gm[1:-1]
    assert len(gmres_t) == len(gmres_j) == N_STEPS
    assert all(abs(a - b) <= 1 for a, b in zip(gmres_t, gmres_j))
    assert recs_t[-1]["drag"] != 0.0
    _check_records(recs_t, recs_j)


def test_restart_from_jax_state(jax_run):
    """SolutionHistory.from_numpy + the dt history: the port continues
    the JAX run from its state after step 2 and matches step 3."""
    recs_j, newton_j, _, states = jax_run
    vectors, dts, t2 = states[2]
    gm, nw = [0], []
    drv = _port_driver(gm, nw)
    drv.restart_from(vectors, dts, t2, counter=3)
    recs_t = drv.run(max_steps=N_STEPS)
    assert nw == newton_j[-1:]
    _check_records(recs_t, recs_j[-1:])


@pytest.mark.slow
def test_turek3d_ref0_against_stored_series():
    """The 3D slice end to end on the CPU: ``input/turek_3d_re100.json``
    at refinement 0 (16,704 DoFs; one GMG level, so the AMG coarse
    solver with the matrix-free prism level 0 carries the whole V-cycle)
    for four steps against the JAX package's series
    ``validation/turek_3d_re100_ref0_series.json``.  Measured on a CPU:
    Newton 0, 11, 5, 5, largest gap 1.2e-9 of max(|ref|, 1); about 720 s,
    almost all of it in step 2's coarse dense-LU solves, hence slow."""
    root = os.path.dirname(CONFIG)
    with open(os.path.join(root, "turek_3d_re100.json")) as f:
        raw = json.load(f)
    raw.update({"n global refinements": 0, "paraview prefix": "",
                "output granularity": 0.0})
    with open(os.path.join(os.path.dirname(root), "validation",
                           "turek_3d_re100_ref0_series.json")) as f:
        ref = json.load(f)["series"]
    drv = TDriver(TParams.from_dict(raw), device="cpu")
    recs = drv.run(max_steps=len(ref) - 1)
    assert drv.preconditioner.coarse_amg is not None
    tol = drv.params.nonlinear_tolerance
    assert all(s["newton_residual"] <= tol for s in drv.step_stats)
    assert len(drv.step_stats) == len(ref) - 1
    assert len(recs) == len(ref)
    for r, q in zip(recs, ref):
        for key in ("t", "drag", "lift", "p_diff"):
            assert abs(r[key] - q[key]) <= REL * max(abs(q[key]), 1.0), key


def test_cli_runs_on_cpu(tmp_path, capsys):
    """``python -m ns_gls_tpu_torch CONFIG --max-steps N --device cpu``
    on the coarse Turek mesh (refinement 0): two steps, finite records."""
    from ns_gls_tpu_torch.__main__ import main

    raw = _raw()
    raw["n global refinements"] = 0
    cfg = tmp_path / "turek0.json"
    cfg.write_text(json.dumps(raw))
    main([str(cfg), "--max-steps", "2", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("t = ")]
    assert len(lines) == 3
    assert "drag = nan" not in "".join(lines)


def test_cli_turek3d_refinement_override(tmp_path, monkeypatch, capsys):
    """``python -m ns_gls_tpu_torch input/turek_3d_re100.json
    --refinements 0 --max-steps 1 --device cpu``: the override reaches
    the driver (400 cells, 16,704 DoFs, one prism GMG level) and the
    step before the inflow writes finite records (output files go to
    the working directory, here a temporary one)."""
    from ns_gls_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    cfg = os.path.join(os.path.dirname(CONFIG), "turek_3d_re100.json")
    tlog.set_verbose(True)
    try:
        main([cfg, "--refinements", "0", "--max-steps", "1", "--device",
              "cpu"])
    finally:
        tlog.set_verbose(False)
    out = capsys.readouterr().out.splitlines()
    assert any("Global degrees of freedom: 16704" in ln for ln in out)
    lines = [ln for ln in out if ln.startswith("t = ")]
    assert len(lines) == 2
    assert "nan" not in "".join(lines)
