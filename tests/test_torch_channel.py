"""The channel case of the port against the JAX package.

The model: ``SimulationChannel`` gives the same mesh (vertices, cells,
boundary ids, cell lattice), the same boundary descriptor and the same
``ChannelInflow`` values as the JAX model, in 2D and 3D.

The driver: ``input/channel.json`` as given (2D, Q1, refinement 2: 3,315
DoFs, five GMG levels) and with ``dim`` 3 at refinement 0 (3D, Q1, 1,700
DoFs, three GMG levels), two BDF-1 steps through both ``Driver``s on the
CPU.  The JAX driver on the CPU runs its f32 levels on the general sweep (its
structured sweep is picked on the TPU only), the port runs them on the
structured sweep's plain version, so the two preconditioners differ by
f32 round-off; both power iterations start from the JAX package's start
vectors.  Tolerances: Newton iterations equal per step, GMRES iterations
within 1 per step, the solution vector within 1e-6 of its max-abs (the
Newton tolerance 1e-7 bounds what two converged solves may differ by;
measured on a CPU: Newton 4, 5 and GMRES 10, 10 on both sides in both
cases; gaps 1.7e-8 in 2D and 1.7e-11 in 3D).
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
from ns_gls_tpu.models import make_simulation as jmake
import ns_gls_tpu.utils.logging as jlog
from ns_gls_tpu_torch.config import Parameters as TParams
from ns_gls_tpu_torch.driver import Driver as TDriver
from ns_gls_tpu_torch.models import make_simulation as tmake
from ns_gls_tpu_torch.models.channel import SimulationChannel
from ns_gls_tpu_torch.ops import structured as ts
import ns_gls_tpu_torch.utils.logging as tlog
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


jlog.set_verbose(False)
tlog.set_verbose(False)

N_STEPS = 2
REL = 1e-6
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "input", "channel.json")


@pytest.mark.parametrize("dim", [2, 3])
def test_channel_model_equals_jax(dim):
    sj, st = jmake("channel", dim), tmake("channel", dim)
    assert isinstance(st, SimulationChannel)
    mj, mt = sj.create_mesh(0), st.create_mesh(0)
    assert mt.n_cells == 4 * 4 ** dim
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.cells, mj.cells)
    np.testing.assert_array_equal(mt.lattice, mj.lattice)
    assert tuple(mt.lattice_shape) == tuple(mj.lattice_shape)
    np.testing.assert_array_equal(mt.boundary_ids, mj.boundary_ids)
    bj, bt = sj.get_boundary_descriptor(), st.get_boundary_descriptor()
    assert bt.all_homogeneous_dbcs == bj.all_homogeneous_dbcs
    assert bt.all_homogeneous_nbcs == bj.all_homogeneous_nbcs == [1]
    assert [b for b, _ in bt.all_inhomogeneous_dbcs] == [0]
    assert not bt.all_outflow_bcs_cut and not bt.all_outflow_bcs_nitsche
    fj, ft = bj.all_inhomogeneous_dbcs[0][1], bt.all_inhomogeneous_dbcs[0][1]
    pts = np.random.default_rng(0).random((7, dim))
    for t in (0.0, 0.3):
        fj.set_time(t)
        ft.set_time(t)
        for comp in range(dim):
            np.testing.assert_array_equal(ft(pts, comp), fj(pts, comp))
    assert st.get_u_max() == sj.get_u_max()


def test_unported_simulations_are_named():
    """Every simulation of the JAX package is ported (the last, rotation,
    with the local-smoothing multigrid); an unknown name is refused."""
    from ns_gls_tpu_torch.models import PORTED, UNPORTED

    assert UNPORTED == ()
    assert sorted(PORTED) == ["channel", "cylinder", "rotation", "sphere"]
    assert type(tmake("rotation", 2)).__name__ == "SimulationRotation"
    with pytest.raises(ValueError):
        tmake("no such case", 2)


def _raw(overrides):
    with open(CONFIG) as f:
        raw = json.load(f)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    raw.update(overrides)
    return raw


def _jax_start(level, shape, dtype, device):
    """The JAX GMG power iteration's start vector on ``level``."""
    v = jax.random.normal(jax.random.PRNGKey(31 + level), shape, jnp.float32)
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def _run_jax(raw):
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
    drv.run(max_steps=N_STEPS)
    assert all(op._ssweep is None for op in drv.mg_ops)
    return newton[1:], gmres[1:-1], np.asarray(drv.solution.current)


@pytest.mark.parametrize("overrides,n_dofs,n_levels", [
    ({}, 3315, 5),
    ({"dim": 3, "n global refinements": 0}, 1700, 3),
], ids=["2d_as_given", "3d_ref0"])
def test_channel_driver_against_jax(overrides, n_dofs, n_levels, monkeypatch):
    raw = _raw(overrides)
    newton_j, gmres_j, u_j = _run_jax(raw)

    calls = {"structured": 0}
    sweep = ts.structured_sweep

    def counted_sweep(*a, **kw):
        calls["structured"] += 1
        return sweep(*a, **kw)

    monkeypatch.setattr(ts, "structured_sweep", counted_sweep)
    drv = TDriver(TParams.from_dict(raw), device="cpu")
    drv.setup()
    drv._setup_done = True
    drv.preconditioner.power_start = _jax_start
    drv.run(max_steps=N_STEPS)

    dim = raw["dim"]
    assert drv.space.n_nodes * (dim + 1) == n_dofs == u_j.size
    # every f32 level runs the structured sweep, the f64 outer operator
    # the general one
    assert len(drv.mg_ops) == n_levels
    assert all(isinstance(op._fast, ts.StructuredSweep)
               for op in drv.mg_ops)
    assert drv.op._fast is None
    assert calls["structured"] > 0

    stats = drv.step_stats
    assert len(stats) == N_STEPS
    tol = drv.params.nonlinear_tolerance
    assert all(s["newton_residual"] <= tol for s in stats)
    assert [s["newton"] for s in stats] == newton_j
    assert all(abs(s["gmres"] - g) <= 1 for s, g in zip(stats, gmres_j))

    u_t = drv.solution.current.numpy()
    assert np.isfinite(u_t).all()
    assert np.abs(u_t - u_j).max() <= REL * np.abs(u_j).max()
    # the inflow is enforced and the outflow pressure is pinned
    inflow = drv.space.boundary_nodes([0])
    walls = set(drv.space.boundary_nodes(
        list(range(2, 2 * dim))).tolist())
    inner = np.array([n for n in inflow if n not in walls])
    assert np.allclose(u_t[inner, 0], 1.0)
    assert np.allclose(u_t[drv.space.boundary_nodes([1]), dim], 0.0)


def test_cli_channel_overrides(tmp_path, monkeypatch, capsys):
    """``python -m ns_gls_tpu_torch input/channel.json --dim 3 --degree 2
    --refinements 0 --max-steps 1 --device cpu``: the overrides reach the
    driver (64 cells of Q2 in 3D: 10,692 DoFs) and the step converges."""
    from ns_gls_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    tlog.set_verbose(True)
    try:
        main([CONFIG, "--dim", "3", "--degree", "2", "--refinements", "0",
              "--max-steps", "1", "--device", "cpu"])
    finally:
        tlog.set_verbose(False)
    out = capsys.readouterr().out.splitlines()
    assert any("Global degrees of freedom: 10692" in ln for ln in out)
    steps = [ln for ln in out if ln.startswith("step 1:")]
    assert len(steps) == 1 and "nan" not in steps[0]
