"""The port's local-smoothing multigrid (``precond/gmg_ls.py``, the
reference's GMG-LS) against the JAX package's ``PreconditionerGMGLS``,
and the port's own invariants of the cycle, on the CPU.

- One V-cycle on ``input/rotation.json``'s mesh at refinement 2 (the
  JAX test's setting: five forest levels, the last one the boundary
  strip): both drivers set up, the same solution history, time step and
  linearization point on every level, the power iterations started from
  the JAX package's vectors; the two applications agree to
  ``VMULT_REL`` of the JAX max-abs.  Both sides keep the levels in f32 and
  sum in different orders (JAX: the general sweep; the port: the
  patch-2D sweep's plain version), and the cycle amplifies the rounding:
  measured on a CPU, 5.1e-6 (the port against itself with the general
  sweep on its levels: 3.5e-6).
- ``input/rotation.json`` at refinement 2 for three steps through the
  port's driver against the JAX driver's runs stored by
  ``tools/rotation_series.py`` in ``validation/rotation_ref2_series.json.gz``:
  with f64 levels, Newton equal and GMRES within 1 a step; as given (f32
  levels), GMRES within ``LS_GMRES_REL`` (which says why); the
  solutions within 10x the gap measured on a CPU.
- On a globally refined mesh every forest level covers the domain and
  the edge sets are empty, so the LS cycle is the global-coarsening one
  (mirrors the JAX package's ``tests/test_gmg_ls.py``).
- On an adaptively refined mesh some level has a refinement edge.
"""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.config import Parameters as JParams
from ns_gls_tpu.driver import Driver as JDriver
from ns_gls_tpu.ops.time_integration import SolutionHistory as JHist
import ns_gls_tpu.utils.logging as jlog
from ns_gls_tpu_torch.config import Parameters as TParams
from ns_gls_tpu_torch.driver import Driver as TDriver
from ns_gls_tpu_torch.ops.time_integration import SolutionHistory as THist
from ns_gls_tpu_torch.precond.gmg import PreconditionerGMG
from ns_gls_tpu_torch.precond.gmg_ls import PreconditionerGMGLS
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
VMULT_REL = 5e-5          # 10x the gap measured on a CPU (5.1e-6)
# The driver runs of ``input/rotation.json`` at refinement 2 with f32
# levels, as given: with the JAX package's start vectors GMRES takes
# 50-100 iterations a Newton step, and the count follows the f32 rounding
# of the levels.  The port against itself with the general sweep in place
# of the patch-2D sweep on its levels (another summation order) moves a
# step's count by up to 30 of 295 (10%) under GMG-LS and 45 of 159 (28%)
# under GMG.  Measured against JAX on a CPU: GMG-LS (3, 295), (2, 206),
# (2, 178) against (3, 290), (2, 205), (2, 179); GMG (3, 159), (2, 96),
# (2, 124) against (3, 153), (2, 120), (2, 134).  With f64 levels the
# rounding drops out and the GMG-LS counts are equal (104, 83, 82).
LS_GMRES_REL = 0.1
GMG_GMRES_REL = 0.3

with gzip.open(os.path.join(ROOT, "validation",
                            "rotation_ref2_series.json.gz"), "rt") as _f:
    SERIES = json.load(_f)["runs"]


def rotation_raw(refinements=2, preconditioner="GMG-LS"):
    with open(os.path.join(ROOT, "input", "rotation.json")) as f:
        raw = json.load(f)
    raw.update({"n global refinements": refinements, "paraview prefix": "",
                "output granularity": 0.0, "preconditioner": preconditioner})
    return raw


def jax_start(seed0):
    """The JAX multigrid's power-iteration start vectors (PRNGKey(seed0 +
    level), in the level's precision) as the port's ``power_start``."""
    def start(level, shape, dtype, device):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        v = jax.random.normal(jax.random.PRNGKey(seed0 + level), shape, jdt)
        return torch.as_tensor(np.array(v), dtype=dtype, device=device)
    return start


def port_run(name, seed0):
    """The port's driver on the CPU on the stored run ``name``'s
    configuration for its steps, the power iterations started from the
    JAX package's vectors."""
    ref = SERIES[name]
    drv = TDriver(TParams.from_dict(ref["config"]), device="cpu")
    drv.setup()
    drv._setup_done = True
    drv.preconditioner.power_start = jax_start(seed0)
    drv.run(max_steps=ref["steps"])
    return drv


def check_parity(td, name, gap_tol, gmres_rel=0.0):
    """Against the stored JAX run ``name``: Newton iterations equal per
    step, GMRES within 1 or ``gmres_rel`` of the JAX count per step,
    whichever is more, the solutions within ``gap_tol`` of the JAX
    max-abs; returns the gap."""
    ref = SERIES[name]
    stats = [(s["newton"], s["gmres"]) for s in td.step_stats]
    assert [n for n, _ in stats] == ref["newton"], (stats, ref["newton"])
    for (_, g), gj in zip(stats, ref["gmres"]):
        assert abs(g - gj) <= max(1, gmres_rel * gj), (stats, ref["gmres"])
    u = np.asarray(ref["solution"])
    gap = np.abs(td.solution.current.numpy() - u).max() / np.abs(u).max()
    assert gap <= gap_tol, gap
    return gap


def _prepare(drv, hist, dt, u, jax_side):
    """The state a Newton step of the time loop gives the preconditioner:
    step size, solution history and linearization point on every level,
    then the smoother state and the coarse solver."""
    drv.time_integrator.update_dt(dt)
    for op_l in drv.mg_ops:
        op_l.invalidate_system()
        op_l.update_weight()
    drv.op.update_weight()
    if jax_side:
        drv.solution = JHist([jnp.asarray(h) for h in hist])
        drv._set_previous_solution()
        levels = drv._interpolate_to_levels(jnp.asarray(u))
    else:
        drv.solution = THist.from_numpy(hist, torch.float64, "cpu")
        drv._set_previous_solution()
        levels = drv._level_chain(torch.as_tensor(u))
    for op_l, u_l in zip(drv.mg_ops, levels):
        op_l.set_linearization_point(u_l)
    drv.preconditioner.initialize()


def _state(n_nodes, seed=0):
    rng = np.random.default_rng(seed)
    hist = [rng.standard_normal((n_nodes, 3)) * 0.3 for _ in range(2)]
    return hist, hist[0] + 0.01 * rng.standard_normal((n_nodes, 3))


def test_vmult_matches_jax():
    jd = JDriver(JParams.from_dict(rotation_raw()))
    jd.setup()
    td = TDriver(TParams.from_dict(rotation_raw()), device="cpu")
    td.setup()
    assert isinstance(td.preconditioner, PreconditionerGMGLS)
    assert [s.n_nodes for s in td.mg_spaces] == [
        s.n_nodes for s in jd.mg_spaces]
    td.preconditioner.power_start = jax_start(47)
    hist, u = _state(td.space.n_nodes)
    _prepare(jd, hist, 0.01, u, True)
    _prepare(td, hist, 0.01, u, False)
    for o_t, o_j in zip(td.preconditioner.omegas[1:],
                        jd.preconditioner.vmult_args[3][1:]):
        assert float(o_t) == pytest.approx(float(o_j), rel=1e-5)
    x = np.random.default_rng(1).standard_normal((td.space.n_nodes, 3))
    ref = np.asarray(jd.preconditioner.vmult(jnp.asarray(x)))
    got = td.preconditioner.vmult(torch.as_tensor(x)).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= VMULT_REL, err
    # identity (in the levels' f32) on the rows the outer system
    # constrains
    rows = td.csets.homogeneous.rows.numpy()
    assert len(rows) and np.array_equal(
        got.reshape(-1)[rows], x.astype(np.float32).reshape(-1)[rows])


CHANNEL = {
    "dim": 2, "fe degree": 2, "n global refinements": 1,
    "simulation name": "channel", "cfl": 0.1, "t final": 0.1,
    "bdf order": 1, "time intration": "bdf", "nu": 0.01,
    "consider time derivative": True, "lin relative tolerance": 1e-8,
    "gmg coarse grid solver": "direct", "nonlinear solver": "Newton",
    "output granularity": 0.0, "paraview prefix": "",
}


def test_ls_equals_gc_on_uniform_mesh():
    """Empty edge sets: the LS cycle is the GC cycle.  One step of the
    channel (Q2, refinement 1) under each: the same fixed point (the
    outer solve is f64; measured gap 1.5e-11 of the max-abs), Newton
    equal, GMRES within the omega estimates' wiggle (each flavor seeds
    its power iterations differently, as the JAX package does)."""
    runs = {}
    for prec in ("GMG", "GMG-LS"):
        d = TDriver(TParams.from_dict(CHANNEL | {"preconditioner": prec}),
                    device="cpu")
        d.run(max_steps=1)
        runs[prec] = d
    gc, ls = runs["GMG"], runs["GMG-LS"]
    assert isinstance(ls.preconditioner, PreconditionerGMGLS)
    assert type(gc.preconditioner) is PreconditionerGMG
    assert ([s.n_nodes for s in ls.mg_spaces]
            == [op.space.n_nodes for op in gc.mg_ops])
    # every level covers the domain: no refinement edge
    assert all(bool((m == 1).all()) for m in ls.preconditioner.masks)
    a = gc.solution.current.numpy()
    b = ls.solution.current.numpy()
    scale = max(1.0, np.abs(a).max())
    assert np.abs(a - b).max() <= 1e-6 * scale
    sg, sl = gc.step_stats[0], ls.step_stats[0]
    assert sg["newton"] == sl["newton"]
    assert abs(sg["gmres"] - sl["gmres"]) <= 3


def adaptive_cylinder_raw(preconditioner):
    """The JAX test's adaptive channel (``tests/test_gmg_ls.py``
    ``_adaptive_channel_driver``): the cylinder with an extra length,
    refined in the wake only."""
    return CHANNEL | {
        "preconditioner": preconditioner,
        "simulation name": "cylinder",
        "n global refinements": 2,
        "nu": 0.001,
        "simulation u max": 0.3,
        "simulation geometry extra length": 0.8,
        "nonlinear tolerance": 1e-5,
    }


def test_ls_interface_masks_nontrivial_on_adaptive():
    """The refinement edge engages on an adaptive mesh: some level's mask
    has zeros, the level spaces grow coarse to fine, and the masks, the
    level sizes and the injection equal the JAX package's."""
    td = TDriver(TParams.from_dict(adaptive_cylinder_raw("GMG-LS")),
                 device="cpu")
    td.setup()
    assert td.mesh.is_adaptive
    masks = td.preconditioner.masks
    assert any(float(m.min()) == 0.0 for m in masks[1:])
    sizes = [s.n_nodes for s in td.mg_spaces]
    assert sizes == sorted(sizes)
    jd = JDriver(JParams.from_dict(adaptive_cylinder_raw("GMG-LS")))
    jd.setup()
    assert sizes == [s.n_nodes for s in jd.mg_spaces]
    for mt, mj in zip(masks, jd.preconditioner._masks):
        assert np.array_equal(mt.numpy(), np.asarray(mj))
    for (ln, fn), (lj, fj) in zip(td._ls_lvl2fin, jd._ls_lvl2fin):
        assert np.array_equal(ln.numpy(), lj)
        assert np.array_equal(fn.numpy(), fj)


def test_assignments_refuse_repeated_targets():
    """An injection or collection map with a repeated target is refused
    when the preconditioner is built (an index assignment with repeated
    targets keeps an arbitrary value on the card)."""
    from ns_gls_tpu_torch.precond.gmg_ls import _assignment

    t, s = _assignment([3, 1, 2], [0, 1, 2], "cpu", "x")
    assert t.tolist() == [3, 1, 2] and s.tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="repeated target"):
        _assignment([1, 1], [0, 1], "cpu", "x")


def test_stored_configurations():
    """The stored JAX runs ran the configurations these tests name."""
    assert SERIES["rotation_ls"]["config"] == rotation_raw(2, "GMG-LS")
    assert SERIES["rotation_ls_f64"]["config"] == (
        rotation_raw(2, "GMG-LS") | {"mg precision": "f64"})
    assert SERIES["rotation_gmg"]["config"] == rotation_raw(2, "GMG")
    assert SERIES["cylinder_gmg"]["config"] == adaptive_cylinder_raw("GMG")


def test_rotation_ls_f64_levels_matches_jax():
    """``input/rotation.json`` at refinement 2 under GMG-LS with f64
    levels, three steps: Newton equal, GMRES within 1 a step (measured:
    equal), the solutions within 10x the gap measured on a CPU (7.2e-15
    of the JAX max-abs)."""
    td = port_run("rotation_ls_f64", 47)
    assert isinstance(td.preconditioner, PreconditionerGMGLS)
    assert all(op.dtype == torch.float64 for op in td.mg_ops)
    check_parity(td, "rotation_ls_f64", 7.2e-14)


def test_rotation_ls_matches_jax():
    """``input/rotation.json`` at refinement 2 as given (GMG-LS, f32
    levels, direct coarse solve with the pressure pin), three steps:
    Newton equal, GMRES within ``LS_GMRES_REL``, the solutions within 10x
    the gap measured on a CPU (2.4e-7 of the JAX max-abs); the inner ring
    rotates rigidly (the JAX package's ``tests/test_rotation.py``)."""
    td = port_run("rotation_ls", 47)
    assert isinstance(td.preconditioner, PreconditionerGMGLS)
    assert td.mesh.is_adaptive and td.csets.homogeneous.rows.numel() > 0
    check_parity(td, "rotation_ls", 2.4e-6, LS_GMRES_REL)
    u = td.solution.current.numpy()
    pos = td.space.node_pos
    r = np.linalg.norm(pos, axis=1)
    inner = r < r.min() + 1e-8
    uth = (-pos[:, 1] * u[:, 0] + pos[:, 0] * u[:, 1]) / r
    np.testing.assert_allclose(uth[inner], r.min(), rtol=1e-8)
