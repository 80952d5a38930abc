"""CPU tests of the sphere cell (``sphere-amg.solve``) at refinement 1: the
plain reference's geometry against the program's, its residual, boundary
values and slip flux of a converged program solve, the faults and the
float32 control that ``correct`` has to catch, and that the run loads
nothing of JAX or the JAX package."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness.cell import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "sphere-amg.solve"
SEED = 2 ** 31 + 11
SMALL = {"n_global_refinements": 1, "fe_degree": 1}


def config(**over):
    with open(os.path.join(ROOT, "benchmark/configs/sphere-amg.json")) as f:
        cfg = json.load(f)
    cfg["program"].update(SMALL, **over)
    return cfg


def small_run(program=None, **kw):
    ov = {"config": {"program": dict(SMALL, **(program or {}))}}
    return run_cell(ROOT, CELL, SEED, 0.05, 0, time.perf_counter(),
                    device="cpu", overrides=ov, **kw)[0]


@pytest.mark.parametrize("degree", [1, 2])
def test_node_positions_match(degree):
    """The reference's nodes (the frozen Gmsh reader, spherical manifold
    and isoparametric mapping) are the program's, to 1e-9."""
    from benchmark.reference.cases.sphere3d import Reference
    from benchmark.systems.driver import System

    cfg = config(fe_degree=degree)
    s = System(cfg, "cpu")
    ref = Reference(cfg, "cpu")
    assert s.node_pos.shape == ref.space.node_pos.shape
    assert ref.to_reference(s.node_pos, np.zeros((len(s.node_pos), 4))) \
        is not None


@pytest.fixture(scope="module")
def solved():
    """A converged program solve from the configuration's start, its
    residual as the program computes it, and the reference."""
    from benchmark.reference.cases.sphere3d import Reference
    from benchmark.systems.driver import System

    cfg = config()
    s = System(cfg, "cpu")
    rec = s.solve([s.start.numpy()])
    u = s.solution()
    r = s.driver._evaluate_residual(u)
    last = s.step_stats()[-1]["newton_residual"]
    return s, rec, u.numpy(), r.numpy(), last, Reference(cfg, "cpu")


def _edges(ref):
    """Each slip-wall node's count of walls, and the (node, normal) rows
    of the nodes where two walls meet."""
    nodes = ref.slip_nodes.numpy()
    walls = np.bincount(nodes, minlength=ref.space.n_nodes)
    return walls, walls[nodes] == 2


def test_residual_against_program(solved):
    """The reference's residual equals the program's, to 1e-10 of its norm
    and row for row, but for the two normal rows of the nodes where two
    slip walls meet: the reference removes both normals there (deal.II's
    constraint), the program one averaged normal.  So its norm is at most
    the Newton's own last residual."""
    s, _, u, r_prog, last, ref = solved
    assert abs(float(np.linalg.norm(r_prog)) - last) <= 1e-12 * last
    r = ref.residual(ref.to_reference(s.node_pos, u))
    # the program's residual is the Newton right-hand side, -F(u)
    r_p = -ref.to_reference(s.node_pos, r_prog)
    walls, _ = _edges(ref)
    edge = torch.as_tensor(walls == 2)
    assert int(edge.sum()) > 0
    keep = torch.ones_like(r, dtype=torch.bool)
    keep[edge, 1:3] = False
    kept = float(torch.linalg.vector_norm(r_p[keep]))
    assert abs(float(torch.linalg.vector_norm(r[keep])) - kept) \
        <= 1e-10 * kept
    assert float((r - r_p)[keep].abs().max()) <= 1e-6 * last
    assert float(r[edge, 1:3].abs().max()) == 0.0
    numbers = ref.judge(s.node_pos, [dict(u=u)])
    assert numbers["residual_l2"] <= last * (1 + 1e-10)
    assert numbers["residual_l2"] >= 0.5 * last


def test_boundary_values_and_slip_flux(solved):
    """The Dirichlet values are held exactly and no flux crosses a single
    slip wall; where two walls meet, the program holds the flux through
    their averaged normal at zero, so the two walls' fluxes are equal in
    size, and small by the mesh's symmetry."""
    s, _, u, _, _, ref = solved
    numbers = ref.judge(s.node_pos, [dict(u=u)])
    assert numbers["bc_gap"] < 1e-14
    u_ref = ref.to_reference(s.node_pos, u)
    flux = (u_ref[ref.slip_nodes, :3] * ref.slip_n).sum(1).abs().numpy()
    _, at_edge = _edges(ref)
    assert flux[~at_edge].max() < 1e-14
    pairs = flux[at_edge].reshape(-1, 2)
    assert np.abs(pairs[:, 0] - pairs[:, 1]).max() < 1e-14
    assert numbers["slip_flux"] == flux.max() < 1e-8


def test_sound_run_is_correct():
    line = small_run()
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"residual_l2", "bc_gap", "slip_flux"}


def test_faults_are_not_correct():
    """A solve that returns its start, and an answer with 1e-6 added to
    the normal velocity of one slip-wall node."""
    def unchanged_solve(system):
        solve = system.solve

        def same(start):
            rec = solve(start)
            system.driver.solution.current = torch.as_tensor(
                start[0]).to(system.solution())
            return rec

        system.solve = same

    def leaking_wall(system):
        pos = system.node_pos
        node = int(np.flatnonzero(
            (np.abs(pos[:, 1] - 1.5) < 1e-9) & (np.abs(pos[:, 2]) < 1.4)
            & (np.abs(pos[:, 0]) < 1.4))[0])
        solution = system.solution

        def leaked():
            u = solution().clone()
            u[node, 1] += 1e-6
            return u

        system.solution = leaked

    line = small_run(wrap_system=unchanged_solve)
    assert line["correct"] is False
    line = small_run(wrap_system=leaking_wall)
    assert line["correct"] is False
    assert line["checks"]["slip_flux"]["value"] > 0.9e-6


def test_control_is_not_correct():
    """The program's float32 path, the control the configuration names."""
    from benchmark.control import control_of
    from benchmark.harness import spec

    cs = spec.cell_spec(spec.load_benchmark(ROOT), CELL, ROOT)
    overrides, wrap = control_of(cs["config"], "cpu")
    assert overrides["config"]["program"]["precision"] == "f32"
    assert wrap is None
    line = small_run(program=overrides["config"]["program"])
    assert line["correct"] is False


def test_sphere_run_loads_neither_jax_nor_the_jax_package():
    """The sphere's reference alone loads nothing of the program or JAX;
    a run of the cell loads the port and no module whose top-level name
    is jax, jaxlib, flax or ns_gls_tpu."""
    code = (
        "import sys, time; sys.path.insert(0, '.'); "
        "import benchmark.reference.cases.sphere3d; "
        "top = {m.split('.')[0] for m in sys.modules}; "
        "assert not top & {'jax', 'jaxlib', 'flax', 'ns_gls_tpu', "
        "'ns_gls_tpu_torch'}, top; "
        "from benchmark.harness.cell import run_cell, forbidden_modules; "
        "line, _ = run_cell('.', 'sphere-amg.solve', 3, 0.05, 0, "
        "time.perf_counter(), device='cpu', overrides={'config': "
        "{'program': {'n_global_refinements': 1, 'fe_degree': 1}}}); "
        "assert line['correct'], line['checks']; "
        "assert 'ns_gls_tpu_torch' in sys.modules; "
        "assert forbidden_modules() == [], forbidden_modules(); "
        "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-2000:]
