"""CPU tests of the benchmark harness at small sizes: the result line's
shape, cells found by name, the frozen work count, the plain reference
against the program, the faults and the float32 control that ``correct``
has to catch, and that nothing loads JAX or the JAX package."""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.cell import run_cell
from benchmark.harness.work import lattice_apply_work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOLVE, VMULT = "turek3d-re20.solve", "glsvmult-q2.vmult"
SMALL = {
    SOLVE: {"config": {"program": {"n_global_refinements": 0,
                                   "fe_degree": 1}}},
    VMULT: {"config": {"program": {"n_global_refinements": 2}},
            "traffic": {"sample_from": 5, "traced_applies": 10,
                        "check_every": 5}},
}
SEED = 2 ** 31 + 11


def small_run(workload, trace=0, seconds=0.05, overrides=None, **kw):
    ov = json.loads(json.dumps(SMALL[workload]))
    for part, over in (overrides or {}).items():
        for k, v in over.items():
            if isinstance(v, dict):
                ov.setdefault(part, {}).setdefault(k, {}).update(v)
            else:
                ov.setdefault(part, {})[k] = v
    return run_cell(ROOT, workload, SEED, seconds, trace, time.perf_counter(),
                    device="cpu", overrides=ov, **kw)[0]


@pytest.mark.parametrize("workload,trace", [(VMULT, 0), (VMULT, 1),
                                            (SOLVE, 0)])
def test_last_line_shape(workload, trace):
    bench = spec.load_benchmark(ROOT)
    cs = spec.cell_spec(bench, workload, ROOT)
    line = small_run(workload, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = cs["per_layer"] if trace else cs["end_to_end"]
    units = {m["name"]: m["unit"] for m in want}
    for name, m in line["metrics"].items():
        assert units[name] == m["unit"] and math.isfinite(m["value"])
    # device metrics are not read on the CPU; the rest are there
    assert "setup_s" in line["metrics"] or trace
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


def test_cli_refuses_without_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", VMULT, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_added_files_found_by_name(tmp_path):
    """A new configuration, traffic mix, kind of system, loop and metric
    are files and entries: the harness and the control find them with no
    edit to a file it has."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark(ROOT)
    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/"
                                      "glsvmult-q2.json")))
    cfg["program"]["n_global_refinements"] = 1
    cfg["system"] = "lattice_counted"
    (tmp_path / "benchmark/configs/glsvmult-q2-small.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark/systems/lattice_counted.py").write_text(
        "from benchmark.systems import lattice_operator\n"
        "reference_in_place = lattice_operator.reference_in_place\n"
        "class System(lattice_operator.System):\n"
        "    applies = 0\n"
        "    def apply(self, x):\n"
        "        System.applies += 1\n"
        "        return super().apply(x)\n")
    (tmp_path / "benchmark/loops/apply_counted.py").write_text(
        "from benchmark.loops import apply\n"
        "def run(system, *args):\n"
        "    apply.run(system, *args)\n"
        "    assert type(system).applies > 0\n")
    traffic = json.load(open(os.path.join(ROOT, "benchmark/traffic/"
                                          "vmult.json")))
    traffic.update(sample_from=3, check_every=3, loop="apply_counted")
    (tmp_path / "benchmark/traffic/vmult-short.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/metrics/applies_done.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    bench["configs"].append(dict(name="glsvmult-q2-small", source="test",
                                 file="benchmark/configs/glsvmult-q2-small"
                                 ".json", reduced=[], why="test"))
    bench["workloads"].append(dict(name="glsvmult-q2-small.short",
                                   config="glsvmult-q2-small",
                                   traffic="vmult-short", chips=1,
                                   why="test"))
    bench["end_to_end"].append(dict(name="applies_done", unit="applies",
                                    better="higher", bound=0.05,
                                    source="host_clock",
                                    workloads=["glsvmult-q2-small.short"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time, json; sys.path.insert(0, '.'); "
        f"sys.path.append({ROOT!r}); "
        "from benchmark.harness.cell import run_cell; "
        "from benchmark.harness import spec; "
        "from benchmark.control import control_of; "
        "line = run_cell('.', 'glsvmult-q2-small.short', 5, 0.05, 0, "
        "time.perf_counter(), device='cpu')[0]; "
        "cs = spec.cell_spec(spec.load_benchmark('.'), "
        "'glsvmult-q2-small.short', '.'); "
        "assert control_of(cs['config'], 'cpu')[1] is not None; "
        "print(json.dumps(line))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["applies_done"]["value"] == line["attempted"]
    # vmult_mdofs names its cells, so the new one does not report it
    assert set(line["metrics"]) == {"applies_done", "setup_s"}


def test_work_count_by_hand():
    """One Q1 cell with 2 Gauss points an axis, fixed flavor, cell-wise
    delta: the count written out by hand."""
    nbytes, flops = lattice_apply_work(3, (1, 1, 1), 1, 2, "fixed", True,
                                       True)
    n_nodes, nq = 8, 8
    # read u (4 components) and u*'s velocity (3), write 4; geometry: one
    # 3 x 3 J^-1, a weight, a cell size and two 2 x 2 1D tables
    assert nbytes == 4 * ((4 + 3) * n_nodes + 4 * n_nodes + 9 + 2 + 8)
    # sum factorization with gradients: 2 x 8 + 3 x 8 + 4 x 8 outputs, 2
    # FMAs each; values alone: 3 x 8 outputs; evaluate u and integrate
    # the result (4 components each), evaluate u*'s velocity (3)
    grads = (2 + 3 + 4) * 8 * 2
    vals = 3 * 8 * 2
    fmas = 4 * grads + 3 * vals + 4 * grads
    # per q-point: 4 x 15 gradient maps, |u*|^2 (5), the physics (80),
    # the test-function weights (1 + 4 x 19), delta (1); delta a cell (10)
    per_q = 4 * 15 + 5 + 80 + (1 + 4 * 19) + 1
    assert flops == 2 * fmas + nq * per_q + 10


def test_hypercube_reference_against_program():
    """The plain reference against the program's f64 general sweep
    (round-off) and its f32 structured sweep (f32 rounding)."""
    from benchmark.reference.cases.hypercube import Reference
    from benchmark.systems.lattice_operator import System

    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/"
                                      "glsvmult-q2.json")))
    cfg["program"]["n_global_refinements"] = 2
    g = torch.Generator().manual_seed(3)
    for precision, tol in (("f64", 1e-12), ("f32", 1e-6)):
        cfg["program"]["precision"] = precision
        sys_ = System(cfg, "cpu")
        u_lat, _ = sys_.draw_state(g)
        x = torch.randn((sys_.op.n_nodes, 4), generator=g,
                        dtype=torch.float64).to(sys_.dtype)
        y = sys_.apply(x)
        ref = Reference(cfg, u_lat.to(sys_.dtype), "cpu")
        gap = ref.judge(sys_.node_pos, [dict(x=x, y=y)])["apply_gap"]
        assert gap < tol, (precision, gap)


def test_cylinder_reference_against_program():
    """The reference's residual of the program's converged solve equals
    the Newton's own last residual, its boundary values and drag and lift
    the program's."""
    from benchmark.reference.cases.cylinder3d import Reference
    from benchmark.systems.driver import System

    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/"
                                      "turek3d-re20.json")))
    cfg["program"].update(n_global_refinements=0, fe_degree=1)
    s = System(cfg, "cpu")
    rec = s.solve([s.start.numpy()])
    last = s.step_stats()[-1]["newton_residual"]
    ref = Reference(cfg, "cpu")
    numbers = ref.judge(s.node_pos, [dict(
        u=s.solution().numpy(), record=rec)])
    assert abs(numbers["residual_l2"] - last) <= 1e-10 * last
    assert numbers["bc_gap"] < 1e-14
    assert numbers["functional_gap"] < 1e-12


def test_faults_are_not_correct():
    """The comparison catches a step that returns its state unchanged and
    an answer altered where it is produced."""
    def unchanged_solve(system):
        solve = system.solve

        def same(start):
            rec = solve(start)
            system.driver.solution.current = torch.as_tensor(
                start[0]).to(system.solution())
            return rec

        system.solve = same

    def unchanged_apply(system):
        system.apply = lambda x: x

    def altered_apply(system):
        apply = system.apply

        def one_off(x):
            y = apply(x).clone()
            y[7, 1] += 1e-3 * float(y.abs().max())
            return y

        system.apply = one_off

    assert small_run(SOLVE, wrap_system=unchanged_solve)["correct"] is False
    assert small_run(VMULT, wrap_system=unchanged_apply)["correct"] is False
    assert small_run(VMULT, wrap_system=altered_apply)["correct"] is False


def test_solve_control_is_not_correct():
    """The program's float32 path, the control the solve cell's
    configuration names."""
    from benchmark.control import control_of

    cs = spec.cell_spec(spec.load_benchmark(ROOT), SOLVE, ROOT)
    overrides, wrap = control_of(cs["config"], "cpu")
    assert overrides["config"]["program"]["precision"] == "f32"
    assert wrap is None
    line = small_run(SOLVE, overrides=overrides)
    assert line["correct"] is False


@pytest.mark.card
def test_vmult_control_is_not_correct():
    """The reference in float32 with TF32 products in the program's place,
    the control of the apply cell, at the cell's size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    from benchmark.control import control_of

    cs = spec.cell_spec(spec.load_benchmark(ROOT), VMULT, ROOT)
    overrides, wrap = control_of(cs["config"], torch.device("cuda"))
    assert overrides is None
    line, _ = run_cell(ROOT, VMULT, SEED, 1.0, 0, time.perf_counter(),
                       wrap_system=wrap)
    assert line["checks"]["apply_gap"]["value"] > 1e-4, line["checks"]
    assert line["correct"] is False


def test_nothing_loads_jax_or_the_jax_package():
    """A run of the harness, and the reference alone, load no module whose
    top-level name is jax, jaxlib, flax or ns_gls_tpu; the reference loads
    nothing of the program either."""
    code = (
        "import sys, time; sys.path.insert(0, '.'); "
        "import benchmark.reference.cases.cylinder3d, "
        "benchmark.reference.cases.hypercube; "
        "top = {m.split('.')[0] for m in sys.modules}; "
        "assert not top & {'jax', 'jaxlib', 'flax', 'ns_gls_tpu', "
        "'ns_gls_tpu_torch'}, top; "
        "from benchmark.harness.cell import run_cell, forbidden_modules; "
        "run_cell('.', 'glsvmult-q2.vmult', 3, 0.05, 0, time.perf_counter(), "
        "device='cpu', overrides={'config': {'program': "
        "{'n_global_refinements': 1}}, 'traffic': {'sample_from': 3, "
        "'check_every': 3}}); "
        "assert 'ns_gls_tpu_torch' in sys.modules; "
        "assert forbidden_modules() == [], forbidden_modules(); "
        "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-2000:]
