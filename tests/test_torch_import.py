"""The PyTorch port stands alone: importing it (and its driver) loads
neither JAX nor the JAX package, no port source names them, and its entry
points refuse to fall back to the CPU on their own."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    # a fresh interpreter: this test process already imported jax
    code = (
        "import json, sys\n"
        "import ns_gls_tpu_torch, ns_gls_tpu_torch.driver\n"
        "import ns_gls_tpu_torch.__main__\n"
        "import ns_gls_tpu_torch.ops.structured\n"
        "import ns_gls_tpu_torch.models.channel\n"
        "import ns_gls_tpu_torch.models.sphere, ns_gls_tpu_torch.mesh.gmsh\n"
        "import ns_gls_tpu_torch.ops.patch3d\n"
        "import ns_gls_tpu_torch.mesh.forest\n"
        "import ns_gls_tpu_torch.models.rotation\n"
        "import ns_gls_tpu_torch.precond.gmg_ls\n"
        "import ns_gls_tpu_torch.utils.roofline\n"
        "import ns_gls_tpu_torch.ops.matrix_based\n"
        "import ns_gls_tpu_torch.precond.ilu, ns_gls_tpu_torch.precond.amg\n"
        "import ns_gls_tpu_torch.utils.checkpoint\n"
        "import ns_gls_tpu_torch.parallel.halo, "
        "ns_gls_tpu_torch.parallel.sharding\n"
        "import bench_gpu, chip_smoke\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'ns_gls_tpu' "
        "or m.startswith('ns_gls_tpu.'))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)|ns_gls_tpu\.", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "bench_gpu.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "ns_gls_tpu_torch")):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert offenders == []


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils.device import resolve_device

    # decide "no card" here, whatever the machine has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = Parameters.from_file(os.path.join(ROOT, "input",
                                               "turek_2d_re100.json"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Driver(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert Driver(params, device="cpu").device == torch.device("cpu")


def test_unported_configuration_raises(monkeypatch):
    """What the port does not cover yet: a degree above the fused
    kernels' (1-6) raises when an f32 level's tables are built.  Sharding
    (``n devices`` > 1) is ported: a driver builds on CPU shards, and
    asking for more cards than there are raises."""
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.parallel.halo import HaloShardedOperator

    params = Parameters.from_dict({"preconditioner": "GMG",
                                   "nonlinear solver": "Newton",
                                   "gmg coarse grid solver": "direct",
                                   "simulation name": "channel",
                                   "n global refinements": 0,
                                   "n devices": 2})
    drv = Driver(params, device="cpu")
    drv.setup()
    assert isinstance(drv.op, HaloShardedOperator)
    assert drv.devices == (torch.device("cpu"),) * 2
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="requested 2 devices"):
            Driver(params, device="cuda")
    with open(os.path.join(ROOT, "input", "channel.json")) as f:
        raw = json.load(f)
    params = Parameters.from_dict(raw | {"fe degree": 7,
                                         "n global refinements": 1,
                                         "output granularity": 0.0})
    drv = Driver(params, device="cpu")
    with pytest.raises(ValueError, match="degrees 1-6, not 7"):
        drv.setup()


# every configuration key this slice ported, with a value that selects it
SOLVER_OPTIONS = (
    {"preconditioner": "ILU"},
    {"preconditioner": "AMG"},
    {"preconditioner": "AMG", "amg smoother": "ilu"},
    {"linear solver": "Richardson"},
    {"nonlinear solver": "Picard"},
    {"nonlinear solver": "linearized"},
    {"gmg coarse grid solver": "ILU"},
    {"use matrix free ns operator": False, "nonlinear solver": "Picard"},
    {"checkpoint prefix": "ckpt", "checkpoint granularity": 0.1},
)


@pytest.mark.parametrize("option", SOLVER_OPTIONS,
                         ids=lambda o: "-".join(map(str, o.values())))
def test_every_solver_option_is_ported(option):
    """A driver builds with each solver-stack option on the CPU."""
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver

    params = Parameters.from_dict({"simulation name": "channel",
                                   "n global refinements": 0} | option)
    Driver(params, device="cpu")


def test_every_input_config_is_ported():
    """Every configuration in ``input/`` (``input/rotation.json`` with
    GMG-LS the last to be ported) makes a driver on the CPU, and its
    simulation is built."""
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.models import make_simulation

    names = sorted(n for n in os.listdir(os.path.join(ROOT, "input"))
                   if n.endswith(".json"))
    assert len(names) == 14 and "rotation.json" in names
    for name in names:
        p = Parameters.from_file(os.path.join(ROOT, "input", name))
        assert Driver(p, device="cpu").params is p, name
        make_simulation(p.simulation_name, p.dim)


def test_bench_gpu_needs_cuda_or_explicit_cpu(monkeypatch, capsys):
    """``bench_gpu.py`` exits non-zero without a card; ``--device cpu``
    rehearses the control flow (two chained applies of the structured
    sweep's plain version) and prints no device metric."""
    sys.path.insert(0, ROOT)
    try:
        import bench_gpu
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_gpu.main([]) == 2
    assert "MDoF/s" not in capsys.readouterr().out
    for argv in (["2", "2", "1", "--device", "cpu"],
                 ["3", "1", "2", "--increment", "--batched", "--device",
                  "cpu"]):
        assert bench_gpu.main(argv) == 0
        out = capsys.readouterr().out
        assert "not measured" in out and "MDoF/s" not in out
    op, space, u = bench_gpu.build(3, 1, 2, True, True, "cpu")
    assert op._fast.batched and op.increment_form
    assert space.n_nodes * 4 == 500 and u.shape == (125, 4)


def test_bench_gpu_rejects_batched_outside_3d(capsys):
    """``--batched`` names the batched 3D kernel: with dim 2 the parser
    refuses it instead of running the 2D kernel under that flag."""
    sys.path.insert(0, ROOT)
    try:
        import bench_gpu
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit) as exc:
        bench_gpu.main(["2", "2", "1", "--batched", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--batched" in capsys.readouterr().err


def test_bench_gpu_sweep_args_are_the_operators_own():
    """``sweep_args`` hands out the operator's own lattice state, scalars
    and flavor: the sweep on them is what ``vmult`` computes."""
    sys.path.insert(0, ROOT)
    try:
        import bench_gpu
    finally:
        sys.path.remove(ROOT)
    from ns_gls_tpu_torch.ops.structured import structured_sweep

    op, _, u = bench_gpu.build(3, 1, 2, True, False, "cpu")
    args = bench_gpu.sweep_args(op, u)
    assert args[5:] == ("increment", True, True)
    assert args[1]["nu"] == 0.1 and args[1]["c1"] == 4.0
    assert args[3] is op.state.u_linT and args[4] is op.state.vec_oldT
    out = structured_sweep(*args)
    assert torch.equal(out.reshape(4, -1).T, op.vmult(u))


def test_structured_cost_counts_the_function():
    """The bound's byte count: u, u_lin (velocity only outside the
    increment flavor), the history where the flavor reads it, the output
    and the tables, each once."""
    sys.path.insert(0, ROOT)
    try:
        import bench_gpu
    finally:
        sys.path.remove(ROOT)
    from ns_gls_tpu_torch.utils.roofline import bound, structured_cost

    op, space, _ = bench_gpu.build(3, 2, 2, False, False, "cpu")
    tab = op._fast.tables
    n = space.n_nodes
    geometry = 64 * (9 + 27 + 2) + 2 * 9
    b_incr, f_incr = structured_cost(tab, "increment", True, True)
    b_fix, f_fix = structured_cost(tab, "fixed", True, True)
    assert b_incr == 4 * ((4 + 4 + 3 + 4) * n + geometry)
    assert b_fix == 4 * ((4 + 3 + 0 + 4) * n + geometry)
    assert f_incr > f_fix > 0
    ms, by = bound(b_incr, f_incr)
    assert by in ("bytes", "operations") and ms > 0


def test_bench_gpu_turek_lane_rehearsal(capsys):
    """``bench_gpu.py --turek [ref] [degree]``: the JAX package's ``bench.py
    --turek`` operator (the extruded Turek 3D mesh, Q2, BDF-2, increment
    flavor, q-wise delta, nu = 0.001) on the prism sweep; ``--device cpu``
    rehearses it and prints no device metric."""
    sys.path.insert(0, ROOT)
    try:
        import bench_gpu
    finally:
        sys.path.remove(ROOT)
    from ns_gls_tpu_torch.ops.prism import PrismSweep

    assert bench_gpu.main(["--turek", "0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "(turek): 400 cells, degree 2, 16704 DoFs, increment" in out
    assert "not measured" in out and "MDoF/s" not in out
    with pytest.raises(SystemExit) as exc:
        bench_gpu.main(["--turek", "--sphere", "--device", "cpu"])
    assert exc.value.code == 2
    capsys.readouterr()
    op, space, u = bench_gpu.build_turek(0, 2, "cpu")
    assert isinstance(op._fast, PrismSweep) and op.increment_form
    assert not op.cell_wise_stabilization and op.nu == 0.001
    args = bench_gpu.sweep_args(op, u)
    assert args[5:] == ("increment", True, False)
    out = op._fast.apply(args[1]["weight"], args[1]["stau"], *args[2:6])
    assert torch.equal(out, op.vmult(u))
