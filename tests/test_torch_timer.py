"""The port's span and counter recorder (``utils/timer.py``) and where the
solver stack uses it.

The recorder: ``parent::child`` labels; each scope a ``record_function``
range ``ns.<label>`` while a profiler records, and never entered
without one; the fence on top-level scopes only; counters, their
snapshots and ``host_sync``.

The driver: one step of ``input/channel.json`` at refinement 0 (2D, Q1,
three GMG levels, the coarse level a dense LU, not iterated) on the CPU:
every counter in the step's record; one ``vcycle`` per preconditioner
application; the fine applies one per Arnoldi step and one per GMRES
cycle; the level applies the V-cycle's and the power iterations'
(V-cycles x smoothed levels x (2 x sweeps + 1) + rebuilds x smoothed
levels x power steps); every rebuild and V-cycle stage a scope of the
step, and a range in the trace of a rebuild and a V-cycle under
``torch.profiler``, nested as its label says (a whole step under the
profiler takes over a minute on the CPU).
"""

import os
from types import SimpleNamespace

import pytest
import torch

from ns_gls_tpu_torch.config import Parameters, _load_json
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.utils import timer as tm
from ns_gls_tpu_torch.utils.device import torch_threads
from ns_gls_tpu_torch.utils.logging import set_verbose


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


set_verbose(False)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "input", "channel.json")
# the program's own counters (the kernels' ``launch.*`` besides)
COUNTERS = ("host_sync", "fine_apply", "level_apply", "vcycle", "rebuild")
# the rebuild's and the V-cycle's stages, by the end of their labels
STAGES = ("setup_preconditioner::level_state",
          "setup_preconditioner::mg_init::diagonal",
          "setup_preconditioner::mg_init::power_iteration",
          "setup_preconditioner::mg_init::coarse_lu",
          "loop::residual", "vcycle", "vcycle::smooth", "vcycle::residual",
          "vcycle::restrict", "vcycle::prolongate", "vcycle::coarse")


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof) -> list:
    return [e for e in prof.events() if e.name.startswith(tm.RANGE_PREFIX)]


def _range_parent(e):
    """The nearest enclosing ``ns.*`` range of the event ``e``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(tm.RANGE_PREFIX):
        p = p.cpu_parent
    return p


# ---------------------------------------------------------------------------
# the recorder


def test_scope_labels_and_nesting():
    tc = tm.TimerCollection()
    for _ in range(2):
        with tc.scope("a"):
            with tc.scope("b"):
                with tc.scope("c::d"):
                    pass
            with tc.scope("b"):
                pass
    assert sorted(tc._data) == ["a", "a::b", "a::b::c::d"]
    assert [tc._data[k][0] for k in sorted(tc._data)] == [2, 4, 2]
    n, total, mn, mx = tc._data["a"]
    assert 0 < mn <= mx and total >= mn + mx - 1e-12
    assert tc._stack() == []
    assert "a::b::c::d" in tc.table()


def test_scope_pops_on_error():
    tc = tm.TimerCollection()
    with pytest.raises(ValueError):
        with tc.scope("a"):
            with tc.scope("b"):
                raise ValueError("x")
    assert tc._stack() == [] and tc._data["a::b"][0] == 1


def test_fence_on_top_level_scopes_only(monkeypatch):
    tc = tm.TimerCollection()
    fences = []
    monkeypatch.setattr(tc, "_fence", lambda: fences.append(
        list(tc._stack())))
    with tc.scope("a"):
        with tc.scope("b"):
            with tc.scope("c"):
                pass
    assert fences == [["a"]]


def test_scopes_are_profiler_ranges():
    tc = tm.TimerCollection()
    with _profile() as prof:
        with tc.scope("a"):
            with tc.scope("b"):
                torch.ones(4).sum()
            with tc.scope("c::d"):
                pass
    names = sorted(e.name for e in _ranges(prof))
    assert names == ["ns.a", "ns.a::b", "ns.a::c::d"]
    for e in _ranges(prof):
        parent = _range_parent(e)
        if e.name == "ns.a":
            assert parent is None
        else:
            assert parent is not None and parent.name == "ns.a"
    # the same scopes with no profiler: timed, no ranges
    with tc.scope("a"):
        pass
    assert tc._data["a"][0] == 2


def test_no_record_function_without_profiler(monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    tc = tm.TimerCollection()
    for _ in range(3):
        with tc.scope("a"):
            with tc.scope("b"):
                pass
    assert entered == [] and tc._data["a::b"][0] == 3
    # the flag is read at each entry: under a profiler the spy is entered
    with _profile():
        with tc.scope("a"):
            pass
    assert entered == ["ns.a"]


def test_counters_and_host_sync():
    tc = tm.TimerCollection()
    tc.count("x")
    tc.count("x", 2)
    tc.count("y", 0)
    snap = tc.counters()
    assert snap == {"x": 3, "y": 0}
    tc.count("y")
    tc.count("z", 5)
    assert snap == {"x": 3, "y": 0}          # a snapshot, not a view
    assert tc.counters_since(snap) == {"x": 0, "y": 1, "z": 5}
    assert "z" in tc.table()
    tc.reset()
    assert tc.counters() == {"x": 0, "y": 0, "z": 0} and not tc._data
    before = tm.counters()
    v = torch.tensor([1.5, 2.5])
    assert tm.host_sync(float, v[1]) == 2.5
    assert tm.host_sync(torch.Tensor.tolist, v) == [1.5, 2.5]
    assert tm.host_sync(torch.tensor, [1.0], dtype=torch.float64).dtype \
        == torch.float64
    assert tm.counters_since(before)["host_sync"] == 3


def test_launch_counters_registered():
    """The five kernel modules register their ``launch.*`` counters at
    import, at zero on the CPU."""
    import ns_gls_tpu_torch.ops.patch2d  # noqa: F401
    import ns_gls_tpu_torch.ops.patch3d  # noqa: F401
    import ns_gls_tpu_torch.ops.prism  # noqa: F401
    from ns_gls_tpu_torch.ops.structured import KERNEL_NAMES

    names = {"patch2d_gls_sweep", "prism_gls_sweep", "patch3d_gls_sweep",
             "seam_sum", *KERNEL_NAMES}
    c = tm.counters()
    assert {k: c["launch." + k] for k in names} == dict.fromkeys(names, 0)


# ---------------------------------------------------------------------------
# one driver step


@pytest.fixture(scope="module")
def step():
    raw = _load_json(CONFIG)
    raw.update({"n global refinements": 0, "paraview prefix": "",
                "output granularity": 0.0, "gmg coarse grid iterate": False})
    drv = Driver(Parameters.from_dict(raw), device="cpu")
    drv.setup()
    drv._setup_done = True
    calls = {"precond": 0, "fine": 0}
    pc, op = drv.preconditioner, drv.op
    vmult_pc, vmult_op = pc.vmult, op.vmult

    def counted_pc(x):
        calls["precond"] += 1
        return vmult_pc(x)

    def counted_op(x):
        calls["fine"] += 1
        return vmult_op(x)

    # GMRES applies them through these
    drv.linear_solver.preconditioner = SimpleNamespace(vmult=counted_pc)
    drv.linear_solver.op = SimpleNamespace(vmult=counted_op)
    scopes = {k: v[0] for k, v in tm.get_collection()._data.items()}
    drv.run(max_steps=1)
    calls["scopes"] = {k: v[0] - scopes.get(k, 0)
                       for k, v in tm.get_collection()._data.items()}
    return drv, calls


def test_step_record_holds_every_counter(step):
    drv, _ = step
    rec = drv.step_stats[-1]["counters"]
    assert set(rec) == set(tm.counters())
    assert set(COUNTERS) <= set(rec)
    assert all(rec[k] == 0 for k in rec if k.startswith("launch."))
    assert rec["rebuild"] == drv.step_stats[-1]["newton"]
    assert rec["host_sync"] > 2 * drv.step_stats[-1]["gmres"]


def test_step_vcycles_are_preconditioner_applications(step):
    drv, calls = step
    assert calls["precond"] > 0
    assert drv.step_stats[-1]["counters"]["vcycle"] == calls["precond"]


def test_step_fine_applies(step):
    """One fine apply an Arnoldi step and one a GMRES cycle; here every
    linear solve takes two cycles, the second only reading the true
    residual that meets the tolerance."""
    drv, calls = step
    st = drv.step_stats[-1]
    assert st["counters"]["fine_apply"] == calls["fine"]
    assert calls["fine"] == st["gmres"] + 2 * st["newton"]


def test_step_level_applies(step):
    drv, _ = step
    pc = drv.preconditioner
    st = drv.step_stats[-1]["counters"]
    smoothed = pc.n_levels - 1
    assert not pc._needs_level0_args and pc.coarse_lu is not None
    assert st["level_apply"] == (
        st["vcycle"] * smoothed * (2 * pc.n_smooth + 1)
        + st["rebuild"] * smoothed * pc.eig_n_iterations)


def test_step_spans(step):
    """Every rebuild and V-cycle stage ran as a scope of the step, as
    often as the counters say."""
    drv, calls = step
    st = drv.step_stats[-1]["counters"]
    smoothed = drv.preconditioner.n_levels - 1
    ran = {k: n for k, n in calls["scopes"].items() if n}
    for stage in STAGES:
        assert any(k == stage or k.endswith("::" + stage) for k in ran), \
            stage
    prefix = "loop::setup_preconditioner::mg_init::"
    assert ran["loop::solve_with_jacobian::vcycle"] == st["vcycle"]
    assert ran["loop::solve_with_jacobian::vcycle::coarse"] == st["vcycle"]
    assert ran["loop::solve_with_jacobian::vcycle::smooth"] \
        == 2 * smoothed * st["vcycle"]
    assert ran[prefix + "diagonal"] == ran[prefix + "power_iteration"] \
        == smoothed * st["rebuild"]
    assert ran[prefix + "coarse_lu"] == st["rebuild"]


def test_rebuild_and_vcycle_ranges_in_trace(step, monkeypatch):
    """A rebuild and a V-cycle of the step's preconditioner under a CPU
    ``torch.profiler``: each stage a range, inside its parent's.  Cut to
    keep the trace small (reading ~10^5 events takes ten seconds on the
    CPU): the levels' diagonals are ones, one power step and one
    smoothing sweep; the step's preconditioner is left so."""
    from ns_gls_tpu_torch.ops import assembly

    drv, _ = step
    pc = drv.preconditioner
    monkeypatch.setattr(assembly, "compute_inverse_diagonal", lambda op: (
        torch.ones((op.n_nodes, op.n_comp), dtype=op.dtype)))
    monkeypatch.setattr(pc, "eig_n_iterations", 1)
    monkeypatch.setattr(pc, "n_smooth", 1)
    src = torch.ones((drv.space.n_nodes, drv.params.dim + 1),
                     dtype=drv.params.dtype)
    with _profile() as prof:
        with tm.timer("probe"):
            pc.initialize()
            pc.vmult(src)
    ranges = _ranges(prof)
    names = {e.name for e in ranges}
    for stage in ("mg_init::diagonal", "mg_init::power_iteration",
                  "mg_init::coarse_lu", "vcycle", "vcycle::smooth",
                  "vcycle::residual", "vcycle::restrict",
                  "vcycle::prolongate", "vcycle::coarse"):
        assert "ns.probe::" + stage in names, stage
    for e in ranges:
        parent = _range_parent(e)
        if e.name == "ns.probe":
            assert parent is None
        else:
            assert e.name.startswith(parent.name + "::"), (e.name,
                                                           parent.name)
