"""The V-cycle replayed from CUDA graphs (``precond/gmg.py``), on the CPU.

The constraint writes fill on the device: ``set_zero`` and
``condense_transpose`` give the bits of the former index assignment of a
Python zero, in float32 and float64, on Dirichlet, hanging-node and slip
rows, and count no host sync.

The replay's bookkeeping, with the CUDA graph replaced by a stub that
runs the captured function again at each replay and writes its result
into the captured outputs (as a replay writes the graph's buffers), on
the GMG of ``input/channel.json`` at refinement 0 (2D, Q1, three levels)
after a step:
the first cycle runs eager; then a capture, whose counters are taken
back, and a replay a cycle that adds them again, so every counter reads
as in the eager cycle and the result is the eager cycle's to the bit, in
both forms (the whole cycle around a dense LU; the legs down and up
around an iterated coarse solve); a new capture when a level's state, a
diagonal, a relaxation factor, a number passed by value or the source's
shape changes, or after a rebuild; none otherwise.  An operator's
capture key follows each number it passes by value, and not an apply.
Which form each coarse solver gets, and that the CPU, sharded levels and
distributed cycles stay eager.
"""

import os

import numpy as np
import pytest
import torch

from ns_gls_tpu_torch.config import Parameters, _load_json
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.fem import constraints as cstr
from ns_gls_tpu_torch.precond import gmg
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
# counted by the cycle's caller or its graph bookkeeping, not by the cycle
OWN = ("vcycle", "vcycle_graph_capture", "vcycle_graph_replay")
# the numbers an operator passes its fused kernels by value
BY_VALUE = ("weight_host", "stau_host", "nu", "c_1", "c_2")


# ---------------------------------------------------------------------------
# the constraint writes


def _constraints(kind: str, dtype) -> cstr.ConstraintArrays:
    """Constraints on 40 nodes of 3 components: Dirichlet rows alone, or
    with hanging nodes (rows on two masters) or slip rows (a component on
    the node's others)."""
    rng = np.random.default_rng(5)
    ac = cstr.AffineConstraints(40, 3)
    ac.add_dirichlet(np.arange(0, 40, 7), [0, 1])
    if kind == "hanging":
        for node in (3, 11, 26):
            ac.add_hanging_node(node, None, [node + 1, node + 2], [0.5, 0.5])
    if kind == "slip":
        normals = rng.standard_normal((4, 2))
        ac.add_no_normal_flux(np.array([5, 9, 17, 30]),
                              np.concatenate([normals, np.zeros((4, 1))], 1))
    return ac.close(dtype)


def _set_zero_before(ca, u):
    out = u.reshape(-1).clone()
    out[ca.rows] = 0.0
    return out.reshape(u.shape)


def _condense_transpose_before(ca, r):
    rf = r.reshape(-1).clone()
    vals = rf[ca.rows]
    src = (ca.weights * vals[:, None]).reshape(-1).to(rf.dtype)
    rf.index_add_(0, ca.cols.reshape(-1), src)
    rf[ca.rows] = 0.0
    return rf.reshape(r.shape)


@pytest.mark.parametrize("kind", ["dirichlet", "hanging", "slip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_constraint_fill_matches_index_assignment(kind, dtype):
    ca = _constraints(kind, dtype)
    assert ca.n > 0
    if kind != "dirichlet":
        assert bool((ca.weights != 0).any())
    gen = torch.Generator().manual_seed(3)
    u = torch.randn((40, 3), generator=gen, dtype=dtype)
    # a negative zero where a row is written: the fill writes +0
    u.view(-1)[ca.rows[0]] = -0.0
    before = tm.counters()
    got_z = cstr.set_zero(ca, u)
    got_t = cstr.condense_transpose(ca, u)
    assert tm.counters_since(before).get("host_sync", 0) == 0
    plus_zero = torch.zeros(1, dtype=dtype).view(torch.uint8)
    for got, want in ((got_z, _set_zero_before(ca, u)),
                      (got_t, _condense_transpose_before(ca, u))):
        assert got.dtype == dtype and got.shape == u.shape
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8))
        assert torch.equal(got.reshape(-1)[ca.rows[:1]].view(torch.uint8),
                           plus_zero)


# ---------------------------------------------------------------------------
# the replay's bookkeeping


class StubGraph:
    """Stands in for a captured CUDA graph: a replay runs the captured
    function again, with the counters left as they were (a replay runs
    no host code), and writes its result into the captured outputs."""

    def __init__(self, fn, out, log):
        self.fn, self.out, self.log = fn, out, log

    def pool(self):
        return ("pool", id(self))

    def replay(self):
        self.log.append("replay")
        counts = tm.get_collection()._counts
        kept = dict(counts)
        new = self.fn()
        counts.clear()
        counts.update(kept)
        _copy_into(self.out, new)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


@pytest.fixture
def stub(monkeypatch):
    log = []

    def capture_graph(fn, device, pool=None):
        log.append(("capture", pool))
        out = fn()
        return StubGraph(fn, out, log), out

    monkeypatch.setattr(gmg, "capture_graph", capture_graph)
    return log


def _preconditioner(iterate: bool):
    raw = _load_json(CONFIG)
    raw.update({"n global refinements": 0, "paraview prefix": "",
                "output granularity": 0.0,
                "gmg coarse grid iterate": iterate})
    drv = Driver(Parameters.from_dict(raw), device="cpu")
    drv.setup()
    drv._setup_done = True
    # a step: the levels' linearization points, weights and smoothers
    drv.run(max_steps=1)
    return drv, drv.preconditioner


@pytest.fixture(scope="module")
def whole():
    return _preconditioner(False)


@pytest.fixture(scope="module")
def legs():
    return _preconditioner(True)


def _source(drv, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((drv.space.n_nodes, drv.params.dim + 1),
                       generator=gen, dtype=drv.params.dtype)


def _counted(fn, *args):
    before = tm.counters()
    out = fn(*args)
    return out, {k: v for k, v in tm.counters_since(before).items() if v}


def _without_own(delta):
    return {k: v for k, v in delta.items() if k not in OWN}


@pytest.mark.parametrize("form", ["whole", "legs"])
def test_replay_equals_eager_cycle_and_counts(form, whole, legs, stub,
                                              monkeypatch):
    drv, pc = whole if form == "whole" else legs
    monkeypatch.setattr(pc, "_form", form)
    monkeypatch.setattr(pc, "_warm", False)
    monkeypatch.setattr(pc, "_captured", None)
    monkeypatch.setattr(pc, "_pool_owner", None)
    src = _source(drv, 1)
    # the first cycle is eager
    _, first = _counted(pc.vmult, src)
    assert stub == [] and pc._captured is None and pc._warm
    assert first["vcycle"] == 1 and "vcycle_graph_replay" not in first
    n_graphs = 1 if form == "whole" else 2
    for k, seed in enumerate((2, 3, 4)):
        src = _source(drv, seed)
        want, eager = _counted(pc._eager_cycle, src)
        got, counted = _counted(pc.vmult, src)
        assert torch.equal(got, want)
        assert got.dtype == src.dtype and got.shape == src.shape
        # the caller's buffer is not the graph's output
        assert got.data_ptr() != pc._captured.out.data_ptr()
        assert _without_own(counted) == eager
        assert counted["vcycle"] == counted["vcycle_graph_replay"] == 1
        assert counted.get("vcycle_graph_capture", 0) == (k == 0)
        assert eager["level_apply"] > 0
    captures = [e for e in stub if e != "replay"]
    assert len(captures) == n_graphs
    # every graph of a cycle in one pool, the first one's
    assert captures[0][1] is None
    assert all(p == ("pool", id(pc._captured.graphs[0]))
               for _, p in captures[1:])
    assert stub.count("replay") == 3 * n_graphs
    # the counters a replay adds: the eager cycle's, a graph's each
    total = {}
    for d in pc._captured.deltas:
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    if form == "whole":
        assert total == _without_own(eager)
    else:
        # the coarse solve runs eager between the legs, counted there
        assert "coarse_gmres_it" not in total
        assert total["level_apply"] < eager["level_apply"]


def test_recapture_on_what_the_capture_baked_in(whole, stub, monkeypatch):
    drv, pc = whole
    monkeypatch.setattr(pc, "_form", "whole")
    monkeypatch.setattr(pc, "_warm", True)
    monkeypatch.setattr(pc, "_captured", None)
    monkeypatch.setattr(pc, "_pool_owner", None)
    src = _source(drv, 7)

    def captures():
        return sum(e != "replay" for e in stub)

    def check(n_captures):
        want = pc._eager_cycle(src)
        _, counted = _counted(pc.vmult, src)
        assert captures() == n_captures
        assert counted.get("vcycle_graph_capture", 0) == (
            n_captures > check.last)
        check.last = n_captures
        assert torch.equal(pc.vmult(src), want)
        assert captures() == n_captures

    check.last = 0
    check(1)
    check(1)
    op = pc.level_ops[1]
    # a level's new state (a linearization point, a history, a weight)
    monkeypatch.setattr(op, "state", op.state._replace())
    check(2)
    # each number passed by value to the fused kernels
    n = 2
    for name in BY_VALUE:
        monkeypatch.setattr(op, name, getattr(op, name) + 1.0)
        check(n + 1)
        monkeypatch.setattr(op, name, getattr(op, name) - 1.0)
        check(n + 2)
        n += 2
    # the smoother's diagonals and relaxation factors
    monkeypatch.setattr(pc, "inv_diags", [None if d is None else d.clone()
                                          for d in pc.inv_diags])
    check(n + 1)
    monkeypatch.setattr(pc, "omegas", [None if w is None else w.clone()
                                       for w in pc.omegas])
    check(n + 2)
    # the source's shape
    flat = src.reshape(-1)
    before = captures()
    pc.vmult(flat)
    assert captures() == before + 1
    pc.vmult(src)
    assert captures() == before + 2
    # a rebuild
    pc.initialize()
    assert pc._captured is None
    pool_owner = pc._pool_owner
    pc.vmult(src)
    assert captures() == before + 3
    # the new capture reused the pool of the graph captured before
    assert stub[-2] == ("capture", ("pool", id(pool_owner)))


@pytest.mark.parametrize("name", BY_VALUE)
def test_operator_capture_key(name, whole, monkeypatch):
    """An operator's capture key changes with each number it passes its
    fused kernels by value, and not with an apply."""
    drv, pc = whole
    op = pc.level_ops[-1]
    (state,), numbers = op.capture_key()
    op.vmult(_source(drv, 9).to(op.dtype))
    (again,), same = op.capture_key()
    assert again is state and same == numbers
    monkeypatch.setattr(op, name, getattr(op, name) + 0.5)
    (again,), changed = op.capture_key()
    assert again is state and changed != numbers
    assert [a == b for a, b in zip(changed, numbers)] == [
        k != name for k in BY_VALUE]


def test_graph_forms(whole, legs):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    _, pc = whole
    assert pc._form is None
    assert gmg.graph_form(cuda, False, pc.coarse_grid_solver,
                          pc.coarse_grid_iterate, pc.n_levels) == "whole"

    def form(solver, iterate, n_levels=3, sharded=False, device=cuda):
        return gmg.graph_form(device, sharded, solver, iterate, n_levels)

    assert form("direct", False) == form("AMG", False) == "whole"
    assert form("identity", False) == form("identity", True) == "whole"
    assert form("direct", True) == form("AMG", True) == "legs"
    assert form("ILU", False) == form("ILU", True) == "legs"
    assert form("AMG", True, n_levels=1) is None
    assert form("direct", False, n_levels=1) == "whole"
    # sharded levels, and the distributed cycle on them
    assert form("direct", False, sharded=True) is None
    assert form("direct", False, device=cpu) is None
    _, pc = legs
    assert pc._form is None
    assert gmg.graph_form(cuda, False, pc.coarse_grid_solver,
                          pc.coarse_grid_iterate, pc.n_levels) == "legs"
