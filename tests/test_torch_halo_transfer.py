"""The distributed multigrid transfers (``parallel/halo.py``
``HaloTransferOps``) and the distributed V-cycle (``precond/gmg.py``) on
4 CPU shards, against the port's global transfers and its single-device
V-cycle, on the levels the driver builds: the Turek 2D chain (Q2, f32
levels on the patch-2D partition, the fine operator in f64 on the same
partition) and the structured 2D channel chain (Q1, Morton chunks).

- Prolongation equals the global one exactly (the same products in the
  same order), restriction (its transpose, summed across shards) within
  1e-6 relative.
- The fine operator's layout is its finest level's.
- One distributed V-cycle equals the single-device V-cycle within 1e-5
  relative (f32 levels): both power iterations start from one vector per
  level, the distributed one in its (n_dev, n_own_max, C) layout.
"""

import functools

import numpy as np
import pytest
import torch

from ns_gls_tpu_torch.config import Parameters
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.fem import transfer as tr
from ns_gls_tpu_torch.fem.constraints import distribute
from ns_gls_tpu_torch.precond.gmg import power_start_vector
from ns_gls_tpu_torch.utils import logging as tlog
from ns_gls_tpu_torch.utils.device import torch_threads

tlog.set_verbose(False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


CASES = {
    "turek2d": {"simulation name": "cylinder", "dim": 2, "fe degree": 2,
                "n global refinements": 1, "nu": 0.001,
                "simulation u max": 0.3},
    "channel": {"simulation name": "channel", "dim": 2, "fe degree": 1,
                "n global refinements": 2, "nu": 0.01},
}
BASE = {"preconditioner": "GMG", "gmg coarse grid solver": "direct",
        "nonlinear solver": "Newton", "output granularity": 0.0,
        "bdf order": 2, "time intration": "bdf"}


@functools.lru_cache(maxsize=None)
def _drivers(case):
    """Single-device and 4-shard drivers of the case, set up at one
    linearization point with the same power-iteration start vectors."""
    out = []
    for n in (1, 4):
        d = Driver(Parameters.from_dict(BASE | CASES[case]
                                        | {"n devices": n}), device="cpu")
        d.setup()
        out.append(d)
    d1, d4 = out

    def start(level, shape, dtype, device):
        """The single-device start vector in the level's distributed
        layout (pads zero)."""
        op = d1.mg_ops[level]
        g = power_start_vector(level, (op.n_nodes, op.n_comp), dtype, device)
        return torch.stack(d4.mg_ops_apply[level].to_dist(g).parts)

    d4.preconditioner.power_start = start
    rng = np.random.default_rng(3)
    u = rng.standard_normal((d1.space.n_nodes, d1.op.n_comp))
    for d in (d1, d4):
        d.time_integrator.update_dt(0.01)
        for op_l in d.mg_ops:
            op_l.update_weight()
        d.op.update_weight()
        d.solution.commit()
        d._set_previous_solution()
        ut = distribute(d.op.constraints_inhomogeneous,
                        torch.as_tensor(u, dtype=d.op.dtype))
        d._setup_jacobian(ut)
        d._setup_preconditioner(ut)
    return d1, d4


def _rel(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("case", list(CASES))
def test_transfers_equal_global(case):
    _, d4 = _drivers(case)
    assert d4.preconditioner.distributed
    kinds = {op.local_sweep for op in d4.mg_ops_apply[1:]}
    assert kinds == ({"patch2d"} if case == "turek2d" else {"general"})
    rng = np.random.default_rng(5)
    for l, t in enumerate(d4.preconditioner.transfer_ops):
        coarse, fine = d4.mg_ops_apply[l], d4.mg_ops_apply[l + 1]
        g = d4.mg_transfers[l]
        xc = torch.as_tensor(rng.standard_normal((coarse.n_nodes, 3)),
                             dtype=torch.float32)
        xf = torch.as_tensor(rng.standard_normal((fine.n_nodes, 3)),
                             dtype=torch.float32)
        assert torch.equal(fine.to_global(t.prolongate(coarse.to_dist(xc))),
                           tr.prolongate(g, xc))
        assert _rel(coarse.to_global(t.restrict(fine.to_dist(xf))),
                    tr.restrict(g, xf)) <= 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_vcycle_equals_single_device(case):
    d1, d4 = _drivers(case)
    assert np.array_equal(d4.op.own_global, d4.mg_ops_apply[-1].own_global)
    assert d4.op.partition is d4.mg_ops_apply[-1].partition
    for a, b in zip(d1.preconditioner.omegas, d4.preconditioner.omegas):
        if a is not None:
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(a))
    b = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (d1.space.n_nodes, 3)), dtype=torch.float64)
    x1 = d1.preconditioner.vmult(b)
    x4 = d4.op.to_global(d4.preconditioner.vmult(d4.op.to_dist(b)))
    assert _rel(x4, x1) <= 1e-5
