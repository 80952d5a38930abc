"""The port's driver with ``"n devices": 4`` on four CPU shards against
its single-device run, on the configurations of the JAX package's
``tests/test_driver_sharded.py``: the solution after 2 steps within
atol 1e-8 (the bound of its ``test_sharded_driver_matches_single_device``)
and the same Newton and GMRES counts.

- The channel (Q1, refinement 1): the halo operator on Morton chunks and
  the distributed V-cycle.
- The Turek cylinder with the reference's f64 outer solve and f32 levels:
  the f64 fine operator on its finest level's patch-2D partition, each
  f32 level's shards on the plain patch-2D sweep.
- GMG-LS under sharding: the global-coarsening cycle with a warning, or a
  raise when ``gmg ls parallel fallback`` is false.

- The replicated strategy (its level applies cell-sharded too), and ILU
  under sharding, on the cylinder with the f64 outer solve.
"""

import functools
import json

import numpy as np
import pytest
import torch

from ns_gls_tpu_torch.config import Parameters
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.parallel.halo import HaloShardedOperator
from ns_gls_tpu_torch.parallel.sharding import ShardedOperator
from ns_gls_tpu_torch.utils import logging as tlog
from ns_gls_tpu_torch.utils.device import torch_threads

tlog.set_verbose(False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


# ``tests/test_driver_sharded.py`` CFG
CFG = {
    "dim": 2, "fe degree": 1, "n global refinements": 1,
    "simulation name": "channel", "cfl": 0.1, "t final": 0.1,
    "bdf order": 1, "time intration": "bdf", "nu": 0.01,
    "consider time derivative": True, "lin relative tolerance": 1e-8,
    "preconditioner": "GMG", "gmg coarse grid solver": "direct",
    "nonlinear solver": "Newton", "output granularity": 0.0,
}
# its ``test_halo_driver_f64_outer``
CYLINDER = CFG | {
    "simulation name": "cylinder", "nu": 0.001, "simulation u max": 0.3,
    "precision": "f64", "mg precision": "f32",
    "lin relative tolerance": 1e-10, "nonlinear tolerance": 1e-10,
}


@functools.lru_cache(maxsize=None)
def run(cfg_json: str, steps: int = 2):
    """A driver of the configuration run for ``steps`` steps on the CPU:
    (driver, solution, per-step (Newton, GMRES) counts)."""
    d = Driver(Parameters.from_dict(json.loads(cfg_json)), device="cpu")
    d.run(max_steps=steps)
    counts = [(s["newton"], s["gmres"]) for s in d.step_stats]
    return d, d.solution.current.numpy().copy(), counts


def check_against_single(cfg, sharded=(), atol=1e-8):
    """The 4-shard run of ``cfg`` (with the keys ``sharded`` on top)
    against the single-device run of ``cfg``."""
    d1, a, c1 = run(json.dumps(cfg))
    d4, b, c4 = run(json.dumps(cfg | {"n devices": 4} | dict(sharded)))
    assert b.dtype == a.dtype
    assert c4 == c1
    assert np.abs(a - b).max() <= atol, np.abs(a - b).max()
    return d4


def test_channel_matches_single_device():
    d4 = check_against_single(CFG)
    assert isinstance(d4.op, HaloShardedOperator)
    assert d4.preconditioner.distributed
    assert d4.op.local_sweep == "general"


def test_cylinder_f64_outer_matches_single_device():
    d4 = check_against_single(CYLINDER)
    assert d4.op.dtype == torch.float64
    assert d4.op.partition.kind == "patch2d"
    assert d4.op.local_sweep == "general"
    assert {op.local_sweep for op in d4.mg_ops_apply[1:]} == {"patch2d"}


def test_gmg_ls_fallback():
    """GMG-LS under sharding takes the global-coarsening cycle, with a
    warning; without the fallback it raises."""
    ls = CFG | {"preconditioner": "GMG-LS", "n devices": 2}
    d = Driver(Parameters.from_dict(ls), device="cpu")
    with pytest.warns(UserWarning, match="falls back"):
        d.setup()
    assert d.preconditioner.distributed
    d = Driver(Parameters.from_dict(ls | {"gmg ls parallel fallback":
                                          False}), device="cpu")
    with pytest.raises(ValueError, match="parallel fallback"):
        d.setup()


@pytest.mark.parametrize("cfg_over,sharded", [
    ({}, {"parallel strategy": "replicated"}),
    ({"preconditioner": "ILU"}, {}),
], ids=["replicated", "ilu"])
def test_driver_matches_single_device(cfg_over, sharded):
    """The replicated strategy (its level applies cell-sharded too), and
    ILU under sharding (on the unsharded operator, converting at the
    distributed GMRES's boundary), after 2 steps of the Turek cylinder
    with the f64 outer solve, against the single-device run."""
    d4 = check_against_single(CYLINDER | cfg_over, sharded)
    if sharded:
        assert isinstance(d4.op, ShardedOperator)
        assert all(isinstance(op, ShardedOperator) for op in d4.mg_ops_apply)
    else:
        assert d4.preconditioner.op is d4.op_unsharded
