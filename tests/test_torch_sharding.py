"""The port's cell-sharded "replicated" strategy
(``ns_gls_tpu_torch/parallel/sharding.py``) against the JAX package's
``ShardedOperator`` on 4 shards, and the device mesh the driver builds.

- vmult, residual and rhs equal JAX's on the same numpy inputs at Q1 and
  Q2, f32 and f64, with the Hoffmann 2D Nitsche faces: 1e-12 relative in
  f64, 2e-5 in f32 (every shard on the general sweep, as in JAX); the
  cells are chunked as JAX shards its batch axis.
- ``make_device_mesh`` takes repeated devices and names the card of a
  bare ``"cuda"``; the driver shards over n CPU shards on the CPU, takes
  an explicit device list, and raises ``ValueError`` when fewer cards
  exist than ``n devices`` asks for (as ``ns_gls_tpu/driver.py:279-283``).

The replicated strategy's driver runs are in
``test_torch_driver_sharded.py``.
"""

import numpy as np
import pytest
import torch

from ns_gls_tpu_torch.config import Parameters
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.parallel.sharding import (
    ShardedOperator,
    make_device_mesh,
)
from ns_gls_tpu_torch.utils.device import torch_threads
from tests.test_torch_halo import (
    CPU4,
    F32,
    F64,
    TOL,
    check_applies,
    jax_mesh,
    make_pair,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


@pytest.mark.parametrize("case,dtype,increment", [
    ("turek2d_q1", F64, True), ("turek2d_q2", F32, False),
    ("turek2d_q2", F64, True), ("nitsche", F64, False),
    ("nitsche", F32, True), ("hanging_q1", F32, True)])
def test_sharded_applies_equal_jax(case, dtype, increment):
    from ns_gls_tpu.parallel.sharding import ShardedOperator as JSharded

    opj, opt, u, v = make_pair(case, dtype, increment,
                               cell_wise=not increment)
    ts = ShardedOperator(opt, CPU4)
    n_c = opt.space.mesh.n_cells
    chunk = -(-n_c // len(CPU4))
    assert np.array_equal(np.concatenate(ts.cells_of), np.arange(n_c))
    assert all(len(c) <= chunk for c in ts.cells_of)
    check_applies(JSharded(opj, jax_mesh()), ts, u, v, dtype, TOL[dtype])


def test_device_mesh():
    assert make_device_mesh(["cpu"] * 3) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_device_mesh([])


CHANNEL = {"simulation name": "channel", "n global refinements": 0,
           "preconditioner": "GMG", "gmg coarse grid solver": "direct",
           "nonlinear solver": "Newton"}


def test_driver_devices(monkeypatch):
    """n CPU shards by default on the CPU, an explicit list as given, and
    ``ValueError`` for too few cards or a list of another length."""
    d = Driver(Parameters.from_dict(CHANNEL | {"n devices": 3}),
               device="cpu")
    assert d.devices == (torch.device("cpu"),) * 3
    d = Driver(Parameters.from_dict(CHANNEL | {"n devices": 2}),
               devices=["cpu", "cpu"])
    assert d.device == torch.device("cpu")
    assert Driver(Parameters.from_dict(CHANNEL), device="cpu").devices \
        is None
    with pytest.raises(ValueError, match="3 devices given"):
        Driver(Parameters.from_dict(CHANNEL | {"n devices": 2}),
               devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="parallel strategy"):
        Driver(Parameters.from_dict(CHANNEL | {"n devices": 2,
                                               "parallel strategy": "x"}),
               device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        Driver(Parameters.from_dict(CHANNEL | {"n devices": 2}))
