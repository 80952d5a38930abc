"""The port's matrix-based operator (``use matrix free ns operator:
false``) against the JAX package's, in f64 on the CPU.

- The assembled padded-ELL matrix equals the JAX package's entry by entry:
  the same columns in every slot, the values within 1e-12 of their
  max-abs (both sum the same element matrices, in other orders).
- Its apply (the constraint sandwich around the SpMV) equals the port's
  matrix-free fixed-point vmult to 1e-10 relative.
- Driver steps of the linearized solve on ``input/channel.json`` at
  refinement 1 (f64 GMG levels, the JAX power-iteration start vectors):
  iterations equal to the stored JAX run's, the solution within 1e-10 of
  its max-abs (measured 2.5e-14); Newton is refused, as in JAX.
"""

import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.ops.matrix_based import NavierStokesOperatorMatrixBased as JMB
from ns_gls_tpu_torch.config import Parameters
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.ops.matrix_based import (
    NavierStokesOperatorMatrixBased as TMB,
)
from ns_gls_tpu_torch.utils.device import torch_threads
from ns_gls_tpu_torch.utils.logging import set_verbose
from test_torch_ilu_amg import _close, _ops, check_run, port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIES = os.path.join(ROOT, "validation", "solver_stack_series.json.gz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    set_verbose(False)
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def series():
    with gzip.open(SERIES, "rt") as f:
        return json.load(f)["runs"]


@pytest.fixture(scope="module")
def ops():
    return _ops(increment=False)


def test_assembled_matrix_equals_jax_ell(ops):
    opj, opt, _ = ops
    ej = JMB(opj).ell
    et = TMB(opt).ell
    np.testing.assert_array_equal(et.cols.numpy(), np.asarray(ej.cols))
    _close(et.vals.numpy(), ej.vals, tol=1e-12)


def test_vmult_equals_matrix_free(ops):
    _, opt, rng = ops
    mb = TMB(opt)
    v = torch.as_tensor(rng.standard_normal((opt.n_nodes, 3)))
    _close(mb.vmult(v).numpy(), opt.vmult(v).numpy(), tol=1e-10)
    # a new linearization point drops the assembled matrix
    mb.set_linearization_point(torch.as_tensor(
        rng.standard_normal((opt.n_nodes, 3))))
    assert mb._ell is None
    _close(mb.vmult(v).numpy(), opt.vmult(v).numpy(), tol=1e-10)


def test_driver_matches_jax(series):
    drv = port_run(series["matrix_based"])
    assert isinstance(drv.op, TMB)
    check_run(drv, series["matrix_based"])


def test_newton_is_refused(series):
    cfg = dict(series["matrix_based"]["config"],
               **{"nonlinear solver": "Newton"})
    drv = Driver(Parameters.from_dict(cfg), device="cpu")
    with pytest.raises(ValueError, match="does not support Newton"):
        drv.setup()
