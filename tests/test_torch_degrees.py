"""The fused sweeps at the degrees their CUDA kernels gained last (P = 5
and 6): the plain versions the kernels are held to on the card, against
the JAX package's Pallas kernels run as its own tests run them on the CPU
(interpret mode), in f32.

- Patch-2D on the curved Turek 2D mesh (88 patches of one cell): every
  flavor (the increment vmult and the residual, or the fixed-point
  vmult), both delta modes, with the BDF history; within 1e-5 of the
  reference's max-abs, as the other patch-2D degrees (measured at most
  6.6e-6).
- The 2D structured kernel on a lattice of one cell: one case a degree;
  within 1e-5 of the reference's max-abs.  The JAX structured kernel
  contracts with the TPU's split-precision matrix products, whose error
  grows with the degree (measured 4.4e-6 at P = 6 on this lattice, 7.1e-6
  on the 3 x 2 lattice of ``tests/test_torch_structured.py``, where P = 1,
  2 hold to 5e-6).

The Pallas kernels' interpret mode compiles for tens of seconds at these
degrees, so the structured cases are one per degree, on one cell.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu_torch.utils.device import torch_threads
from test_torch_patch2d import _close as close_p2
from test_torch_patch2d import _setup as setup_p2
from test_torch_structured import _setup as setup_s

TOL_STRUCTURED = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


@pytest.mark.parametrize("cell_wise", [True, False])
@pytest.mark.parametrize("increment", [True, False])
@pytest.mark.parametrize("degree", [5, 6])
def test_plain_patch2d_vs_pallas_high_degrees(degree, increment, cell_wise):
    opj, opt, opg, u, v = setup_p2(0, increment, cell_wise, True, degree)
    assert [t.P for t in opt._fast.tables.fams] == [degree]
    close_p2(opt.vmult(torch.as_tensor(v)).numpy(),
             opj.vmult(jnp.asarray(v)))
    close_p2(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
             opj.evaluate_residual(jnp.asarray(u)))


def _close_s(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= TOL_STRUCTURED, err


@pytest.mark.parametrize("degree,increment,cell_wise", [
    (5, True, True), (6, False, False)])
def test_plain_structured_2d_vs_pallas_high_degrees(degree, increment,
                                                    cell_wise):
    opj, opt, u, v = setup_s(2, degree, increment, cell_wise, True, True,
                             cells=(1, 1))
    assert opt._fast.tables.P == degree
    _close_s(opt.vmult(torch.as_tensor(v)).numpy(),
             opj.vmult(jnp.asarray(v)))
    _close_s(opt.evaluate_residual(torch.as_tensor(u)).numpy(),
             opj.evaluate_residual(jnp.asarray(u)))
