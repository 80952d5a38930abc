"""The global-coarsening GMG on adaptively refined 2D meshes, end to end
on the CPU: its f32 levels hold several patch families (``ops/patch2d.py``
``Patch2DFamilies``).  The port's driver against the JAX package's runs
stored by ``tools/rotation_series.py``, the port's power iterations
started from the JAX package's vectors:

- ``input/rotation.json`` at refinement 2 under ``GMG`` (the JAX
  package's ``tests/test_rotation.py``), three steps: Newton equal, GMRES
  within ``GMG_GMRES_REL`` (``tests/test_torch_gmg_ls.py`` says why),
  the solutions within 10x the gap measured on a CPU (1.65e-6 of the JAX
  max-abs);
- the adaptive cylinder (the JAX package's ``tests/test_gmg_ls.py``
  ``_adaptive_channel_driver``; families m = 1, 2, 4), one step: Newton
  equal, GMRES within 1 (measured: 2 and 51 on both sides), the
  solutions within 10x the measured gap (2.3e-10).
"""

import pytest

from tests.test_torch_gmg_ls import GMG_GMRES_REL, check_parity, port_run
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


def test_rotation_gmg_matches_jax():
    td = port_run("rotation_gmg", 31)
    assert [t.m for t in td.mg_ops[-1]._fast.tables.fams] == [1, 2]
    check_parity(td, "rotation_gmg", 1.65e-5, GMG_GMRES_REL)


def test_adaptive_cylinder_gmg_matches_jax():
    td = port_run("cylinder_gmg", 31)
    assert td.mesh.is_adaptive
    assert [t.m for t in td.mg_ops[-1]._fast.tables.fams] == [1, 2, 4]
    check_parity(td, "cylinder_gmg", 2.3e-9)
