"""The port's refinement forest (``mesh/forest.py``) and rotation model
(``models/rotation.py``) against the JAX package's, exactly: the forest
levels' cells, boundary ids, refinement levels, parents, child indices
and active maps, on ``input/rotation.json``'s mesh at refinements 2 and 3
and on the adaptive cylinder of the JAX package's
``tests/test_gmg_ls.py``; the rotation mesh, its boundary conditions and
its hanging-node constraints on the curved interface; the level spaces'
patch families (one family of single-cell patches on every level)."""

import numpy as np
import pytest
import torch

from ns_gls_tpu.driver import ConstraintSetBuilder as JCsets
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh.forest import forest_levels as jforest
from ns_gls_tpu.models.cylinder import SimulationCylinder as JCyl
from ns_gls_tpu.models.rotation import SimulationRotation as JRot
from ns_gls_tpu_torch.driver import ConstraintSetBuilder as TCsets
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh.forest import forest_levels as tforest
from ns_gls_tpu_torch.models import make_simulation
from ns_gls_tpu_torch.models.cylinder import SimulationCylinder as TCyl
from ns_gls_tpu_torch.models.rotation import SimulationRotation as TRot
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


CYL_EXTRA = {"simulation u max": 0.3,
             "simulation geometry extra length": 0.8}


def _meshes(case, ref):
    if case == "rotation":
        return TRot(2).create_mesh(ref), JRot(2).create_mesh(ref)
    st, sj = TCyl(2), JCyl(2)
    st.parse_parameters(CYL_EXTRA)
    sj.parse_parameters(CYL_EXTRA)
    return st.create_mesh(ref), sj.create_mesh(ref)


@pytest.mark.parametrize("case,ref", [("rotation", 2), ("rotation", 3),
                                      ("cylinder", 2)])
def test_forest_levels_equal_jax(case, ref):
    mt, mj = _meshes(case, ref)
    assert mt.is_adaptive and mj.is_adaptive
    lt, lj = tforest(mt), jforest(mj)
    assert len(lt) == len(lj) >= 3
    for a, b in zip(lt, lj):
        assert np.array_equal(a.mesh.cells, b.mesh.cells)
        assert np.array_equal(a.mesh.boundary_ids, b.mesh.boundary_ids)
        assert np.array_equal(a.mesh.cell_level, b.mesh.cell_level)
        assert np.array_equal(a.mesh.vertices, b.mesh.vertices)
        assert np.array_equal(a.parent, b.parent)
        assert np.array_equal(a.child, b.child)
        assert np.array_equal(a.active, b.active)
    # the active cells of all levels are the final mesh, once each
    act = np.concatenate([L.active[L.active >= 0] for L in lt])
    assert np.array_equal(np.sort(act), np.arange(mt.n_cells))
    # levels above the globally refined ones cover part of the domain
    assert lt[-1].mesh.n_cells < 4 ** (len(lt) - 1) * lt[0].mesh.n_cells


def test_rotation_forest_level_families():
    """Refinement 3 as given: five forest levels of 4, 16, 64, 256 and 256
    cells, the last the boundary strip; every level space is one family
    of single-cell patches."""
    levels = tforest(TRot(2).create_mesh(3))
    assert [L.mesh.n_cells for L in levels] == [4, 16, 64, 256, 256]
    for L in levels:
        sp = TSpace(L.mesh, 1)
        assert [f["m"] for f in sp.patch2d_families] == [1]
    assert [TSpace(L.mesh, 1).n_nodes for L in levels] == [
        8, 24, 80, 288, 384]


@pytest.mark.parametrize("ref", [2, 3])
def test_rotation_model_equals_jax(ref):
    """The annulus, its boundary conditions and the constraint rows: the
    hanging nodes on the polar-manifold interface are constrained as the
    JAX package constrains them."""
    sim_t = make_simulation("rotation", 2)
    assert isinstance(sim_t, TRot)
    mt, mj = sim_t.create_mesh(ref), JRot(2).create_mesh(ref)
    assert np.array_equal(mt.vertices, mj.vertices)
    assert np.array_equal(mt.cells, mj.cells)
    assert np.array_equal(mt.boundary_ids, mj.boundary_ids)
    bt, bj = sim_t.get_boundary_descriptor(), JRot(2).get_boundary_descriptor()
    assert bt.all_homogeneous_dbcs == bj.all_homogeneous_dbcs == [1]
    assert [b for b, _ in bt.all_inhomogeneous_dbcs] == [0]
    pts = np.random.default_rng(0).random((5, 2))
    ft, fj = bt.all_inhomogeneous_dbcs[0][1], bj.all_inhomogeneous_dbcs[0][1]
    for comp in range(2):
        np.testing.assert_array_equal(ft(pts, comp), fj(pts, comp))
    st, sj = TSpace(mt, 1), JSpace(mj, 1)
    assert np.array_equal(st.cell_nodes, np.asarray(sj.cell_nodes))
    ct = TCsets(st, bt, torch.float64, "cpu").homogeneous
    cj = JCsets(sj, bj, np.float64).homogeneous
    assert ct.rows.numel() > 0
    assert np.array_equal(ct.rows.numpy(), np.asarray(cj.rows))
    assert np.array_equal(ct.cols.numpy(), np.asarray(cj.cols))
    np.testing.assert_allclose(ct.weights.numpy(), np.asarray(cj.weights),
                               rtol=0, atol=1e-14)
    with pytest.raises(NotImplementedError, match="rotation case is 2D"):
        make_simulation("rotation", 3).create_mesh(0)
