"""The sphere case of the port against the JAX package: the Gmsh reader,
the model (mesh with its spherical manifold, boundary descriptor,
inflow), the registry, and the FE spaces the sphere runs on.

The spaces are built by each package's own code from the same mesh file
and must number their nodes alike: equal ``cell_nodes``, ``node_pos``,
patch lattices (``patch_nodes3``, ``patch_cells``, the patch and lattice
position of every cell) and ``n_nodes``.  So a solution vector of one
package is a solution vector of the other as it stands, row for row: the
driver parity tests (``tests/test_torch_sphere_driver.py``) compare them
that way.  Every comparison here is exact except the slip normals and the
refined vertices, which are computed by the same float64 arithmetic in
both and held to 1e-14.
"""

import numpy as np
import pytest

from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh.gmsh import read_msh as jread
from ns_gls_tpu.models import make_simulation as jmake
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh.gmsh import read_msh as tread
from ns_gls_tpu_torch.models import UNPORTED, make_simulation as tmake
from ns_gls_tpu_torch.models.sphere import MESH_FILE, SimulationSphere
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield



def test_read_msh_equals_jax():
    mj, mt = jread(MESH_FILE), tread(MESH_FILE)
    assert mt.n_cells == 48 and len(mt.vertices) == 78
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.cells, mj.cells)
    np.testing.assert_array_equal(mt.boundary_ids, mj.boundary_ids)
    # every boundary id of the case is present: sphere 0, inflow 1, slip
    # walls 2, outflow 3
    assert set(np.unique(mt.boundary_ids)) == {-1, 0, 1, 2, 3}


@pytest.mark.parametrize("n_refine", [0, 1])
def test_sphere_model_equals_jax(n_refine):
    sj, st = jmake("sphere", 3), tmake("sphere", 3)
    assert isinstance(st, SimulationSphere)
    mj, mt = sj.create_mesh(n_refine), st.create_mesh(n_refine)
    assert mt.n_cells == 48 * 8 ** n_refine
    np.testing.assert_allclose(mt.vertices, mj.vertices, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(mt.cells, mj.cells)
    np.testing.assert_array_equal(mt.boundary_ids, mj.boundary_ids)
    if n_refine:
        # the new vertices on the sphere lie on it (the manifold)
        on = np.unique(mt.cells[np.nonzero(mt.boundary_ids == 0)[0]])
        r = np.linalg.norm(mt.vertices[on], axis=1)
        sphere = np.isclose(r, r.min(), rtol=1e-12)
        assert sphere.sum() > 26
    bj, bt = sj.get_boundary_descriptor(), st.get_boundary_descriptor()
    assert bt.all_homogeneous_dbcs == bj.all_homogeneous_dbcs == [0]
    assert bt.all_homogeneous_nbcs == bj.all_homogeneous_nbcs == [3]
    assert bt.all_slip_bcs == bj.all_slip_bcs == [2]
    assert ([b for b, _ in bt.all_inhomogeneous_dbcs]
            == [b for b, _ in bj.all_inhomogeneous_dbcs] == [1])
    fj, ft = bj.all_inhomogeneous_dbcs[0][1], bt.all_inhomogeneous_dbcs[0][1]
    pts = np.random.default_rng(0).random((7, 3))
    for t in (0.0, 0.3):
        fj.set_time(t)
        ft.set_time(t)
        for comp in range(3):
            np.testing.assert_array_equal(ft(pts, comp), fj(pts, comp))
    assert st.get_u_max() == sj.get_u_max()
    assert st.mapping_degree(2, 0) == sj.mapping_degree(2, 0) == 2


def test_mesh_file_key_and_registry(tmp_path):
    """``"simulation mesh file"`` names another mesh; the registry builds
    the sphere and has no model still to port."""
    st = tmake("sphere", 3)
    assert st.mesh_file == MESH_FILE
    other = tmp_path / "copy.msh"
    other.write_bytes(open(MESH_FILE, "rb").read())
    st.parse_parameters({"simulation mesh file": str(other)})
    assert st.mesh_file == str(other)
    assert st.create_mesh(0).n_cells == 48
    assert UNPORTED == ()
    with pytest.raises(NotImplementedError, match="sphere case is 3D"):
        tmake("sphere", 2)


@pytest.mark.parametrize("degree", [1, 2])
def test_sphere_space_numbering_equals_jax(degree):
    """Refinement 1: the patch-3D numbering (48 patches of m = 2, nodes
    relabelled by patch multiplicity), the mapping, and the slip normals
    of the walls; the iso-Q1 coarsest level of ``sphere_amg.json``."""
    mj = jmake("sphere", 3).create_mesh(1)
    mt = tmake("sphere", 3).create_mesh(1)
    sj, st = JSpace(mj, degree, degree), TSpace(mt, degree, degree)
    assert st.patch3d and sj.patch3d
    assert st.n_nodes == sj.n_nodes == {1: 490, 2: 3474}[degree]
    assert st.n_patches == 48 and st.patch_cells == sj.patch_cells == 2
    for name in ("cell_nodes", "node_pos", "patch_nodes3", "patch_of_cell3",
                 "lattice_of_cell3", "node_mult3"):
        np.testing.assert_array_equal(getattr(st, name), getattr(sj, name),
                                      err_msg=name)
    np.testing.assert_array_equal(st.jxw, sj.jxw)
    for bid in (0, 1, 2, 3):
        np.testing.assert_array_equal(st.boundary_nodes([bid]),
                                      sj.boundary_nodes([bid]))
    nt, vt = st.boundary_node_normals([2])
    nj, vj = sj.boundary_node_normals([2])
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-14)
    if degree == 2:
        it = TSpace(mt.prev, 2, 2, iso_q1=True)
        ij = JSpace(mj.prev, 2, 2, iso_q1=True)
        assert not it.patch3d and not ij.patch3d
        assert it.n_nodes == ij.n_nodes == 490
        np.testing.assert_array_equal(it.cell_nodes, ij.cell_nodes)
        np.testing.assert_array_equal(it.node_pos, ij.node_pos)


def test_bench_gpu_sphere_lane_rehearsal(capsys):
    """``bench_gpu.py --sphere [ref] [degree]``: the JAX package's
    ``bench.py --sphere`` operator on the patch-3D sweep; ``--device
    cpu`` rehearses it and prints no device metric."""
    import os
    import sys

    import torch

    from ns_gls_tpu_torch.ops.patch3d import Patch3DSweep

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import bench_gpu
    finally:
        sys.path.remove(root)
    assert bench_gpu.main(["--sphere", "1", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "1960 DoFs, increment flavor" in out
    assert "not measured" in out and "MDoF/s" not in out
    op, space, u = bench_gpu.build_sphere(1, 2, "cpu")
    assert isinstance(op._fast, Patch3DSweep) and op.increment_form
    assert not op.cell_wise_stabilization and space.n_nodes * 4 == 13896
    args = bench_gpu.sweep_args(op, u)
    assert args[5:] == ("increment", True, False)
    out = op._fast.apply(args[1]["weight"], args[1]["stau"], *args[2:6])
    assert torch.equal(out, op.vmult(u))
