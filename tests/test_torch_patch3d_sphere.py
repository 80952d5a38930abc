"""The port's patch-3D sweep (its plain PyTorch version) against the JAX
package, beside ``tests/test_torch_patch3d.py``:

- single-cell patches (m = 1, 2 x 2 x 2 node tiles) of an unrefined
  general 3D mesh against the Pallas kernel in interpret mode,
- the Gmsh sphere at refinement 1 (48 patches of m = 2; curved cells on
  the spherical manifold; patches in their coarse cells' own frames,
  meeting at vertices of irregular valence) at Q1 and Q2 against the JAX
  general sweep (``use_structured=False``; the JAX package slow-marks its
  sphere case in interpret mode), in every flavor and delta mode: the
  test of patch orientation,
- the seam-compress tables on the sphere against the JAX package's.

Both sides run in f32 with different summation orders: 5e-6 relative to
the reference's max-abs, as the JAX package's own patch-3D tests use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh import generators as jgen
from ns_gls_tpu.mesh.gmsh import read_msh as jread
from ns_gls_tpu_torch.fem.constraints import AffineConstraints as TAff
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh import generators as tgen
from ns_gls_tpu_torch.mesh.gmsh import read_msh as tread
from ns_gls_tpu_torch.ops import prism as tpr
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator as TBDF
from tests.test_torch_patch3d import (
    F32,
    _check,
    _setup,
    general3d_mesh,
    sphere_mesh,
)
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield



@pytest.mark.parametrize("increment,cell_wise", [(True, False),
                                                 (False, True)])
def test_plain_patch3d_vs_pallas_single_cell_patches(increment, cell_wise):
    """m = 1: every cell is its own patch."""
    opj, opt, u, v = _setup(general3d_mesh(jgen, 0), general3d_mesh(tgen, 0),
                            1, increment, cell_wise, True, True, 1)
    _check(opj, opt, u, v)


@pytest.mark.parametrize("degree,increment,cell_wise", [
    (1, True, False), (1, False, True), (1, True, True), (1, False, False),
    (2, True, False), (2, False, True), (2, True, True), (2, False, False),
])
def test_plain_patch3d_vs_general_sweep_sphere(degree, increment, cell_wise):
    """The sphere at refinement 1 in every flavor and delta mode against
    the JAX general sweep."""
    opj, opt, u, v = _setup(sphere_mesh(jread), sphere_mesh(tread), degree,
                            increment, cell_wise, True, False, 2)
    _check(opj, opt, u, v)


def _sphere_sweep(degree):
    """The port's patch-3D sweep of a sphere ref-1 f32 operator."""
    st = TSpace(sphere_mesh(tread), degree)
    ti = TBDF(1)
    ti.update_dt(0.1)
    ca = TAff(st.n_nodes, 4).close(F32, "cpu")
    op = TOp(st, ca, ca, nu=0.02, c_1=4.0, c_2=2.0, time_integrator=ti,
             dtype=F32, device="cpu")
    return st, op._fast


def _tile_rows(tab):
    """Node id of every row of the cell-row tiles (n_p, m, Zn, P+1, Xn)."""
    pn = tab.patch_nodes.numpy().astype(np.int64)     # (n_p, y, x, z)
    return pn[:, tpr.cell_row_index(tab.P, tab.m)].transpose(0, 1, 4, 2, 3)


@pytest.mark.parametrize("degree", [1, 2])
def test_seam_compress_is_multiplicity(degree):
    """Table parity on the sphere: the patch gather, spread to cell rows
    and seam-compressed, gives each node its value times the number of
    cell-row tiles that hold it; that number is at least the node's
    patch multiplicity, and the JAX seam-compress classes give each node
    the same multiplicity as the port's space."""
    from ns_gls_tpu.ops.patch3d import build_patch3d_tables as jbuild

    st, sw = _sphere_sweep(degree)
    sj = JSpace(sphere_mesh(jread), degree)
    tab = sw.tables
    rng = np.random.default_rng(5)
    vn = torch.as_tensor(rng.standard_normal((st.n_nodes, 4)), dtype=F32)
    rows = _tile_rows(tab)
    assert sw.gather_nodes(vn, 4) is vn
    tiles = vn[torch.as_tensor(rows)]          # (n_p, m, Zn, P+1, Xn, 4)
    out = sw.compress(tiles)
    count = np.bincount(rows.reshape(-1), minlength=st.n_nodes)
    np.testing.assert_allclose(out.numpy(), vn.numpy() * count[:, None],
                               rtol=1e-6, atol=1e-6)
    assert (count >= st.node_mult3).all()
    ones = sw.compress(torch.ones_like(tiles))
    assert (ones.numpy() == count[:, None]).all()
    # the lattices are the space's in (y, x, z) order
    assert np.array_equal(tab.patch_nodes.numpy(),
                          np.asarray(st.patch_nodes3).transpose(0, 2, 3, 1))

    class _Op:
        space = sj
        theta = 1.0
        dtype = jnp.float32

    assert np.array_equal(np.asarray(sj.patch_nodes3),
                          np.asarray(st.patch_nodes3))
    jt = jbuild(_Op)
    jmult = np.concatenate([np.full(len(idx), idx.shape[1])
                            for idx in jt.compress])
    assert np.array_equal(jmult, st.node_mult3)


@pytest.mark.parametrize("degree", [1, 2])
def test_seam_sum_plain_vs_class_sum(degree):
    """The seam-sum kernel's plain version on the sphere ref-1 tables
    against the class sums it replaces (``utils/segment.py``): the same
    bits as the class sums taken in source order, and within f32
    rounding (1e-6 of the max-abs) of the class sums' own order."""
    from ns_gls_tpu_torch.utils.segment import (
        class_gather,
        class_sum,
        seam_sum_plain,
    )

    st, sw = _sphere_sweep(degree)
    tab = sw.tables
    rows = _tile_rows(tab).reshape(-1)
    src = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (len(rows), 4)), dtype=F32)
    got = seam_sum_plain(tab.seams, src)
    cg = class_gather(rows, st.n_nodes, "cpu")
    assert torch.equal(got, class_sum(cg, src, in_order=True))
    ref = class_sum(cg, src)
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    assert tab.seams.offsets.dtype == tab.seams.sources.dtype == torch.int32
