"""The port's batched 3D structured sweep against the JAX package's batched
Pallas kernel (``_make_kernel_3d_batched``), which no path of the JAX
package selects: here its 3D structured operator is made to build that
kernel in place of ``_make_kernel_3d`` (through pytest's ``monkeypatch``,
with the arguments the batched factory takes), and it runs in interpret
mode on the CPU as the JAX package's own tests run its kernels.

The port's side is ``StructuredSweep(..., batched=True)``, which on the
CPU runs the plain version (the batched CUDA kernel is held to that
plain version on the card).  Q1 and Q2 on the 3 x 2 x 2 lattice of
``tests/test_torch_structured.py``, the increment and fixed flavors,
cell- and q-wise delta, with the time derivative in the stabilization:
the vmult and the residual within 5e-6 relative to the reference's
max-abs, the tolerance of that file (both sides f32 with different
summation orders; the Pallas kernel splits its band products in bf16x3).
"""

import numpy as np
import pytest
import torch

import ns_gls_tpu.ops.structured as jst
from ns_gls_tpu_torch.ops import structured as ts
from ns_gls_tpu_torch.utils.device import torch_threads
from test_torch_structured import (
    BRICK_SHAPES,
    _check,
    _setup,
    brick_layout,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


@pytest.fixture
def jax_batched(monkeypatch):
    """Make the JAX 3D structured operator build the batched kernel."""
    built = []

    def make(dims, flavor, consider_dt, cell_wise, prec_mode, wide=False,
             qz_stack=False):
        built.append(flavor)
        return jst._make_kernel_3d_batched(dims, flavor, consider_dt,
                                           cell_wise, prec_mode)

    monkeypatch.setattr(jst, "_make_kernel_3d", make)
    return built


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("increment", [True, False])
@pytest.mark.parametrize("cell_wise", [True, False])
def test_batched_sweep_vs_batched_pallas(jax_batched, degree, increment,
                                         cell_wise):
    opj, opt, u, v = _setup(3, degree, increment, cell_wise, True, True,
                            batched=True)
    assert opt._fast.batched
    _check(opj, opt, u, v)
    # the JAX side ran the batched factory: the vmult's flavor and the
    # residual's
    assert set(jax_batched) == {"increment" if increment else "fixed",
                                "residual"}
    assert ts.StructuredKernel.kernel_name(3, True) == "structured3d_batched"


def batched_blocks(plan, cell_shape):
    """The cells each block of the batched 3D kernel owns under ``plan``,
    as ``csrc/structured.cu`` splits the lattice (block = (brick bx, cell
    row ey, z chunk kz)): [(x0, x1, ey, z0, z1)]."""
    nx, ny, nz = cell_shape
    return [(bx * plan.xb, min(nx, (bx + 1) * plan.xb), ey,
             kz * plan.zc, min(nz, (kz + 1) * plan.zc))
            for ey in range(ny) for bx in range(plan.nbx)
            for kz in range(plan.nzb)]


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_batched_plan_covers_every_cell_once(degree):
    """The batched kernel's blocks under ``batched_plan`` own every cell of
    the lattice exactly once, and the plan is one its launcher takes (at
    most two output columns a thread, one node-copy group per node of a
    brick's planes).  The plan does not depend on the flavor."""
    for cs in BRICK_SHAPES:
        plan = ts.batched_plan(degree, cs)
        nx, ny, nz = cs
        assert plan.nbx == -(-nx // plan.xb) and 1 <= plan.xb <= nx
        assert 1 <= plan.zs <= plan.zc + 1
        assert (plan.nzb - 1) * plan.zc < nz <= plan.nzb * plan.zc
        xn = degree * plan.xb + 1
        assert 4 * (degree + 1) * xn <= 2 * 256 and (degree + 1) * xn <= 256
        owned = np.zeros((nz, ny, nx), int)
        blocks = batched_blocks(plan, cs)
        assert len(blocks) == plan.nbx * ny * plan.nzb
        for x0, x1, ey, z0, z1 in blocks:
            assert x0 < x1 and z0 < z1
            owned[z0:z1, ey, x0:x1] += 1
        assert (owned == 1).all(), (cs, plan)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_batched_plan_fits_shared_memory(degree):
    """In every flavor, with and without the history, a block of every
    ``batched_plan`` plan fits the H100's 227 KB a block (with the
    kernel's static shared memory: 11 field pointers and P + 1 row
    offsets), and two blocks fit an SM wherever the plan's waves count two
    blocks per SM (below P = 6)."""
    static = 11 * 8 + (degree + 1) * 4
    for cs in BRICK_SHAPES:
        plan = ts.batched_plan(degree, cs)
        for flavor in ts.FLAVORS:
            for consider_dt in (True, False):
                b = ts.batched_smem(degree, plan.xb, plan.zs, flavor,
                                    consider_dt)
                assert b + static <= 227 * 1024
                if degree < 6:
                    assert b <= ts.SMEM_TWO_BLOCKS
    assert 2 * (ts.SMEM_TWO_BLOCKS + 1024 + 128) <= 228 * 1024
    for xb, zs in ts.BATCHED_BRICKS[degree]:
        assert (ts.batched_smem(degree, xb, zs, "increment", True)
                <= ts.SMEM_TWO_BLOCKS) == (degree < 6)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_batched_tiles_fold(degree):
    """The batched kernel's output under its own plan on the ragged
    sheared lattice of ``chip_smoke.py`` (19 x 3 x 2 cells) and on 3 x 2 x
    2, folded (``fold_bricks``), equals the scatter-add of per-cell
    values: tiles and seams built as the kernel lays them out."""
    rng = np.random.default_rng(6)
    P = degree
    for cs in ((3, 2, 2), (19, 3, 2)):
        plan = ts.batched_plan(P, cs)
        idx = ts.lattice_cell_nodes(P, cs)
        shp = ts.lattice_shape(P, cs)
        C = 4
        r_loc = rng.standard_normal((C, idx.shape[0], (P + 1) ** 3))
        ref = np.zeros((C, int(np.prod(shp))))
        for c in range(C):
            np.add.at(ref[c], idx.reshape(-1), r_loc[c].reshape(-1))
        tiles, seams = brick_layout(r_loc, P, cs, plan)
        tab = ts.StructuredTables(d=3, P=P, NQ=P + 1, cell_shape=cs,
                                  S1=None, D1=None, jinv=None, jxw=None,
                                  h=None)
        out = ts.fold_bricks(tab, torch.as_tensor(tiles),
                             torch.as_tensor(seams), plan.xb)
        assert tuple(out.shape) == (C,) + shp
        np.testing.assert_allclose(out.reshape(C, -1).numpy(), ref,
                                   rtol=1e-12, atol=1e-12)
