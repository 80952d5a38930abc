"""The patch-3D kernel as the halo local sweep on general 3D meshes.

Port of ``ns_gls_tpu/parallel/halo_patch3d.py`` for the Gmsh sphere
family: partition by patch (contiguous Morton-3D runs of refinement
patches per shard, :func:`patch3d_partition`), build each shard's
patch-3D tables (``ops/patch3d.py`` ``make_patch3d_tables``) with window
slots as lattice ids, run the kernel on the shard's node-major window
``(n_loc, 4)`` and seam-sum its tiles onto the window slots; the reverse
ghost exchange of ``parallel/halo.py`` sums the seam partials between
shards.  Each shard's tables have their own patch count and plans.
"""

from __future__ import annotations

import numpy as np

from ns_gls_tpu_torch.ops.patch3d import (
    Patch3DSweep,
    make_patch3d_tables,
    patch3d_geometry,
)
from ns_gls_tpu_torch.parallel.halo_patch2d import split_patches


def patch3d_partition(space, n_dev: int):
    """Partition a patch-3D space by patch: (cells_of, patches_of), or
    None when there are fewer patches than shards."""
    mesh = space.mesh
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    return split_patches(centers, np.asarray(space.patch_of_cell3), n_dev,
                         10)


def build_halo_patch3d(op, patches_of, g2l: np.ndarray, n_loc: int,
                       devices):
    """Per shard, a :class:`Patch3DSweep` over its patches with window-slot
    lattice ids on its device; None when the operator holds no patch-3D
    sweep."""
    if not isinstance(op._fast, Patch3DSweep):
        return None
    space = op.space
    pn, jinv_t, jxw_t, h_t = patch3d_geometry(space)
    sweeps = []
    for d, (pl, dev) in enumerate(zip(patches_of, devices)):
        pl = np.asarray(pl)
        loc = g2l[d][pn[pl]]
        assert (loc < n_loc).all(), "patch node outside the shard's window"
        tables = make_patch3d_tables(
            space.degree, space.n_q1d, int(space.patch_cells), n_loc, loc,
            jinv_t[pl], jxw_t[pl], h_t[pl], dev, every_node=False)
        sweeps.append(Patch3DSweep(op, tables))
    return sweeps
