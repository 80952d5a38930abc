"""The patch-2D kernel as the halo local sweep on general 2D meshes.

Port of ``ns_gls_tpu/parallel/halo_patch2d.py``.  The mesh is partitioned
by PATCH (contiguous Morton-ordered runs of refinement patches per shard,
:func:`patch2d_partition`), and each shard gets its own patch-2D tables
(``ops/patch2d.py``) against its halo window: the lattice ids are window
slots, so the kernel reads the shard's node-major window ``(n_loc, 3)``
directly, writes its cell-row tiles, and one seam-sum launch adds them
onto the window slots (slots no tile of the shard touches, the ghosts of
constraint masters, sum to zero).  The reverse ghost exchange of
``parallel/halo.py`` then sums the seam partials between shards.

Each shard's tables have its own patch count and plan; nothing is padded
to a common shape.  A mesh of several patch families takes the general
halo sweep, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ns_gls_tpu_torch.ops.patch2d import (
    Patch2DSweep,
    families,
    family_tables,
)


def _morton(pts: np.ndarray, bits: int) -> np.ndarray:
    """Order of points along a Morton curve of ``bits`` bits an axis."""
    lo, hi = pts.min(0), pts.max(0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    q = ((pts - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(len(pts), dtype=np.uint64)
    for bit in range(bits):
        for d in range(pts.shape[1]):
            code |= ((q[:, d] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(
                bit * pts.shape[1] + d
            )
    return np.argsort(code, kind="stable")


def split_patches(centers: np.ndarray, patch_of_cell: np.ndarray,
                  n_dev: int, bits: int):
    """(cells_of, patches_of): the patches in Morton order of their
    centers, split into ``n_dev`` contiguous runs of floor or ceil
    patches, and each run's cells; None when a run would be empty."""
    n_patches = int(patch_of_cell.max()) + 1
    if n_patches < n_dev:
        return None
    pc = np.zeros((n_patches, centers.shape[1]))
    cnt = np.zeros(n_patches)
    np.add.at(pc, patch_of_cell, centers)
    np.add.at(cnt, patch_of_cell, 1)
    pc /= cnt[:, None]
    patches_of = np.array_split(_morton(pc, bits), n_dev)
    if any(len(pl) == 0 for pl in patches_of):
        return None
    pdev = np.empty(n_patches, np.int64)
    for d, pl in enumerate(patches_of):
        pdev[pl] = d
    cells_of = [np.nonzero(pdev[patch_of_cell] == d)[0] for d in range(n_dev)]
    return cells_of, patches_of


def patch2d_partition(space, n_dev: int):
    """Partition a one-family patch-2D space by patch: (cells_of,
    patches_of), or None (several families, or fewer patches than
    shards)."""
    if len(getattr(space, "patch2d_families", ())) != 1:
        return None
    mesh = space.mesh
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    return split_patches(centers, np.asarray(space.patch_of_cell2d), n_dev,
                         16)


def build_halo_patch2d(op, patches_of, g2l: np.ndarray, n_loc: int,
                       devices):
    """Per shard, a :class:`Patch2DSweep` over its patches with window-slot
    lattice ids on its device; None when the operator holds no one-family
    patch-2D sweep."""
    space = op.space
    if not isinstance(op._fast, Patch2DSweep):
        return None
    if len(space.patch2d_families) != 1:
        return None
    (fam,) = space.patch2d_families
    pn_all = np.asarray(fam["patch_nodes"], np.int64)
    patch_of = np.asarray(fam["patch_of_cell"])
    lat_of = np.asarray(fam["lattice_of_cell"])
    cells_all = np.asarray(fam["cells"])
    sweeps = []
    for d, (pl, dev) in enumerate(zip(patches_of, devices)):
        pl = np.asarray(pl)
        slot_of = np.full(len(pn_all), -1, np.int64)
        slot_of[pl] = np.arange(len(pl))
        sel = np.nonzero(slot_of[patch_of] >= 0)[0]
        loc = g2l[d][pn_all[pl]]
        assert (loc < n_loc).all(), "patch node outside the shard's window"
        fam_d = dict(m=fam["m"], n_patches=len(pl), cells=cells_all[sel],
                     patch_of_cell=slot_of[patch_of[sel]],
                     lattice_of_cell=lat_of[sel],
                     patch_nodes=loc.astype(np.int32))
        tables = families([family_tables(space, fam_d, dev, n_loc)], n_loc,
                          every_node=False)
        sweeps.append(Patch2DSweep(op, tables))
    return sweeps
