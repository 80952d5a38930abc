"""The prism kernel as the halo local sweep on extruded 3D meshes.

Port of ``ns_gls_tpu/parallel/halo_prism.py`` for the Turek/Hoffmann 3D
meshes: partition by 2D PATCH (whole z-columns per shard,
:func:`prism_patch_partition`), and give each shard prism tables
(``ops/prism.py`` ``make_prism_tables``) over its patches in a compact
local numbering of its 2D nodes.  A shard gathers its patch tiles from
its window through the window slot of every (2D node, z) pair it holds,
runs the kernel, seam-compresses the cell-row tiles onto its 2D nodes
and writes each z-run back at its window slots; the reverse ghost
exchange of ``parallel/halo.py`` sums the seam partials between shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ns_gls_tpu_torch.ops.prism import (
    PrismSweep,
    make_prism_tables,
    prism_patch_arrays,
)
from ns_gls_tpu_torch.parallel.halo_patch2d import split_patches


def prism_patch_partition(space, n_dev: int):
    """Partition an extruded space by its 2D patches (whole z-columns per
    shard): (cells_of, patches_of), or None when there are fewer patches
    than shards."""
    m2 = space.mesh.extr_mesh2d
    centers = m2.vertices[m2.cells].mean(axis=1)     # fine 2D cell centers
    part = split_patches(centers, np.asarray(space.patch_of_cell2d), n_dev,
                         16)
    if part is None:
        return None
    cells2d_of, patches_of = part
    pdev = np.empty(space.n_patches, np.int64)
    for d, pl in enumerate(patches_of):
        pdev[pl] = d
    dev3 = pdev[np.asarray(space.patch_of_cell2d)[space.mesh.extr_cell2d]]
    return [np.nonzero(dev3 == d)[0] for d in range(n_dev)], patches_of


class WindowPrismSweep(PrismSweep):
    """A shard's prism sweep: :class:`PrismSweep` on the shard's patches,
    reading and writing the shard's window ``(n_loc, C)`` through
    ``cols`` (n2d_loc, Nzn), the window slot of each of its 2D nodes'
    z-runs."""

    def __init__(self, op, tables, cols: torch.Tensor, n_loc: int):
        super().__init__(op, tables)
        self.cols = cols
        self.n2d = cols.shape[0]
        self.n_loc = n_loc

    def gather_nodes(self, v, lead: int):
        """Window (n_loc, C) -> patch tiles (lead, n_p, Yn, Xn, Nzn)."""
        v2d = v[self.cols][..., :lead].permute(2, 0, 1)
        return v2d[:, self.tables.patch_nodes]

    def apply(self, weight: float, stau: float, uP, ulP, voP, flavor: str):
        """The sweep onto the window (n_loc, C); zero at slots off the
        shard's columns."""
        out = super().apply(weight, stau, uP, ulP, voP, flavor)
        r = out.new_zeros((self.n_loc, out.shape[1]))
        r[self.cols.reshape(-1)] = out      # in place on the fresh window
        return r


def build_halo_prism(op, patches_of, g2l: np.ndarray, n_loc: int, devices):
    """Per shard, a :class:`WindowPrismSweep` on its device; None when the
    operator holds no prism sweep."""
    if not isinstance(op._fast, PrismSweep):
        return None
    arrays = prism_patch_arrays(op)
    if arrays is None:
        return None
    pn, jinv_t, jxw_t, h_t = arrays
    space = op.space
    Nzn = space.nz_nodes
    sweeps = []
    for d, (pl, dev) in enumerate(zip(patches_of, devices)):
        pl = np.asarray(pl)
        uniq, inv = np.unique(pn[pl], return_inverse=True)
        cols = g2l[d][uniq[:, None] * Nzn + np.arange(Nzn)[None, :]]
        assert (cols < n_loc).all(), "patch column outside the window"
        tables = make_prism_tables(
            space.degree, space.n_q1d, int(space.patch_cells),
            int(space.nz_cells), len(uniq), inv.reshape(pn[pl].shape),
            jinv_t[pl], jxw_t[pl], h_t[pl], dev)
        sweeps.append(WindowPrismSweep(
            op, tables, torch.as_tensor(cols, device=dev), n_loc))
    return sweeps
