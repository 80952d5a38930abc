"""Refinement-forest levels for local-smoothing multigrid.

Port of ``ns_gls_tpu/mesh/forest.py`` (NumPy only).  The GMG-LS
hierarchy (reference ``main.cc:569-732``) smooths on the cells of each
refinement LEVEL of the forest, not on the generation chain that global
coarsening uses.  The forest is rebuilt from the stored generation chain
(``Mesh.prev`` and the ``parent_cell``/``parent_child`` maps): a forest
cell is born when a refinement creates it and stays the same while later
generations carry it, so the level-``l`` mesh is the set of cells born
at level ``l`` anywhere in the chain.

Vertex ids are stable along the chain (``Mesh._dedup_new_vertices``
keeps existing ids as a prefix), so every level mesh shares the final
mesh's vertex numbering.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ns_gls_tpu_torch.mesh.core import Mesh


@dataclasses.dataclass
class ForestLevel:
    """Cells of one refinement level of the forest."""

    mesh: Mesh                  # submesh of level cells (final vertex ids)
    parent: np.ndarray          # (n_c,) index into level l-1 cells; -1 at l=0
    child: np.ndarray           # (n_c,) child index in the parent; -1 at l=0
    active: np.ndarray          # (n_c,) index into the FINAL mesh; -1 inactive


def forest_levels(final: Mesh) -> list[ForestLevel]:
    """The per-level forest meshes of the generation chain ending in
    ``final``, level 0 first."""
    chain = [final]
    while chain[0].prev is not None:
        chain.insert(0, chain[0].prev)

    # per forest cell: vertex row (final numbering), boundary-id row,
    # refinement level, parent forest id and child index (-1 at level 0)
    cells, bids, level, parent_fid, child_idx = [], [], [], [], []
    fid_prev = None
    for g, m in enumerate(chain):
        fid = np.empty(m.n_cells, np.int64)     # chain cell -> forest id
        for c in range(m.n_cells):
            if g > 0 and m.parent_child[c] < 0:     # carried
                fid[c] = fid_prev[m.parent_cell[c]]
                continue
            fid[c] = len(cells)
            cells.append(m.cells[c])
            bids.append(m.boundary_ids[c])
            level.append(int(m.cell_level[c]))
            parent_fid.append(int(fid_prev[m.parent_cell[c]]) if g > 0
                              else -1)
            child_idx.append(int(m.parent_child[c]) if g > 0 else -1)
        fid_prev = fid

    cells = np.asarray(cells)
    bids = np.asarray(bids)
    level = np.asarray(level)
    parent_fid = np.asarray(parent_fid)
    child_idx = np.asarray(child_idx)

    active_of = np.full(len(cells), -1, np.int64)
    active_of[fid_prev] = np.arange(final.n_cells)

    levels = []
    loc_of = np.full(len(cells), -1, np.int64)  # forest id -> index in level
    for l in range(int(level.max()) + 1):
        sel = np.nonzero(level == l)[0]
        loc_of[sel] = np.arange(len(sel))
        par = parent_fid[sel]
        par_loc = np.where(par >= 0, loc_of[np.maximum(par, 0)], -1)
        if l > 0:
            assert (level[par] == l - 1).all(), "forest parent level gap"
            assert (par_loc >= 0).all(), "forest parent not found"
        m = Mesh(
            dim=final.dim,
            vertices=final.vertices,
            cells=cells[sel],
            boundary_ids=bids[sel],
            manifolds=final.manifolds,
            edge_manifold=final.edge_manifold,
            face_manifold=final.face_manifold,
            cell_level=level[sel].astype(np.int32),
            # transfer maps in level-local numbering: every level-l cell,
            # l >= 1, is a fresh child of a level-(l-1) forest cell, so
            # build_transfer sees no carried cells
            parent_cell=par_loc if l > 0 else None,
            parent_child=child_idx[sel] if l > 0 else None,
        )
        levels.append(ForestLevel(mesh=m, parent=par_loc,
                                  child=child_idx[sel],
                                  active=active_of[sel]))
    return levels
