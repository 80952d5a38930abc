"""Frozen copy of the spherical manifold of ``ns_gls_tpu_torch/mesh/core.py``
and of its attachment to a boundary id, taken when the sphere deployment
was added to the benchmark, so that the reference places the sphere's
new points without the program.  Changed: the attachment is a function
of the mesh (the frozen ``Mesh`` has no such method).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.frozen.core import Manifold, Mesh, _ekey, _fkey
from benchmark.reference.frozen.element import cell_face_vertices


class SphericalManifold(Manifold):
    """Spherical averaging around `center` (deal.II SphericalManifold)."""

    def __init__(self, center):
        self.center = np.asarray(center, dtype=np.float64)

    def new_point(self, points, weights):
        rel = points - self.center
        r = np.linalg.norm(rel, axis=-1)
        dirs = rel / r[:, None]
        d_new = weights @ dirs
        nrm = np.linalg.norm(d_new)
        if nrm < 1e-12:
            return weights @ points
        return self.center + (weights @ r) * d_new / nrm


def attach_manifold_to_boundary_id(mesh: Mesh, manifold_id: int,
                                   boundary_id: int) -> None:
    """Attach `manifold_id` to all boundary faces of a 3D mesh carrying
    the given boundary id, and to their edges."""
    bf = mesh.compute_boundary_faces()
    sel = mesh.boundary_ids[bf[:, 0], bf[:, 1]] == boundary_id
    fv = np.array(cell_face_vertices(3))
    for c, f in bf[sel]:
        verts = mesh.cells[c, fv[f]]
        mesh.face_manifold[_fkey(verts)] = manifold_id
        # all 4 edges of the quad face (lexicographic face verts:
        # 0-1, 2-3 (x dir), 0-2, 1-3 (y dir))
        for a, b in ((0, 1), (2, 3), (0, 2), (1, 3)):
            mesh.edge_manifold[_ekey(verts[a], verts[b])] = manifold_id
