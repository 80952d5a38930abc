"""Frozen copy of ``ns_gls_tpu_torch/mesh/generators.py``, taken when the
benchmark was defined, so that the reference works out its geometry
without the program. Changed: imports point at this folder; the parts
the reference does not use are left out.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.frozen.core import Mesh, _ekey, _fkey


def subdivided_hyper_rectangle(
    n_subdivisions, p0, p1, colorize: bool = False
) -> Mesh:
    """Axis-aligned box [p0, p1] with given subdivisions per direction.

    With colorize=True, boundary ids follow deal.II's convention:
    face 2*d+side gets id 2*d+side (x-: 0, x+: 1, y-: 2, y+: 3, ...).
    """
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    dim = len(p0)
    n = list(n_subdivisions)
    axes = [np.linspace(p0[d], p1[d], n[d] + 1) for d in range(dim)]
    shape = [len(a) for a in axes]

    # vertices, x fastest
    idx = np.arange(int(np.prod(shape)))
    verts = np.empty((len(idx), dim))
    rem = idx.copy()
    for d in range(dim):
        verts[:, d] = axes[d][rem % shape[d]]
        rem //= shape[d]

    def vid(coords):
        out = np.zeros_like(coords[0])
        mult = 1
        for d in range(dim):
            out = out + coords[d] * mult
            mult *= shape[d]
        return out

    grids = np.meshgrid(*[np.arange(n[d]) for d in range(dim)], indexing="ij")
    base = [g.reshape(-1) for g in grids]
    n_c = len(base[0])
    cells = np.empty((n_c, 2**dim), dtype=np.int64)
    for v in range(2**dim):
        offs = [(v >> d) & 1 for d in range(dim)]
        cells[:, v] = vid([base[d] + offs[d] for d in range(dim)])

    mesh = Mesh(
        dim=dim,
        vertices=verts,
        cells=cells,
        boundary_ids=np.full((n_c, 2 * dim), -1, dtype=np.int32),
        lattice=np.stack(base, axis=1).astype(np.int64),
        lattice_shape=tuple(n),
    )
    eps = 1e-10 * max(np.max(np.abs(p1 - p0)), 1.0)

    def ids(centers):
        out = np.zeros(len(centers), dtype=np.int32)
        for d in range(dim):
            out[np.abs(centers[:, d] - p0[d]) < eps] = 2 * d
            out[np.abs(centers[:, d] - p1[d]) < eps] = 2 * d + 1
        return out

    mesh.set_boundary_ids(ids if colorize else (lambda c: np.zeros(len(c), np.int32)))
    return mesh


def hyper_cube_with_cylindrical_hole(
    inner_radius: float, outer_radius: float, manifold_id: int = 0
) -> Mesh:
    """8-cell square [-R, R]^2 with a circular hole of radius r.

    Topology matches deal.II ``hyper_cube_with_cylindrical_hole`` (2D):
    outer ring vertices at the 4 square corners + 4 edge midpoints; inner
    vertices on the circle at the matching 8 angles.  The circle edges are
    tagged with `manifold_id` (attach a PolarManifold to it, like
    reference ``grid_cylinder.h:26-27,89-90``).
    """
    r, R = inner_radius, outer_radius
    angles = np.arange(8) * (np.pi / 4.0)
    dirs = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    inner = r * dirs
    outer = R * dirs / np.max(np.abs(dirs), axis=1, keepdims=True)
    # clean up tiny fp noise so merges at x=±R etc. match exactly
    inner[np.abs(inner) < 1e-14] = 0.0
    outer[np.abs(outer) < 1e-14] = 0.0
    verts = np.vstack([inner, outer])

    cells = np.empty((8, 4), dtype=np.int64)
    for i in range(8):
        j = (i + 1) % 8
        # lexicographic with positive Jacobian: x dir = clockwise tangent
        cells[i] = [j, i, 8 + j, 8 + i]

    mesh = Mesh(
        dim=2,
        vertices=verts,
        cells=cells,
        boundary_ids=np.full((8, 4), -1, dtype=np.int32),
    )
    mesh.set_boundary_ids(lambda c: np.zeros(len(c), np.int32))
    for i in range(8):
        mesh.edge_manifold[_ekey(i, (i + 1) % 8)] = manifold_id
    return mesh


def merge_triangulations(meshes: list[Mesh], tol: float = 1e-12) -> Mesh:
    """Merge meshes, identifying vertices closer than `tol`; keeps manifold
    attachments (deal.II ``merge_triangulations(..., 1e-12, true)``,
    reference ``grid_cylinder.h:80-84``).  Boundary ids are recomputed to
    "all 0" — the callers re-assign them by predicate afterwards."""
    dim = meshes[0].dim
    all_verts = np.vstack([m.vertices for m in meshes])
    # dedupe by rounding to the tolerance grid
    key = np.round(all_verts / tol).astype(np.int64)
    _, first, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    # map: old global -> new id (order of first occurrence for determinism)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    new_of_old = rank[inv]
    verts = all_verts[np.sort(first)]

    cells = []
    edge_manifold = {}
    face_manifold = {}
    manifolds = {}
    offset = 0
    for m in meshes:
        remap = new_of_old[offset : offset + m.n_vertices]
        cells.append(remap[m.cells])
        for (a, b), mid in m.edge_manifold.items():
            edge_manifold[_ekey(int(remap[a]), int(remap[b]))] = mid
        for k, mid in m.face_manifold.items():
            face_manifold[_fkey([remap[v] for v in k])] = mid
        manifolds.update(m.manifolds)
        offset += m.n_vertices
    cells = np.vstack(cells)

    mesh = Mesh(
        dim=dim,
        vertices=verts,
        cells=cells,
        boundary_ids=np.full((len(cells), 2 * dim), -1, dtype=np.int32),
        manifolds=manifolds,
        edge_manifold=edge_manifold,
        face_manifold=face_manifold,
    )
    mesh.set_boundary_ids(lambda c: np.zeros(len(c), np.int32))
    return mesh


def extrude(mesh2d: Mesh, n_slices: int, height: float) -> Mesh:
    """Extrude a 2D mesh into 3D with `n_slices` z-planes over [0, height]
    (deal.II ``extrude_triangulation``, reference ``grid_cylinder.h:176``).
    Curved 2D edges become curved 3D side faces (+ their edges), carrying
    the same manifold id (to be bound to a CylindricalManifold)."""
    assert mesh2d.dim == 2
    n_v2, n_c2 = mesh2d.n_vertices, mesh2d.n_cells
    zs = np.linspace(0.0, height, n_slices)
    verts = np.empty((n_v2 * n_slices, 3))
    for l, z in enumerate(zs):
        verts[l * n_v2 : (l + 1) * n_v2, :2] = mesh2d.vertices
        verts[l * n_v2 : (l + 1) * n_v2, 2] = z

    n_layers = n_slices - 1
    cells = np.empty((n_c2 * n_layers, 8), dtype=np.int64)
    for l in range(n_layers):
        lo = mesh2d.cells + l * n_v2
        hi = mesh2d.cells + (l + 1) * n_v2
        cells[l * n_c2 : (l + 1) * n_c2] = np.hstack([lo, hi])

    edge_manifold = {}
    face_manifold = {}
    for (a, b), mid in mesh2d.edge_manifold.items():
        for l in range(n_slices):
            edge_manifold[_ekey(a + l * n_v2, b + l * n_v2)] = mid
        for l in range(n_layers):
            a0, b0 = a + l * n_v2, b + l * n_v2
            a1, b1 = a + (l + 1) * n_v2, b + (l + 1) * n_v2
            face_manifold[_fkey([a0, b0, a1, b1])] = mid
            edge_manifold[_ekey(a0, a1)] = mid
            edge_manifold[_ekey(b0, b1)] = mid

    mesh = Mesh(
        dim=3,
        vertices=verts,
        cells=cells,
        boundary_ids=np.full((len(cells), 6), -1, dtype=np.int32),
        manifolds=dict(mesh2d.manifolds),
        edge_manifold=edge_manifold,
        face_manifold=face_manifold,
        # product-structure metadata for the prism fast path: cell index
        # is layer-major (cells[l*n_c2 + c2d])
        extr_mesh2d=mesh2d,
        extr_cell2d=np.tile(np.arange(n_c2, dtype=np.int64), n_layers),
        extr_layer=np.repeat(np.arange(n_layers, dtype=np.int64), n_c2),
        extr_nz=n_layers,
    )
    mesh.set_boundary_ids(lambda c: np.zeros(len(c), np.int32))
    return mesh


def transform(mesh: Mesh, fn) -> Mesh:
    """Apply a point transformation to all vertices (GridTools::transform)."""
    import dataclasses

    return dataclasses.replace(mesh, vertices=fn(mesh.vertices))
