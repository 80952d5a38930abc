"""Frozen copy of ``ns_gls_tpu_torch/mesh/gmsh.py``, taken when the sphere
deployment was added to the benchmark, so that the reference reads the
Gmsh mesh without the program.  Changed: imports point at this folder.

Gmsh 4.1 (ASCII) mesh reader for hex meshes, the ``GridIn::read_msh``
path the reference uses to import ``mesh/sphere.msh``
(``simulation.cc:864-872``): reads $Entities (for physical tags),
$Nodes, $Elements; boundary ids of hex faces come from the physical tag
of the boundary quad's surface entity.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.frozen.core import Mesh
from benchmark.reference.frozen.element import cell_face_vertices

# gmsh -> lexicographic vertex permutations
_HEX_PERM = [0, 1, 3, 2, 4, 5, 7, 6]


def read_msh(file_name: str) -> Mesh:
    with open(file_name) as f:
        lines = f.read().split("\n")

    def section(name):
        i = lines.index(f"${name}")
        j = lines.index(f"$End{name}")
        return i + 1, j

    # ---- entities: physical tags per (dim, entity tag) -------------------
    i, _ = section("Entities")
    n_pts, n_curves, n_surf, n_vol = map(int, lines[i].split())
    i += 1 + n_pts + n_curves
    surf_phys: dict[int, int] = {}
    for _ in range(n_surf):
        parts = lines[i].split()
        i += 1
        tag = int(parts[0])
        n_phys = int(parts[7])
        if n_phys > 0:
            surf_phys[tag] = int(parts[8])

    # ---- nodes ------------------------------------------------------------
    i, end = section("Nodes")
    n_blocks, n_nodes, min_tag, max_tag = map(int, lines[i].split())
    i += 1
    coords = np.zeros((max_tag + 1, 3))
    for _ in range(n_blocks):
        _, _, _, n_in = map(int, lines[i].split())
        i += 1
        tags = [int(lines[i + k]) for k in range(n_in)]
        i += n_in
        for k in range(n_in):
            coords[tags[k]] = [float(x) for x in lines[i + k].split()[:3]]
        i += n_in

    # ---- elements ----------------------------------------------------------
    i, end = section("Elements")
    n_blocks = int(lines[i].split()[0])
    i += 1
    hexes = []
    quads = []  # (verts, physical tag)
    for _ in range(n_blocks):
        edim, etag, etype, n_in = map(int, lines[i].split())
        i += 1
        for k in range(n_in):
            parts = [int(x) for x in lines[i + k].split()]
            verts = parts[1:]
            if etype == 5:  # 8-node hexahedron
                hexes.append([verts[p] for p in _HEX_PERM])
            elif etype == 3 and edim == 2:  # 4-node quad (boundary)
                bid = surf_phys.get(etag)
                if bid is not None:
                    quads.append((sorted(verts), bid))
        i += n_in

    hexes = np.asarray(hexes, dtype=np.int64)
    # compact node numbering
    used = np.unique(hexes)
    remap = np.full(coords.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    cells = remap[hexes]
    verts = coords[used]

    # fix inverted cells (negative trilinear Jacobian at center)
    v = verts[cells]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    e3 = v[:, 4] - v[:, 0]
    det = np.einsum("ci,ci->c", np.cross(e1, e2), e3)
    flip = det < 0
    if flip.any():
        # mirror in z: swap bottom and top layers
        cells[flip] = cells[flip][:, [4, 5, 6, 7, 0, 1, 2, 3]]

    mesh = Mesh(
        dim=3,
        vertices=verts,
        cells=cells,
        boundary_ids=np.full((len(cells), 6), -1, dtype=np.int32),
    )
    # assign boundary ids from physical quads
    bf = mesh.compute_boundary_faces()
    fv = np.array(cell_face_vertices(3))
    face_verts = np.sort(mesh.cells[bf[:, 0][:, None], fv[bf[:, 1]]], axis=-1)
    quad_map = {}
    for verts_q, bid in quads:
        key = tuple(int(remap[v]) for v in verts_q)
        quad_map[tuple(sorted(key))] = bid
    ids = np.zeros(len(bf), dtype=np.int32)
    for k in range(len(bf)):
        ids[k] = quad_map.get(tuple(face_verts[k]), 0)
    mesh.boundary_ids[bf[:, 0], bf[:, 1]] = ids
    return mesh
