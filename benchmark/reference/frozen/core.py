"""Frozen copy of ``ns_gls_tpu_torch/mesh/core.py``, taken when the
benchmark was defined, so that the reference works out its geometry
without the program. Changed: imports point at this folder; the vertex
de-duplication uses numpy's ``unique`` in place of the native meshkit
library (same first-occurrence numbering); the parts the reference does
not use are left out.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.frozen.element import cell_edge_vertices, cell_face_vertices


# --------------------------------------------------------------------------
# manifolds
# --------------------------------------------------------------------------
class Manifold:
    """Rule for placing new points from existing ones."""

    def new_point(self, points: np.ndarray, weights: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class FlatManifold(Manifold):
    def new_point(self, points, weights):
        return weights @ points


class PolarManifold(Manifold):
    """2D polar averaging around `center` (deal.II PolarManifold)."""

    def __init__(self, center=(0.0, 0.0)):
        self.center = np.asarray(center, dtype=np.float64)

    def new_point(self, points, weights):
        rel = points - self.center
        r = np.linalg.norm(rel, axis=-1)
        theta = np.arctan2(rel[:, 1], rel[:, 0])
        # unwrap angles around the first point to average on the circle
        theta = theta[0] + np.angle(np.exp(1j * (theta - theta[0])))
        r_new = weights @ r
        t_new = weights @ theta
        return self.center + r_new * np.array([np.cos(t_new), np.sin(t_new)])


class CylindricalManifold(Manifold):
    """Cylindrical averaging around the z-axis through `center`
    (deal.II CylindricalManifold with axis e_z)."""

    def __init__(self, center=(0.0, 0.0, 0.0)):
        self.center = np.asarray(center, dtype=np.float64)
        self.polar = PolarManifold(self.center[:2])

    def new_point(self, points, weights):
        xy = self.polar.new_point(points[:, :2], weights)
        z = weights @ points[:, 2]
        return np.array([xy[0], xy[1], z])


# --------------------------------------------------------------------------
# mesh
# --------------------------------------------------------------------------
def _ekey(a: int, b: int) -> tuple[int, int]:
    return (a, b) if a < b else (b, a)


def _fkey(vs) -> tuple:
    return tuple(sorted(int(v) for v in vs))


def unique_rows(keys: np.ndarray):
    """ids (n,) by first occurrence + count of unique rows."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(-1)], len(first)


@dataclasses.dataclass
class Mesh:
    dim: int
    vertices: np.ndarray                 # (n_v, dim) float64
    cells: np.ndarray                    # (n_c, 2**dim) int64
    boundary_ids: np.ndarray             # (n_c, 2*dim) int32, -1 interior
    manifolds: dict = dataclasses.field(default_factory=dict)
    edge_manifold: dict = dataclasses.field(default_factory=dict)
    face_manifold: dict = dataclasses.field(default_factory=dict)  # 3D only
    level: int = 0                       # refinement generation
    cell_level: np.ndarray = None        # (n_c,) per-cell refinement level
    parent_cell: np.ndarray = None       # (n_c,) parent in previous mesh
    parent_child: np.ndarray = None      # (n_c,) child index, -1 = carried
    # previous generation (the GMG geometric-coarsening chain)
    prev: "Mesh" = dataclasses.field(default=None, repr=False)
    # structured-patch metadata (TPU fast path): per-cell integer lattice
    # coordinates within a logically-Cartesian patch, and the patch's cell
    # counts per axis. Set by structured generators, propagated through
    # *global* refinement, dropped on adaptive refinement/merging.
    lattice: np.ndarray = None           # (n_c, dim) int64 or None
    lattice_shape: tuple = None          # cells per axis or None
    # extrusion metadata (TPU prism fast path, ops/prism.py): a 3D mesh
    # built by ``extrude`` is (2D mesh) x (z lattice); *global* refinement
    # preserves that product structure, so the 2D factor is refined in
    # lockstep and every 3D cell keeps a (2D cell, z layer) address.
    # Dropped on adaptive refinement.  The 2D factor mesh is used purely
    # combinatorially (numbering/patches) — geometry always comes from the
    # 3D mapping.
    extr_mesh2d: "Mesh" = dataclasses.field(default=None, repr=False)
    extr_cell2d: np.ndarray = None       # (n_c,) fine-2D cell of each cell
    extr_layer: np.ndarray = None        # (n_c,) z layer of each cell
    extr_nz: int = 0                     # number of z cell layers

    def __post_init__(self):
        if self.cell_level is None:
            self.cell_level = np.zeros(self.n_cells, dtype=np.int32)

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    # ---- derived topology -------------------------------------------------
    def compute_boundary_faces(self) -> np.ndarray:
        """(n_bf, 2) array of (cell, local_face) on the boundary; a face is
        on the boundary iff its sorted vertex set appears exactly once."""
        fv = np.array(cell_face_vertices(self.dim))
        quads = np.sort(self.cells[:, fv], axis=-1)  # (n_c, 2*dim, nfv)
        flat = quads.reshape(-1, quads.shape[-1])
        _, inv, counts = np.unique(
            flat, axis=0, return_inverse=True, return_counts=True
        )
        is_bdry = counts[inv] == 1
        c, f = np.nonzero(is_bdry.reshape(self.n_cells, 2 * self.dim))
        return np.stack([c, f], axis=1)

    def face_centers(self, bf: np.ndarray) -> np.ndarray:
        fv = np.array(cell_face_vertices(self.dim))
        verts = self.cells[bf[:, 0][:, None], fv[bf[:, 1]]]
        return self.vertices[verts].mean(axis=1)

    def set_boundary_ids(self, id_fn) -> None:
        """Assign boundary ids from a predicate ``id_fn(centers)->ids``
        evaluated at boundary face centers (mirrors the reference's
        position-predicate assignment, ``grid_cylinder.h:106-139``)."""
        bf = self.compute_boundary_faces()
        ids = id_fn(self.face_centers(bf))
        self.boundary_ids = np.full(
            (self.n_cells, 2 * self.dim), -1, dtype=np.int32
        )
        self.boundary_ids[bf[:, 0], bf[:, 1]] = ids

    # ---- geometry helpers ---------------------------------------------
    def cell_min_vertex_distance(self) -> np.ndarray:
        """Per-cell minimum vertex distance (deal.II
        ``minimum_vertex_distance``, used for cell-wise delta,
        reference ``operator_ns.cc:374``)."""
        ev = np.array(cell_edge_vertices(self.dim))
        pairs = self.cells[:, ev]
        d = self.vertices[pairs[..., 0]] - self.vertices[pairs[..., 1]]
        return np.sqrt((d**2).sum(-1)).min(axis=1)

    def minimal_cell_diameter(self) -> float:
        """Smallest cell diameter (deal.II ``minimal_cell_diameter``:
        diameter = largest vertex-pair distance; used for the CFL dt,
        reference ``main.cc:905``)."""
        n_cv = 2**self.dim
        diam2 = np.zeros(self.n_cells)
        for i in range(n_cv):
            for j in range(i + 1, n_cv):
                d = self.vertices[self.cells[:, i]] - self.vertices[self.cells[:, j]]
                diam2 = np.maximum(diam2, (d**2).sum(-1))
        return float(np.sqrt(diam2.min()))

    def _midpoint(self, vids: np.ndarray, manifold_id: int | None) -> np.ndarray:
        pts = self.vertices[vids]
        w = np.full(len(vids), 1.0 / len(vids))
        if manifold_id is not None and manifold_id in self.manifolds:
            return self.manifolds[manifold_id].new_point(pts, w)
        return w @ pts

    # ---- refinement -----------------------------------------------------
    def refine(self, flags: np.ndarray | None = None) -> "Mesh":
        """Refine cells where `flags` is True (default: all). Uniform
        (isotropic) subdivision into 2**dim children; subsets produce
        1-irregular hanging interfaces (flags are 2:1-smoothed first, like
        p4est's balance in ``execute_coarsening_and_refinement``).

        The result carries ``parent_cell``/``parent_child`` maps (child
        index, or -1 for carried cells) for MG transfer construction.
        """
        if flags is None:
            flags = np.ones(self.n_cells, dtype=bool)
        flags = self.smooth_flags(np.asarray(flags, dtype=bool))
        new = self._refine_2d(flags) if self.dim == 2 else self._refine_3d(flags)
        if self.lattice is not None and flags.all():
            # children are x-fastest (child index c: offset_d = (c>>d)&1)
            offs = np.stack(
                [(new.parent_child >> d) & 1 for d in range(self.dim)],
                axis=1,
            )
            new.lattice = 2 * self.lattice[new.parent_cell] + offs
            new.lattice_shape = tuple(2 * n for n in self.lattice_shape)
        if self.extr_mesh2d is not None and flags.all() and self.dim == 3:
            # lockstep-refine the 2D factor and re-address children:
            # 3D child c = cx + 2*cy + 4*cz lives in the (cx, cy) 2D child
            # of the parent's 2D cell, in z layer 2*layer + cz
            m2 = self.extr_mesh2d.refine()
            child2d = np.full((self.extr_mesh2d.n_cells, 4), -1, np.int64)
            child2d[m2.parent_cell, m2.parent_child] = np.arange(m2.n_cells)
            pc, ch = new.parent_cell, new.parent_child
            new.extr_mesh2d = m2
            new.extr_cell2d = child2d[self.extr_cell2d[pc], ch & 3]
            new.extr_layer = 2 * self.extr_layer[pc] + (ch >> 2)
            new.extr_nz = 2 * self.extr_nz
        return new

    def smooth_flags(self, flags: np.ndarray) -> np.ndarray:
        """Expand refinement flags so vertex-adjacent cells never differ by
        more than one level after refinement (2:1 balance, conservative
        vertex-based version of p4est's face balance)."""
        flags = flags.copy()
        if flags.all():
            return flags
        for _ in range(64):
            target = self.cell_level + flags
            vmax = np.full(self.n_vertices, -(10**9), dtype=np.int64)
            np.maximum.at(vmax, self.cells.reshape(-1),
                          np.repeat(target, self.cells.shape[1]))
            cell_max = vmax[self.cells].max(axis=1)
            need = (cell_max - 1) > target
            if not need.any():
                return flags
            flags |= need
        raise RuntimeError("2:1 smoothing did not converge")

    def _dedup_new_vertices(self, new_pts: np.ndarray):
        """Merge new vertex positions with existing ones (hanging vertices
        created earlier from the other side of an interface must resolve
        to the same id).  Returns (vertices, ids_of_new)."""
        
        tol = max(self.cell_min_vertex_distance().min() / 64.0, 1e-12)
        allv = np.vstack([self.vertices, new_pts])
        keys = np.round(allv / tol).astype(np.int64)
        ids, n_unique = unique_rows(keys)
        # first-occurrence numbering keeps existing ids stable
        assert (ids[: self.n_vertices] == np.arange(self.n_vertices)).all()
        first_pos = np.full(n_unique, -1, dtype=np.int64)
        seen = ids[::-1]
        first_pos[seen] = np.arange(len(allv))[::-1]
        vertices = allv[first_pos]
        return vertices, ids[self.n_vertices:]

    def _refine_2d(self, flags) -> "Mesh":
        R = np.nonzero(flags)[0]
        U = np.nonzero(~flags)[0]
        cells_R = self.cells[R]
        ev = np.array(cell_edge_vertices(2))
        pairs = np.sort(cells_R[:, ev], axis=-1).reshape(-1, 2)
        edges, inv = np.unique(pairs, axis=0, return_inverse=True)
        cell_edge = inv.reshape(len(R), 4)
        n_v, n_e, n_r = self.n_vertices, len(edges), len(R)

        # new vertex positions
        new_pts = np.empty((n_e + n_r, 2))
        new_pts[:n_e] = 0.5 * (
            self.vertices[edges[:, 0]] + self.vertices[edges[:, 1]]
        )
        curved_edge_rows = {}
        if self.edge_manifold:
            key2idx = {(int(a), int(b)): i for i, (a, b) in enumerate(edges)}
            for (a, b), mid in self.edge_manifold.items():
                i = key2idx.get((a, b))
                if i is not None:
                    new_pts[i] = self._midpoint(np.array([a, b]), mid)
                    curved_edge_rows[(a, b)] = i
        new_pts[n_e:] = self.vertices[cells_R].mean(axis=1)

        vertices, new_ids = self._dedup_new_vertices(new_pts)
        edge_mid_vid = {
            key: int(new_ids[row]) for key, row in curved_edge_rows.items()
        }

        # parent lattice ids: L[c, i, j] for i,j in 0..2 (x index i)
        L = np.empty((n_r, 3, 3), dtype=np.int64)
        L[:, 0, 0] = cells_R[:, 0]
        L[:, 2, 0] = cells_R[:, 1]
        L[:, 0, 2] = cells_R[:, 2]
        L[:, 2, 2] = cells_R[:, 3]
        # cell_edge order: e0=(0,1) bottom, e1=(2,3) top, e2=(0,2) left,
        # e3=(1,3) right
        L[:, 1, 0] = new_ids[cell_edge[:, 0]]
        L[:, 1, 2] = new_ids[cell_edge[:, 1]]
        L[:, 0, 1] = new_ids[cell_edge[:, 2]]
        L[:, 2, 1] = new_ids[cell_edge[:, 3]]
        L[:, 1, 1] = new_ids[n_e + np.arange(n_r)]

        # children, x fastest: child (cx, cy) index = cx + 2*cy
        cells = np.empty((n_r * 4, 4), dtype=np.int64)
        bids = np.full((n_r * 4, 4), -1, dtype=np.int32)
        for cy in range(2):
            for cx in range(2):
                c = cx + 2 * cy
                cells[c::4] = np.stack(
                    [
                        L[:, cx, cy],
                        L[:, cx + 1, cy],
                        L[:, cx, cy + 1],
                        L[:, cx + 1, cy + 1],
                    ],
                    axis=1,
                )
                if cx == 0:
                    bids[c::4, 0] = self.boundary_ids[R, 0]
                else:
                    bids[c::4, 1] = self.boundary_ids[R, 1]
                if cy == 0:
                    bids[c::4, 2] = self.boundary_ids[R, 2]
                else:
                    bids[c::4, 3] = self.boundary_ids[R, 3]

        # manifold inheritance for curved edges (keep entries of unsplit
        # edges — carried cells may be refined later)
        new_edge_manifold = dict(self.edge_manifold)
        for (a, b), mid in self.edge_manifold.items():
            m = edge_mid_vid.get((a, b))
            if m is None:
                continue
            new_edge_manifold[_ekey(a, m)] = mid
            new_edge_manifold[_ekey(m, b)] = mid

        cells_all = np.vstack([cells, self.cells[U]])
        bids_all = np.vstack([bids, self.boundary_ids[U]])
        levels = np.concatenate(
            [np.repeat(self.cell_level[R] + 1, 4), self.cell_level[U]]
        ).astype(np.int32)
        # cells[c::4] strided writes => row r is parent R[r//4], child r%4
        parent = np.concatenate([np.repeat(R, 4), U]).astype(np.int64)
        pchild = np.concatenate(
            [np.tile(np.arange(4), n_r), -np.ones(len(U))]
        ).astype(np.int64)

        return Mesh(
            dim=2,
            vertices=vertices,
            cells=cells_all,
            boundary_ids=bids_all,
            manifolds=self.manifolds,
            edge_manifold=new_edge_manifold,
            face_manifold={},
            level=self.level + 1,
            cell_level=levels,
            parent_cell=parent,
            parent_child=pchild,
            prev=self,
        )

    def _refine_3d(self, flags) -> "Mesh":
        R = np.nonzero(flags)[0]
        U = np.nonzero(~flags)[0]
        cells_R = self.cells[R]
        n_r = len(R)

        ev = np.array(cell_edge_vertices(3))
        pairs = np.sort(cells_R[:, ev], axis=-1).reshape(-1, 2)
        edges, inv_e = np.unique(pairs, axis=0, return_inverse=True)
        cell_edge = inv_e.reshape(n_r, len(ev))
        fvl = np.array(cell_face_vertices(3))
        quads = np.sort(cells_R[:, fvl], axis=-1).reshape(-1, 4)
        faces, inv_f = np.unique(quads, axis=0, return_inverse=True)
        cell_face = inv_f.reshape(n_r, 6)
        n_v, n_e, n_f = self.n_vertices, len(edges), len(faces)

        new_pts = np.empty((n_e + n_f + n_r, 3))
        new_pts[:n_e] = 0.5 * (
            self.vertices[edges[:, 0]] + self.vertices[edges[:, 1]]
        )
        curved_edge_rows = {}
        if self.edge_manifold:
            key2idx = {(int(a), int(b)): i for i, (a, b) in enumerate(edges)}
            for (a, b), mid in self.edge_manifold.items():
                i = key2idx.get((a, b))
                if i is not None:
                    new_pts[i] = self._midpoint(np.array([a, b]), mid)
                    curved_edge_rows[(a, b)] = i
        new_pts[n_e : n_e + n_f] = self.vertices[faces].mean(axis=1)
        curved_face_rows = {}
        if self.face_manifold:
            fkey2idx = {tuple(int(v) for v in f): i for i, f in enumerate(faces)}
            for key, mid in self.face_manifold.items():
                i = fkey2idx.get(key)
                if i is not None:
                    new_pts[n_e + i] = self._midpoint(np.array(key), mid)
                    curved_face_rows[key] = n_e + i
        new_pts[n_e + n_f :] = self.vertices[cells_R].mean(axis=1)

        vertices, new_ids = self._dedup_new_vertices(new_pts)
        edge_mid_vid = {
            key: int(new_ids[row]) for key, row in curved_edge_rows.items()
        }
        face_mid_vid = {
            key: int(new_ids[row]) for key, row in curved_face_rows.items()
        }

        # parent lattice L[c, i, j, k], i,j,k in 0..2
        L = np.empty((n_r, 3, 3, 3), dtype=np.int64)
        # corners (lexicographic cell vertices, x fastest)
        for vz in range(2):
            for vy in range(2):
                for vx in range(2):
                    v = vx + 2 * vy + 4 * vz
                    L[:, 2 * vx, 2 * vy, 2 * vz] = cells_R[:, v]
        # edges: cell_edge_vertices(3) ordering: dir x: 4 edges (combos of
        # (y,z) x-fastest over others list), then dir y, then dir z.
        for e_idx, (va, vb) in enumerate(cell_edge_vertices(3)):
            # lattice coords of edge midpoint: average of the two vertex
            # lattice coords
            ca = np.array([(va >> 0) & 1, (va >> 1) & 1, (va >> 2) & 1]) * 2
            cb = np.array([(vb >> 0) & 1, (vb >> 1) & 1, (vb >> 2) & 1]) * 2
            cm = (ca + cb) // 2
            L[:, cm[0], cm[1], cm[2]] = new_ids[cell_edge[:, e_idx]]
        # faces
        fv = cell_face_vertices(3)
        for f_idx in range(6):
            vs = fv[f_idx]
            cs = np.array(
                [[(v >> 0) & 1, (v >> 1) & 1, (v >> 2) & 1] for v in vs]
            ) * 2
            cm = cs.mean(axis=0).astype(np.int64)
            L[:, cm[0], cm[1], cm[2]] = new_ids[n_e + cell_face[:, f_idx]]
        # center
        L[:, 1, 1, 1] = new_ids[n_e + n_f + np.arange(n_r)]

        cells = np.empty((n_r * 8, 8), dtype=np.int64)
        bids = np.full((n_r * 8, 6), -1, dtype=np.int32)
        for cz in range(2):
            for cy in range(2):
                for cx in range(2):
                    c = cx + 2 * cy + 4 * cz
                    vs = []
                    for dz in range(2):
                        for dy in range(2):
                            for dx in range(2):
                                vs.append(L[:, cx + dx, cy + dy, cz + dz])
                    cells[c::8] = np.stack(vs, axis=1)
                    offs = (cx, cy, cz)
                    for d in range(3):
                        side = offs[d]
                        bids[c::8, 2 * d + side] = self.boundary_ids[
                            R, 2 * d + side
                        ]

        # manifold inheritance (keep unsplit entries for later passes)
        new_edge_manifold = dict(self.edge_manifold)
        for (a, b), mid in self.edge_manifold.items():
            m = edge_mid_vid.get((a, b))
            if m is None:
                continue
            new_edge_manifold[_ekey(a, m)] = mid
            new_edge_manifold[_ekey(m, b)] = mid
        new_face_manifold = dict(self.face_manifold)
        for key, mid in self.face_manifold.items():
            fm = face_mid_vid.get(key)
            if fm is None:
                continue
            # the face's 4 corner vertices are key (sorted); its edges:
            # find the 4 edges of this face that are in edge_manifold...
            # child subfaces: corner, two adjacent edge mids, face mid.
            # Rebuild from the edge midpoint dict:
            k = list(key)
            # find edge pairs among the 4 corners that have midpoints
            mids = {}
            for i in range(4):
                for j in range(i + 1, 4):
                    e = _ekey(k[i], k[j])
                    if e in edge_mid_vid:
                        mids[(i, j)] = edge_mid_vid[e]
            if len(mids) != 4:
                # face had fewer than 4 registered edges; skip children
                continue
            # new edges: edge mid -> face mid
            for em in mids.values():
                new_edge_manifold[_ekey(em, fm)] = mid
            # child faces: corner i + its two incident edge mids + face mid
            incident = {i: [m for (a, b), m in mids.items() if i in (a, b)]
                        for i in range(4)}
            for i in range(4):
                if len(incident[i]) == 2:
                    new_face_manifold[
                        _fkey([k[i], incident[i][0], incident[i][1], fm])
                    ] = mid

        cells_all = np.vstack([cells, self.cells[U]])
        bids_all = np.vstack([bids, self.boundary_ids[U]])
        levels = np.concatenate(
            [np.repeat(self.cell_level[R] + 1, 8), self.cell_level[U]]
        ).astype(np.int32)
        parent = np.concatenate([np.repeat(R, 8), U]).astype(np.int64)
        pchild = np.concatenate(
            [np.tile(np.arange(8), n_r), -np.ones(len(U))]
        ).astype(np.int64)

        return Mesh(
            dim=3,
            vertices=vertices,
            cells=cells_all,
            boundary_ids=bids_all,
            manifolds=self.manifolds,
            edge_manifold=new_edge_manifold,
            face_manifold=new_face_manifold,
            level=self.level + 1,
            cell_level=levels,
            parent_cell=parent,
            parent_child=pchild,
            prev=self,
        )

    def refine_global(self, n: int) -> "Mesh":
        m = self
        for _ in range(n):
            m = m.refine()
        return m

    # ---- Morton / SFC ordering ------------------------------------------