"""Frozen copy of the parts of ``ns_gls_tpu_torch/fem/space.py`` that the
reference needs (the curved mapping, boundary faces and nodes), taken
when the benchmark was defined.  Changed: the node numbering is the
general first-occurrence one (no kernel layouts), the vertex
de-duplication numpy's, and the rest of ``FESpace`` is left out.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.frozen.core import Mesh, _fkey, unique_rows
from benchmark.reference.frozen.element import Element, tabulate_at


def _lattice_coords(n1: int, dim: int) -> np.ndarray:
    """Integer lattice multi-indices, x fastest: (n1**dim, dim)."""
    idx = np.arange(n1**dim)
    out = np.empty((n1**dim, dim), dtype=np.int64)
    rem = idx.copy()
    for d in range(dim):
        out[:, d] = rem % n1
        rem //= n1
    return out


def _q1_shape(ref_pts: np.ndarray) -> np.ndarray:
    """Multilinear (Q1) shape values at reference points: (n_pts, 2**dim)."""
    n_pts, dim = ref_pts.shape
    S = np.ones((n_pts, 2**dim))
    for v in range(2**dim):
        for d in range(dim):
            t = ref_pts[:, d]
            S[:, v] *= t if (v >> d) & 1 else (1.0 - t)
    return S


class _MappingBuilder:
    """Builds per-cell mapping support points of degree m, honoring
    edge/face manifolds and filling interiors by transfinite blending."""

    def __init__(self, mesh: Mesh, m: int):
        self.mesh = mesh
        self.m = m
        self.dim = mesh.dim
        from benchmark.reference.frozen.lagrange import gauss_lobatto_points_1d

        self.t = gauss_lobatto_points_1d(m + 1)  # 1D lattice positions
        self.lat = _lattice_coords(m + 1, self.dim)
        self.ref = self.t[self.lat]  # (n_lat, dim) reference coords

    def build(self) -> np.ndarray:
        """Returns (n_c, (m+1)**dim, dim) support point coordinates."""
        mesh, m, dim = self.mesh, self.m, self.dim
        # base: multilinear interpolation of cell vertices (exact for
        # straight cells)
        S = _q1_shape(self.ref)  # (n_lat, 2**dim)
        pts = np.einsum("li,cid->cld", S, mesh.vertices[mesh.cells])

        if m == 1 or not mesh.edge_manifold:
            return pts

        # fix up curved cells
        curved_cells = self._curved_cells()
        for c in curved_cells:
            pts[c] = self._build_cell(c)
        return pts

    def _curved_cells(self) -> np.ndarray:
        from benchmark.reference.frozen.element import cell_edge_vertices

        ev = np.array(cell_edge_vertices(self.dim))
        pairs = np.sort(self.mesh.cells[:, ev], axis=-1)  # (n_c, n_e, 2)
        keys = set(self.mesh.edge_manifold.keys())
        out = []
        for c in range(self.mesh.n_cells):
            for a, b in pairs[c]:
                if (int(a), int(b)) in keys:
                    out.append(c)
                    break
        return np.array(out, dtype=np.int64)

    def _edge_points(self, va: int, vb: int) -> np.ndarray:
        """Points along the edge va->vb at the 1D lattice positions
        (canonical: computed with endpoints sorted by id, then oriented)."""
        mesh = self.mesh
        a, b = (va, vb) if va < vb else (vb, va)
        mid = mesh.edge_manifold.get((a, b))
        pa, pb = mesh.vertices[a], mesh.vertices[b]
        pts = np.empty((self.m + 1, len(pa)))
        for i, t in enumerate(self.t):
            if mid is not None and mid in mesh.manifolds:
                pts[i] = mesh.manifolds[mid].new_point(
                    np.stack([pa, pb]), np.array([1.0 - t, t])
                )
            else:
                pts[i] = (1.0 - t) * pa + t * pb
        if va > vb:
            pts = pts[::-1]
        return pts

    def _face_points(self, verts4: np.ndarray) -> np.ndarray:
        """(3D) points of a quad face given its 4 lexicographic vertex ids:
        edges by manifold/linear, interior by Coons patch or face manifold.
        Returns ((m+1)**2, dim) lattice, x fastest in face coords."""
        mesh, m = self.mesh, self.m
        v00, v10, v01, v11 = (int(v) for v in verts4)
        mid = mesh.face_manifold.get(_fkey(verts4))
        # edge lattices
        e_b = self._edge_points(v00, v10)  # y=0
        e_t = self._edge_points(v01, v11)  # y=1
        e_l = self._edge_points(v00, v01)  # x=0
        e_r = self._edge_points(v10, v11)  # x=1
        P = np.empty((m + 1, m + 1, mesh.vertices.shape[1]))
        P[:, 0] = e_b
        P[:, m] = e_t
        P[0, :] = e_l
        P[m, :] = e_r
        c00, c10 = mesh.vertices[v00], mesh.vertices[v10]
        c01, c11 = mesh.vertices[v01], mesh.vertices[v11]
        for i in range(1, m):
            u = self.t[i]
            for j in range(1, m):
                v = self.t[j]
                if mid is not None and mid in mesh.manifolds:
                    w = np.array(
                        [(1 - u) * (1 - v), u * (1 - v), (1 - u) * v, u * v]
                    )
                    P[i, j] = mesh.manifolds[mid].new_point(
                        np.stack([c00, c10, c01, c11]), w
                    )
                else:  # Coons
                    P[i, j] = (
                        (1 - v) * e_b[i]
                        + v * e_t[i]
                        + (1 - u) * e_l[j]
                        + u * e_r[j]
                        - ((1 - u) * (1 - v) * c00 + u * (1 - v) * c10
                           + (1 - u) * v * c01 + u * v * c11)
                    )
        return P

    def _build_cell(self, c: int) -> np.ndarray:
        mesh, m, dim = self.mesh, self.m, self.dim
        cv = mesh.cells[c]
        n1 = m + 1
        if dim == 2:
            P = self._face_points(cv)  # (n1, n1, 2) indexed [ix, iy]
            out = np.empty((n1 * n1, 2))
            for j in range(n1):
                for i in range(n1):
                    out[i + n1 * j] = P[i, j]
            return out
        # 3D: edges -> faces -> interior transfinite
        from benchmark.reference.frozen.element import cell_face_vertices

        P = np.empty((n1, n1, n1, 3))
        fv = cell_face_vertices(3)
        # fill the 6 faces (their edges included)
        for f in range(6):
            fdir, fside = f // 2, f % 2
            quad = self._face_points(cv[fv[f]])  # ((n1,n1) face lattice)
            free = [d for d in range(3) if d != fdir]
            fixed = 0 if fside == 0 else m
            for j in range(n1):
                for i in range(n1):
                    idx = [0, 0, 0]
                    idx[fdir] = fixed
                    idx[free[0]] = i
                    idx[free[1]] = j
                    P[tuple(idx)] = quad[i, j]
        # interior: trilinear transfinite from faces, edges, corners
        corners = mesh.vertices[cv]
        for kk in range(1, m):
            w_ = self.t[kk]
            for j in range(1, m):
                v = self.t[j]
                for i in range(1, m):
                    u = self.t[i]
                    t3 = (u, v, w_)
                    # face contributions
                    val = np.zeros(3)
                    val += (1 - u) * P[0, j, kk] + u * P[m, j, kk]
                    val += (1 - v) * P[i, 0, kk] + v * P[i, m, kk]
                    val += (1 - w_) * P[i, j, 0] + w_ * P[i, j, m]
                    # edge corrections (subtract double-counted edges)
                    for d0 in range(3):
                        for d1 in range(d0 + 1, 3):
                            for s0 in (0, 1):
                                for s1 in (0, 1):
                                    idx = [i, j, kk]
                                    wgt = 1.0
                                    idx[d0] = s0 * m
                                    wgt *= t3[d0] if s0 else (1 - t3[d0])
                                    idx[d1] = s1 * m
                                    wgt *= t3[d1] if s1 else (1 - t3[d1])
                                    val -= wgt * P[tuple(idx)]
                    # corner additions
                    for vtx in range(8):
                        wgt = 1.0
                        for d in range(3):
                            s = (vtx >> d) & 1
                            wgt *= t3[d] if s else (1 - t3[d])
                        val += wgt * corners[vtx]
                    P[i, j, kk] = val
        out = np.empty((n1**3, 3))
        for kk in range(n1):
            for j in range(n1):
                for i in range(n1):
                    out[i + n1 * (j + n1 * kk)] = P[i, j, kk]
        return out


@dataclasses.dataclass
class FaceBatch:
    """A batch of boundary faces sharing the same local face index."""

    local_face: int
    cells: np.ndarray        # (n_bf,)
    boundary_id: np.ndarray  # (n_bf,)
    jxw: np.ndarray          # (n_bf, n_fq)
    normals: np.ndarray      # (n_bf, n_fq, dim) outward unit normals
    q_points: np.ndarray     # (n_bf, n_fq, dim) physical coordinates
    jinv: np.ndarray         # (n_bf, n_fq, dim, dim) dxi_r/dx_x at face q-pts


class Space:
    """The vector-valued (dim + 1 components) Q_k space of a mesh: nodes
    numbered by first occurrence on their Q1-lattice positions, placed by
    the isoparametric mapping; volume and boundary-face geometry at the
    Gauss points.  The parts of the program's ``FESpace`` that the
    reference needs, without its kernel numberings."""

    def __init__(self, mesh: Mesh, degree: int, mapping_degree: int):
        self.mesh = mesh
        self.dim = dim = mesh.dim
        self.degree = degree
        self.mapping_degree = mapping_degree
        self.n_q1d = degree + 1
        self.element = el = Element(dim, degree, self.n_q1d)
        self.map_points = _MappingBuilder(mesh, mapping_degree).build()
        S1 = _q1_shape(el.support_points)
        q1_pos = np.einsum("li,cid->cld", S1, mesh.vertices[mesh.cells])
        tol = max(mesh.cell_min_vertex_distance().min() / 64.0, 1e-12)
        key = np.round(q1_pos.reshape(-1, dim) / tol).astype(np.int64)
        ids, self.n_nodes = unique_rows(key)
        self.cell_nodes = ids.reshape(mesh.n_cells, el.n_loc)
        Sm, _ = tabulate_at(mapping_degree, dim, el.support_points)
        pos = np.einsum("li,cid->cld", Sm, self.map_points)
        node_pos = np.zeros((self.n_nodes, dim))
        flat = self.cell_nodes.reshape(-1)
        node_pos[flat[::-1]] = pos.reshape(-1, dim)[::-1]
        self.node_pos = node_pos
        _, Dmq = tabulate_at(mapping_degree, dim, el.q_points)
        J = np.einsum("qir,cix->cqxr", Dmq, self.map_points)
        detJ = np.linalg.det(J)
        if (detJ <= 0).any():
            raise ValueError("non-positive Jacobian")
        self.jinv = np.linalg.inv(J)
        self.jxw = detJ * el.q_weights[None, :]
        self.cell_h_min_vertex = mesh.cell_min_vertex_distance()
        self.cell_measure = self.jxw.sum(axis=1)
        self.face_batches = self.build_face_batches(self.n_q1d)

    def build_face_batches(self, n_q1d: int, boundary_ids=None) -> list:
        """Boundary-face batches with an n_q1d-per-direction Gauss rule,
        optionally restricted to given boundary ids (the postprocess
        functionals use their own fixed rule, like the reference's
        ``QGauss<dim-1>(3)``, ``simulation.cc:451``)."""
        mesh, dim = self.mesh, self.dim
        el = Element(dim, self.degree, n_q1d)
        # stored ids, not topology: on adaptive meshes hanging interfaces
        # also look "unmatched" topologically but are not boundaries
        c, f = np.nonzero(mesh.boundary_ids >= 0)
        bf = np.stack([c, f], axis=1)
        bids = mesh.boundary_ids[bf[:, 0], bf[:, 1]]
        if boundary_ids is not None:
            keep = np.isin(bids, list(boundary_ids))
            bf, bids = bf[keep], bids[keep]
        out: list[FaceBatch] = []
        for f in range(2 * dim):
            sel = bf[:, 1] == f
            if not sel.any():
                continue
            cells_f = bf[sel, 0]
            fqp = el.face_q_points(f)  # (n_fq, dim) reference coords
            Sf, Df = tabulate_at(self.mapping_degree, dim, fqp)
            X = self.map_points[cells_f]  # (n_bf, n_map_loc, dim)
            Jf = np.einsum("qir,cix->cqxr", Df, X)
            detJf = np.linalg.det(Jf)
            Jinv_f = np.linalg.inv(Jf)  # (c,q,r,x)
            fdir = f // 2
            sign = el.face_normal_sign(f)
            # n ∝ sign * J^{-T} e_fdir ; dS = |det J| |J^{-T} e_fdir| ds
            g = sign * Jinv_f[:, :, fdir, :]  # (c, q, x)
            gn = np.linalg.norm(g, axis=-1)
            normals = g / gn[..., None]
            jxw_f = detJf * gn * el.face_q_weights[None, :]
            q_phys = np.einsum("qi,cix->cqx", Sf, X)
            out.append(
                FaceBatch(
                    local_face=f,
                    cells=cells_f.astype(np.int32),
                    boundary_id=bids[sel].astype(np.int32),
                    jxw=jxw_f,
                    normals=normals,
                    q_points=q_phys,
                    jinv=Jinv_f,
                )
            )
        return out

    # ------------------------------------------------------------------

    def face_node_lattice(self, local_face: int) -> np.ndarray:
        """Local node indices (into n_loc) lying on a local face."""
        n1 = self.degree + 1
        lat = _lattice_coords(n1, self.dim)
        fdir, fside = local_face // 2, local_face % 2
        want = 0 if fside == 0 else n1 - 1
        return np.nonzero(lat[:, fdir] == want)[0]

    def boundary_nodes(self, boundary_ids) -> np.ndarray:
        """Global node ids on any of the given boundary ids."""
        ids = set(int(b) for b in np.atleast_1d(boundary_ids))
        out = []
        for fb in self.face_batches:
            sel = np.isin(fb.boundary_id, list(ids))
            if not sel.any():
                continue
            loc = self.face_node_lattice(fb.local_face)
            out.append(self.cell_nodes[fb.cells[sel]][:, loc].reshape(-1))
        if not out:
            return np.zeros(0, dtype=np.int32)
        return np.unique(np.concatenate(out))
