"""Finite element space: global node numbering, curved mappings, geometry
factors, boundary-face batches (host precompute, numpy).

This packages a :class:`~ns_gls_tpu_torch.mesh.core.Mesh` + Q_k element into the
*padded SoA element batches* the device kernels consume (SURVEY §7):

- ``cell_nodes``  (n_c, n_loc): gather map into the global node vector,
- ``jinv``        (n_c, n_q, dim, dim): inverse Jacobians  (dxi_r/dx_x),
- ``jxw``         (n_c, n_q): |det J| * quadrature weight,
- boundary-face batches with normals and face JxW.

Only values+gradients geometry is precomputed, exactly the update flags the
reference requests (``operator_ns.cc:112``).  The mapping is an isoparametric
MappingQ(m): per-cell degree-m support-point lattices, with points on curved
manifolds placed by the manifold and cell interiors filled by transfinite
(Coons) blending — the behavior of deal.II's ``MappingQ`` on meshes with
boundary manifolds (``main.cc:253-256``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ns_gls_tpu_torch.fem.element import Element, tabulate_at
from ns_gls_tpu_torch.mesh.core import Mesh, _fkey


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
        from ns_gls_tpu_torch.fem.lagrange import gauss_lobatto_points_1d

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
        from ns_gls_tpu_torch.fem.element import cell_edge_vertices

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
        from ns_gls_tpu_torch.fem.element import cell_face_vertices

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


class FESpace:
    """Vector-valued (dim+1 components) equal-order Q_k space on a Mesh."""

    def __init__(self, mesh: Mesh, degree: int, mapping_degree: int | None = None,
                 n_q1d: int | None = None, iso_q1: bool = False):
        from ns_gls_tpu_torch.fem.element import IsoQ1Element

        self.mesh = mesh
        self.dim = mesh.dim
        self.degree = degree
        self.mapping_degree = mapping_degree or degree
        self.n_q1d = n_q1d or (degree + 1)
        self.iso_q1 = iso_q1
        el_cls = IsoQ1Element if iso_q1 else Element
        self.element = el_cls(self.dim, degree, self.n_q1d)
        self.map_element = Element(self.dim, self.mapping_degree, self.n_q1d)
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        mesh, dim = self.mesh, self.dim
        el, mel = self.element, self.map_element

        # 1) mapping support points
        self.map_points = _MappingBuilder(mesh, self.mapping_degree).build()

        # 2) global node numbering
        from ns_gls_tpu_torch.utils import native

        self.structured = (
            mesh.lattice is not None and not self.iso_q1
        )
        self.prism = (
            not self.structured
            and not self.iso_q1
            and mesh.dim == 3
            and mesh.extr_mesh2d is not None
        )
        # patch-lattice numbering for general 2D meshes (ops/patch2d.py):
        # any 2D quad mesh decomposes into per-coarse-cell refinement
        # patches (single-cell patches when never refined) — the 2D
        # analogue of the prism fast path's 2D-factor treatment
        self.patch2d = False
        self.patch3d = False
        import os

        if (
            not self.structured
            and not self.prism
            and not self.iso_q1
            and mesh.dim == 2
            and os.environ.get("NS_PATCH2D", "1") != "0"
        ):
            self.patch2d = self._build_patch2d_numbering()
        if (
            not self.structured
            and not self.prism
            and not self.iso_q1
            and mesh.dim == 3
            and os.environ.get("NS_PATCH3D", "1") != "0"
        ):
            self.patch3d = self._build_patch3d_numbering()
        if self.prism:
            self._build_prism_numbering()
        elif self.patch2d or self.patch3d:
            pass                      # numbering already built
        elif self.structured:
            # structured patch: nodes ARE a lattice. The numbering is the
            # TPU fast path's storage layout (ops/structured.py): x is the
            # innermost (lane) axis, and the y/z lattice coordinates are
            # grouped by their residue class mod degree ("parity classes":
            # classes 1..P-1 of n entries, then class 0 of n+1 entries).
            # With class-grouped rows, the sum-factorized unfold becomes
            # static CONTIGUOUS slices and the fold becomes concats — no
            # strided accesses anywhere in the kernel.
            p = self.degree
            self.cell_shape = tuple(mesh.lattice_shape)
            self.node_shape = tuple(p * n + 1 for n in self.cell_shape)
            loc = np.asarray(
                np.round(el.support_points * p), dtype=np.int64
            )  # (n_loc, dim) integer offsets, x fastest
            coords = p * mesh.lattice[:, None, :] + loc[None, :, :]

            def class_rank(i, n):
                """lattice index (0..p*n) -> class-grouped rank."""
                k = i % p
                e = i // p
                off = np.where(k >= 1, (k - 1) * n, (p - 1) * n)
                return off + e

            ids = coords[..., 0].copy()  # x natural
            mult = self.node_shape[0]
            for d in range(1, dim):
                n_d = self.cell_shape[d]
                ids += class_rank(coords[..., d], n_d) * mult
                mult *= self.node_shape[d]
            self.cell_nodes = ids.astype(np.int32)
            self.n_nodes = int(np.prod(self.node_shape))
        else:
            # general unstructured: dedup on Q1-lattice positions
            S1 = _q1_shape(el.support_points)  # (n_loc, 2**dim)
            q1_pos = np.einsum("li,cid->cld", S1, mesh.vertices[mesh.cells])
            tol = max(mesh.cell_min_vertex_distance().min() / 64.0, 1e-12)
            key = np.round(q1_pos.reshape(-1, dim) / tol).astype(np.int64)
            ids, n_unique = native.unique_rows(key)
            self.cell_nodes = ids.reshape(
                mesh.n_cells, el.n_loc
            ).astype(np.int32)
            self.n_nodes = n_unique

        # 3) true node positions (isoparametric): evaluate the mapping at
        # the FE support points; first-writer wins for shared nodes
        Sm, _ = tabulate_at(self.mapping_degree, dim, el.support_points)
        pos = np.einsum("li,cid->cld", Sm, self.map_points)
        node_pos = np.zeros((self.n_nodes, dim))
        # reversed so that the *first* cell's value ends up stored
        flat_nodes = self.cell_nodes.reshape(-1)
        node_pos[flat_nodes[::-1]] = pos.reshape(-1, dim)[::-1]
        self.node_pos = node_pos

        # 4) volume geometry factors
        Smq, Dmq = tabulate_at(self.mapping_degree, dim, el.q_points)
        # J[c,q,x,r] = sum_i Dmq[q,i,r] X[c,i,x]
        J = np.einsum("qir,cix->cqxr", Dmq, self.map_points)
        detJ = np.linalg.det(J)
        if (detJ <= 0).any():
            bad = np.argwhere(detJ <= 0)
            raise ValueError(f"non-positive Jacobian at {bad[:5]}")
        self.jinv = np.linalg.inv(J)  # (c,q,r,x) = dxi_r/dx_x
        self.jxw = detJ * el.q_weights[None, :]
        self.q_phys = np.einsum("qi,cix->cqx", Smq, self.map_points)

        # 5) cell sizes for stabilization
        self.cell_h_min_vertex = mesh.cell_min_vertex_distance()
        self.cell_measure = self.jxw.sum(axis=1)

        # 6) boundary-face batches grouped by local face index
        self.face_batches: list[FaceBatch] = self.build_face_batches(self.n_q1d)

        # 7) transpose gather map (replaces scatter-add in the hot sweep:
        # scatters serialize on TPU, gathers vectorize — SURVEY §7 "hard
        # parts" #1).  Nodes are RENUMBERED by contribution count so each
        # count-class gets a dense (n_class, K_class) gather table with no
        # padding waste (XLA TPU gathers cost ~constant per row).
        self.node_gather_perm = None
        if self.structured or self.prism:
            # lattice/product numbering must be preserved (it IS the
            # fast path's gather); the general sweep on these spaces falls
            # back to scatter-add, which only tests/CPU paths use
            self.node_gather_classes = []
            return
        if self.patch2d or self.patch3d:
            # patch numbering must be preserved too, but the general
            # sweep on patch spaces is the production CPU path (the
            # Pallas kernels are TPU programs), and f32 scatter-add
            # summation noise measurably degrades Newton there (the
            # adaptive rotation config stalled at 3.6e-5 vs an absolute
            # 1e-6 tolerance).  Build the count-class gather tables over
            # a count-sorted node ORDER and keep a final permutation
            # back to the patch numbering instead of relabeling.
            counts, order = native.transpose_map(self.cell_nodes,
                                                 self.n_nodes)
            perm = np.argsort(counts, kind="stable")   # count-sorted order
            starts = np.concatenate([[0], np.cumsum(counts)])
            flat_sz = self.cell_nodes.size
            self.node_gather_classes = []
            sc = counts[perm]
            n0 = 0
            while n0 < self.n_nodes:
                K = int(sc[n0])
                n1 = int(np.searchsorted(sc, K, side="right"))
                idx = np.empty((n1 - n0, max(K, 1)), dtype=np.int32)
                if K == 0:
                    idx[:] = flat_sz          # unused: gather the zero pad
                else:
                    for k in range(K):
                        idx[:, k] = order[starts[perm[n0:n1]] + k]
                self.node_gather_classes.append((n0, max(K, 1), idx))
                n0 = n1
            inv = np.empty(self.n_nodes, dtype=np.int32)
            inv[perm] = np.arange(self.n_nodes, dtype=np.int32)
            # concat(classes) yields count-sorted order; node i's value
            # sits at position inv[i]
            self.node_gather_perm = inv
            return
        counts, _ = native.transpose_map(self.cell_nodes, self.n_nodes)
        perm = np.argsort(counts, kind="stable")      # old -> sorted order
        relabel = np.empty(self.n_nodes, dtype=np.int64)
        relabel[perm] = np.arange(self.n_nodes)
        self.cell_nodes = relabel[self.cell_nodes].astype(np.int32)
        self.node_pos = self.node_pos[perm]
        counts = counts[perm]

        flat = self.cell_nodes.reshape(-1).astype(np.int64)
        _, order = native.transpose_map(self.cell_nodes, self.n_nodes)
        starts = np.concatenate([[0], np.cumsum(counts)])
        self.node_gather_classes = []  # (start_node, K, idx (n_class, K))
        n0 = 0
        while n0 < self.n_nodes:
            K = int(counts[n0])
            n1 = int(np.searchsorted(counts, K, side="right"))
            idx = np.empty((n1 - n0, max(K, 1)), dtype=np.int32)
            if K == 0:
                idx[:] = flat.size  # unused nodes: gather the zero pad row
            else:
                for k in range(K):
                    idx[:, k] = order[starts[n0:n1] + k]
            self.node_gather_classes.append((n0, max(K, 1), idx))
            n0 = n1

    def _uniform_blocks(self):
        """Maximal uniform-refinement block decomposition of the final
        mesh's cells over its stored generation chain: per final cell a
        (block, lat) assignment, per block a size m (cells per axis) —
        (2^k)^dim blocks of equal-depth siblings, down to single-cell
        blocks where depths mix.  On a globally refined mesh this is one
        full-chain block per coarse cell; on adaptively refined meshes
        (the refine-in-wake workflow, ``simulation.cc:317-326``) it
        yields the per-level patch families that keep a Pallas path.

        Returns ``(block_of_cell, m_of_block, lat_of_cell)`` with block
        ids compacted to ``0..n_blocks-1``; ``lat_of_cell`` is the cell's
        integer lattice position inside its block."""
        mesh = self.mesh
        dim = mesh.dim
        n = mesh.n_cells
        chain = []
        cur = mesh
        while cur.prev is not None and cur.parent_cell is not None:
            chain.append(cur)
            cur = cur.prev
        block_of_cell = np.arange(n, dtype=np.int64)
        lat = np.zeros((n, dim), np.int64)
        root = np.arange(n, dtype=np.int64)   # block -> cell id @ cur gen
        m = np.ones(n, np.int64)              # block -> cells per axis
        frozen = np.zeros(n, bool)            # block cannot merge further
        alive = np.ones(n, bool)
        # cap block size so the kernels' K = G*(P*m+1) <= 128 band cap
        # always admits G >= 1 (deeply refined uniform meshes split into
        # sub-patches instead of losing the fast path)
        m_cap = 1
        while self.degree * (2 * m_cap) + 1 <= 128:
            m_cap *= 2
        for gen in chain:                     # fine -> coarse
            pc = np.asarray(gen.parent_cell, np.int64)
            ch = np.asarray(gen.parent_child, np.int64)
            act = np.nonzero(alive & ~frozen)[0]
            r = root[act]
            ref_mask = ch[r] >= 0
            car = act[~ref_mask]
            root[car] = pc[r[~ref_mask]]      # carried cells ride along
            rb = act[ref_mask]
            if rb.size == 0:
                continue
            rp = pc[r[ref_mask]]              # parent cell per block
            rc = ch[r[ref_mask]]              # child slot per block
            rm = m[rb]
            n_prev = int(pc.max()) + 1
            cnt = np.bincount(rp, minlength=n_prev)
            mmin = np.full(n_prev, np.iinfo(np.int64).max)
            mmax = np.zeros(n_prev, np.int64)
            np.minimum.at(mmin, rp, rm)
            np.maximum.at(mmax, rp, rm)
            ok = (cnt == (1 << dim)) & (mmin == mmax) & (mmax < m_cap)
            okb = ok[rp]
            frozen[rb[~okb]] = True
            mb = rb[okb]
            if mb.size == 0:
                continue
            mp, mc, mm = rp[okb], rc[okb], m[mb]
            # survivor block per merging parent: the child-slot-0 block
            surv = np.full(n_prev, -1, np.int64)
            surv[mp[mc == 0]] = mb[mc == 0]
            blk_new = np.arange(n, dtype=np.int64)
            blk_new[mb] = surv[mp]
            blk_off = np.zeros((n, dim), np.int64)
            blk_off[mb] = (
                np.stack([(mc >> a) & 1 for a in range(dim)], axis=1)
                * mm[:, None]
            )
            lat += blk_off[block_of_cell]
            block_of_cell = blk_new[block_of_cell]
            sv = surv[mp[mc == 0]]
            root[sv] = mp[mc == 0]
            m[sv] = 2 * m[sv]
            alive[mb[mc != 0]] = False
        # compact to 0..n_blocks-1
        uniq, block_of_cell = np.unique(block_of_cell,
                                        return_inverse=True)
        return block_of_cell, m[uniq], lat

    def _build_patch2d_numbering(self) -> bool:
        """Patch-lattice numbering for general 2D meshes (the pure-2D
        analogue of ``_build_prism_numbering``'s 2D factor): cells group
        into maximal uniform refinement patches — (2^r)^2 lattices on
        globally refined multiblock meshes (Turek 2D,
        ``grid_cylinder.h:7-151``), single-cell patches on meshes without
        a refinement chain (Gmsh imports), and per-size patch FAMILIES on
        adaptively refined meshes (refine-in-wake,
        ``simulation.cc:317-326`` + ``operator_ns.cc:949-1182``: the
        reference's cell loop is fast on locally refined meshes too).
        Nodes are relabeled sorted by total patch multiplicity so the
        kernel's seam-compress gather classes are dense."""
        from ns_gls_tpu_torch.utils import native

        mesh, P = self.mesh, self.degree
        el = self.element
        n1 = P + 1

        patch_all, m_blk, lat = self._uniform_blocks()

        S1 = _q1_shape(el.support_points)
        q1_pos = np.einsum("li,cid->cld", S1, mesh.vertices[mesh.cells])
        tol = max(mesh.cell_min_vertex_distance().min() / 64.0, 1e-12)
        key = np.round(q1_pos.reshape(-1, 2) / tol).astype(np.int64)
        ids, n_nodes = native.unique_rows(key)
        cell_nodes = ids.reshape(mesh.n_cells, el.n_loc)

        li = np.arange(el.n_loc) % n1
        lj = np.arange(el.n_loc) // n1
        cell_ids = np.arange(mesh.n_cells)
        families = []                 # (m, cells, patch_of, lat_of, pnodes)
        mult = np.zeros(n_nodes, dtype=np.int64)
        for m in np.unique(m_blk):
            blocks = np.nonzero(m_blk == m)[0]
            sel = np.isin(patch_all, blocks)
            cells_f = cell_ids[sel]
            remap = np.full(len(m_blk), -1, np.int64)
            remap[blocks] = np.arange(len(blocks))
            patch_f = remap[patch_all[sel]]
            lat_f = lat[sel]
            Xn = P * int(m) + 1
            pnodes = np.full((len(blocks), Xn, Xn), -1, np.int64)
            gx = (P * lat_f[:, 0])[:, None] + li[None, :]
            gy = (P * lat_f[:, 1])[:, None] + lj[None, :]
            pnodes[patch_f[:, None], gy, gx] = cell_nodes[cells_f]
            if (pnodes < 0).any():
                return False          # incomplete patch lattice (bug)
            np.add.at(mult, pnodes.reshape(-1), 1)
            families.append((int(m), cells_f, patch_f, lat_f, pnodes))

        perm = np.argsort(mult, kind="stable")
        relabel = np.empty(n_nodes, dtype=np.int64)
        relabel[perm] = np.arange(n_nodes)
        self.cell_nodes = relabel[cell_nodes].astype(np.int32)
        self.n_nodes = int(n_nodes)
        self.node2d_mult = mult[perm]
        self.n2d = int(n_nodes)
        self.patch2d_families = [
            dict(m=m, n_patches=int(pnodes.shape[0]), cells=cells_f,
                 patch_of_cell=patch_f, lattice_of_cell=lat_f,
                 patch_nodes=relabel[pnodes].astype(np.int32))
            for m, cells_f, patch_f, lat_f, pnodes in families
        ]
        if len(families) == 1:
            # uniform: keep the legacy single-family attributes (the
            # distributed halo_patch2d path and the prism-style
            # consumers key off these)
            m, cells_f, patch_f, lat_f, pnodes = families[0]
            self.n_patches = int(pnodes.shape[0])
            self.patch_cells = m
            self.patch_of_cell2d = patch_f
            self.lattice_of_cell2d = lat_f
            self.patch_nodes = relabel[pnodes].astype(np.int32)
        return True

    def _build_patch3d_numbering(self) -> bool:
        """3D sibling of ``_build_patch2d_numbering`` for general
        (non-extruded) 3D meshes — the Gmsh sphere family: cells group
        into per-coarse-cell refinement patch lattices; nodes relabeled
        by patch multiplicity for dense seam-compress classes
        (ops/patch3d.py).  Returns False on adaptive/broken chains."""
        from ns_gls_tpu_torch.utils import native

        mesh, P = self.mesh, self.degree
        el = self.element
        n1 = P + 1

        chain = []
        cur = mesh
        while cur.prev is not None and cur.parent_cell is not None:
            chain.append(cur)
            cur = cur.prev
        patch = np.arange(cur.n_cells, dtype=np.int64)
        lat = np.zeros((cur.n_cells, 3), dtype=np.int64)
        for gen in reversed(chain):
            pc, ch = gen.parent_cell, gen.parent_child
            if (ch < 0).any():
                return False          # adaptive: mixed-depth cells
            off = np.stack([ch & 1, (ch >> 1) & 1, (ch >> 2) & 1], axis=1)
            patch = patch[pc]
            lat = 2 * lat[pc] + off
        m_ref = 1 << len(chain)
        if len(patch) != mesh.n_cells:
            return False

        S1 = _q1_shape(el.support_points)
        q1_pos = np.einsum("li,cid->cld", S1, mesh.vertices[mesh.cells])
        tol = max(mesh.cell_min_vertex_distance().min() / 64.0, 1e-12)
        key = np.round(q1_pos.reshape(-1, 3) / tol).astype(np.int64)
        ids, n_nodes = native.unique_rows(key)
        cell_nodes = ids.reshape(mesh.n_cells, el.n_loc)

        Xn = P * m_ref + 1
        patch_nodes = np.full(
            (int(cur.n_cells), Xn, Xn, Xn), -1, np.int64
        )                              # [p, gz, gy, gx]
        loc = np.arange(el.n_loc)
        li = loc % n1
        lj = (loc // n1) % n1
        lk = loc // (n1 * n1)
        gx = (P * lat[:, 0])[:, None] + li[None, :]
        gy = (P * lat[:, 1])[:, None] + lj[None, :]
        gz = (P * lat[:, 2])[:, None] + lk[None, :]
        patch_nodes[patch[:, None], gz, gy, gx] = cell_nodes
        if (patch_nodes < 0).any():
            return False

        mult = np.zeros(n_nodes, dtype=np.int64)
        np.add.at(mult, patch_nodes.reshape(-1), 1)
        perm = np.argsort(mult, kind="stable")
        relabel = np.empty(n_nodes, dtype=np.int64)
        relabel[perm] = np.arange(n_nodes)
        self.cell_nodes = relabel[cell_nodes].astype(np.int32)
        self.n_nodes = int(n_nodes)
        self.n_patches = int(cur.n_cells)
        self.patch_cells = m_ref
        self.patch_of_cell3 = patch
        self.lattice_of_cell3 = lat
        self.patch_nodes3 = relabel[patch_nodes].astype(np.int32)
        self.node_mult3 = mult[perm]
        return True

    def _build_prism_numbering(self):
        """(node2d, z)-product numbering for extruded meshes (the prism
        fast path, ops/prism.py): scalar node id = node2d * nz_nodes + z
        with z innermost, so patch gathers move whole contiguous z-runs.
        2D nodes are sorted by patch multiplicity so the seam-compress
        gather classes are dense (same trick as the general transpose-
        gather).  The 2D factor mesh is used combinatorially only —
        geometry still comes from the 3D mapping."""
        from ns_gls_tpu_torch.fem.element import Element
        from ns_gls_tpu_torch.utils import native

        mesh = self.mesh
        P = self.degree
        n1 = P + 1
        m2 = mesh.extr_mesh2d

        # 2D scalar numbering: dedup Q1-lattice positions on the 2D factor
        el2 = Element(2, P, 2)
        S1 = _q1_shape(el2.support_points)
        q1_pos = np.einsum("li,cid->cld", S1, m2.vertices[m2.cells])
        tol = max(m2.cell_min_vertex_distance().min() / 64.0, 1e-12)
        key = np.round(q1_pos.reshape(-1, 2) / tol).astype(np.int64)
        ids, n2d = native.unique_rows(key)
        cell2d_nodes = ids.reshape(m2.n_cells, el2.n_loc).astype(np.int64)

        # per-2D-coarse-cell patch lattices from the refinement chain
        chain = []
        cur = m2
        while cur.prev is not None and cur.parent_cell is not None:
            chain.append(cur)
            cur = cur.prev
        patch = np.arange(cur.n_cells, dtype=np.int64)
        lat = np.zeros((cur.n_cells, 2), dtype=np.int64)
        for gen in reversed(chain):
            pc, ch = gen.parent_cell, gen.parent_child
            assert (ch >= 0).all(), "adaptive 2D factor mesh"
            off = np.stack([ch & 1, (ch >> 1) & 1], axis=1)
            patch = patch[pc]
            lat = 2 * lat[pc] + off
        m_ref = 1 << len(chain)
        self.n_patches = int(cur.n_cells)
        self.patch_cells = m_ref            # cells per patch axis (mx = my)
        self.patch_of_cell2d = patch
        self.lattice_of_cell2d = lat

        # patch node tables: patch_nodes[p, iy, ix] = 2D node id
        Xn = P * m_ref + 1
        patch_nodes = np.full((self.n_patches, Xn, Xn), -1, dtype=np.int64)
        li = np.arange(el2.n_loc) % n1
        lj = np.arange(el2.n_loc) // n1
        gx = (P * lat[:, 0])[:, None] + li[None, :]
        gy = (P * lat[:, 1])[:, None] + lj[None, :]
        patch_nodes[patch[:, None], gy, gx] = cell2d_nodes
        assert (patch_nodes >= 0).all()

        # multiplicity-sorted renumbering of 2D nodes
        mult = np.zeros(n2d, dtype=np.int64)
        np.add.at(mult, patch_nodes.reshape(-1), 1)
        perm = np.argsort(mult, kind="stable")
        relabel = np.empty(n2d, dtype=np.int64)
        relabel[perm] = np.arange(n2d)
        cell2d_nodes = relabel[cell2d_nodes]
        patch_nodes = relabel[patch_nodes]
        self.n2d = int(n2d)
        self.node2d_mult = mult[perm]
        self.cell2d_nodes = cell2d_nodes.astype(np.int32)
        self.patch_nodes = patch_nodes.astype(np.int32)

        # 3D product numbering (local nodes lexicographic, x fastest)
        self.nz_cells = int(mesh.extr_nz)
        self.nz_nodes = P * self.nz_cells + 1
        loc = np.arange(n1**3)
        ij = loc % (n1 * n1)
        kk = loc // (n1 * n1)
        node2d = cell2d_nodes[mesh.extr_cell2d][:, ij]
        z = (P * mesh.extr_layer)[:, None] + kk[None, :]
        self.cell_nodes = (node2d * self.nz_nodes + z).astype(np.int32)
        self.n_nodes = self.n2d * self.nz_nodes

    def build_face_batches(self, n_q1d: int, boundary_ids=None) -> list:
        """Boundary-face batches with an n_q1d-per-direction Gauss rule,
        optionally restricted to given boundary ids (the postprocess
        functionals use their own fixed rule, like the reference's
        ``QGauss<dim-1>(3)``, ``simulation.cc:451``)."""
        from ns_gls_tpu_torch.fem.element import Element, IsoQ1Element

        mesh, dim = self.mesh, self.dim
        el_cls = IsoQ1Element if getattr(self, "iso_q1", False) else Element
        el = el_cls(dim, self.degree, n_q1d)
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
    @functools.lru_cache(maxsize=None)
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

    def boundary_node_normals(self, boundary_ids) -> tuple[np.ndarray, np.ndarray]:
        """(nodes, normals): averaged outward unit normals at boundary nodes
        (for no-normal-flux constraints; deal.II
        ``compute_no_normal_flux_constraints``, ``main.cc:285-287``)."""
        ids = set(int(b) for b in np.atleast_1d(boundary_ids))
        acc: dict[int, np.ndarray] = {}
        el = self.element
        for fb in self.face_batches:
            sel = np.isin(fb.boundary_id, list(ids))
            if not sel.any():
                continue
            loc = self.face_node_lattice(fb.local_face)
            f = fb.local_face
            # normal at each face node: evaluate face normal from mapping
            sp = el.support_points[loc]  # reference coords of face nodes
            Sf, Df = tabulate_at(self.mapping_degree, self.dim, sp)
            X = self.map_points[fb.cells[sel]]
            Jf = np.einsum("qir,cix->cqxr", Df, X)
            Jinv_f = np.linalg.inv(Jf)
            fdir = f // 2
            g = el.face_normal_sign(f) * Jinv_f[:, :, fdir, :]
            g = g / np.linalg.norm(g, axis=-1, keepdims=True)
            nodes = self.cell_nodes[fb.cells[sel]][:, loc]
            for cface in range(len(nodes)):
                for a in range(len(loc)):
                    nd = int(nodes[cface, a])
                    acc[nd] = acc.get(nd, 0.0) + g[cface, a]
        nds = np.array(sorted(acc.keys()), dtype=np.int32)
        nrm = np.stack([acc[int(n)] for n in nds]) if len(nds) else np.zeros((0, self.dim))
        if len(nds):
            nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        return nds, nrm
