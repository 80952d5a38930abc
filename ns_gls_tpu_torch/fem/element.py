"""Tensor-product Q_k reference element tables (host precompute, numpy).

Everything lives in *lexicographic* ordering (x fastest, then y, then z) —
the layout deal.II's matrix-free kernels also use internally
(``matrix_free.get_shape_info().lexicographic_numbering``,
reference ``operator_ns.cc:1379-1380``).

The tables produced here feed the batched cell kernels in
:mod:`ns_gls_tpu_torch.ops.navier_stokes`:

- ``S``  (n_q, n_loc):          shape values at quadrature points
- ``D``  (n_q, n_loc, dim):     reference-space gradients
- per-face variants for boundary-face integrals.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ns_gls_tpu_torch.fem.lagrange import (
    eval_lagrange,
    gauss_lobatto_points_1d,
    gauss_points_1d,
)


def lex_points(nodes_1d: np.ndarray, dim: int) -> np.ndarray:
    """Tensor-product lattice of 1D `nodes_1d`, lexicographic (x fastest).

    Returns (len(nodes_1d)**dim, dim).
    """
    n = len(nodes_1d)
    nodes_1d = np.asarray(nodes_1d, dtype=np.float64)
    idx = np.arange(n**dim)
    coords = np.empty((n**dim, dim), dtype=np.float64)
    rem = idx.copy()
    for d in range(dim):
        coords[:, d] = nodes_1d[rem % n]
        rem //= n
    return coords


def tabulate_at(degree: int, dim: int, points: np.ndarray):
    """Tabulate the Q_degree basis (lexicographic) at arbitrary reference
    points. Returns (S, D): (n_pts, n_loc) and (n_pts, n_loc, dim)."""
    nodes = gauss_lobatto_points_1d(degree + 1)
    n1 = degree + 1
    n_loc = n1**dim
    n_pts = len(points)
    vals_d = []
    ders_d = []
    for d in range(dim):
        v, g = eval_lagrange(tuple(nodes), points[:, d])
        vals_d.append(v)
        ders_d.append(g)
    S = np.ones((n_pts, n_loc))
    D = np.zeros((n_pts, n_loc, dim))
    idx = np.arange(n_loc)
    comp = []
    rem = idx.copy()
    for d in range(dim):
        comp.append(rem % n1)
        rem //= n1
    for d in range(dim):
        S *= vals_d[d][:, comp[d]]
    for r in range(dim):
        Dr = np.ones((n_pts, n_loc))
        for d in range(dim):
            tab = ders_d[d] if d == r else vals_d[d]
            Dr *= tab[:, comp[d]]
        D[:, :, r] = Dr
    return S, D


@dataclasses.dataclass(frozen=True)
class Element:
    """Q_degree scalar element on the [0,1]^dim reference cell with an
    n_q1d-point Gauss rule per direction."""

    dim: int
    degree: int
    n_q1d: int

    @property
    def n_loc(self) -> int:
        return (self.degree + 1) ** self.dim

    @property
    def n_q(self) -> int:
        return self.n_q1d**self.dim

    @functools.cached_property
    def support_points(self) -> np.ndarray:
        """(n_loc, dim) lexicographic support points."""
        return lex_points(gauss_lobatto_points_1d(self.degree + 1), self.dim)

    @functools.cached_property
    def q_points(self) -> np.ndarray:
        """(n_q, dim) lexicographic quadrature points."""
        q, _ = gauss_points_1d(self.n_q1d)
        return lex_points(q, self.dim)

    @functools.cached_property
    def q_weights(self) -> np.ndarray:
        _, w = gauss_points_1d(self.n_q1d)
        out = np.ones(1)
        for _ in range(self.dim):
            out = np.kron(w, out)  # x fastest
        return out

    @functools.cached_property
    def tables(self):
        """(S, D) at cell quadrature points."""
        return tabulate_at(self.degree, self.dim, self.q_points)

    # ---- faces -----------------------------------------------------------
    # local face numbering (deal.II style): face 2f+s is the face with
    # coordinate d=f fixed at s (s=0 lower, s=1 upper).

    @property
    def n_faces(self) -> int:
        return 2 * self.dim

    @functools.cached_property
    def face_q_weights(self) -> np.ndarray:
        _, w = gauss_points_1d(self.n_q1d)
        out = np.ones(1)
        for _ in range(self.dim - 1):
            out = np.kron(w, out)
        return out

    def face_q_points(self, face: int) -> np.ndarray:
        """Reference-cell coordinates of face quadrature points,
        (n_q1d**(dim-1), dim).  Face parametrization: the remaining
        coordinates in increasing order, x-fastest."""
        q, _ = gauss_points_1d(self.n_q1d)
        fdir, fside = face // 2, face % 2
        free = [d for d in range(self.dim) if d != fdir]
        pts_f = lex_points(q, self.dim - 1)  # (n_fq, dim-1)
        n_fq = len(pts_f)
        pts = np.empty((n_fq, self.dim))
        pts[:, fdir] = float(fside)
        for a, d in enumerate(free):
            pts[:, d] = pts_f[:, a]
        return pts

    @functools.cached_property
    def face_tables(self):
        """Per local face: (S_f, D_f) at face q-points (lists of arrays)."""
        out = []
        for f in range(self.n_faces):
            out.append(tabulate_at(self.degree, self.dim, self.face_q_points(f)))
        return out

    def face_tangent_dirs(self, face: int) -> list[int]:
        """Reference directions spanning the face (order of parametrization)."""
        fdir = face // 2
        return [d for d in range(self.dim) if d != fdir]

    def face_normal_sign(self, face: int) -> float:
        """Outward normal points along -e_fdir for side 0, +e_fdir for 1."""
        return -1.0 if face % 2 == 0 else 1.0


def _pw_linear_eval(nodes: np.ndarray, x: np.ndarray):
    """Piecewise-linear ("hat") basis on the 1D lattice `nodes`; values and
    derivatives at points x.  Returns (V, G): (n_pts, n_nodes) each."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    k = len(nodes) - 1
    s = np.clip(np.searchsorted(nodes, x, side="right") - 1, 0, k - 1)
    h = nodes[s + 1] - nodes[s]
    t = (x - nodes[s]) / h
    rows = np.arange(len(x))
    V = np.zeros((len(x), k + 1))
    G = np.zeros((len(x), k + 1))
    V[rows, s] = 1.0 - t
    V[rows, s + 1] += t
    G[rows, s] = -1.0 / h
    G[rows, s + 1] += 1.0 / h
    return V, G


def _iso_q1_rule_1d(nodes: np.ndarray):
    """2-point Gauss per sub-interval of `nodes` (the QIterated analogue on
    the support lattice): exact for products of piecewise-linear factors."""
    q1, w1 = gauss_points_1d(2)
    pts, wts = [], []
    for a, b in zip(nodes[:-1], nodes[1:]):
        pts.append(a + (b - a) * q1)
        wts.append((b - a) * w1)
    return np.concatenate(pts), np.concatenate(wts)


def tabulate_iso_q1_at(degree: int, dim: int, points: np.ndarray):
    """Tabulate the piecewise-Q1 basis (same lattice as Q_degree) at
    arbitrary reference points."""
    nodes = gauss_lobatto_points_1d(degree + 1)
    n1 = degree + 1
    n_loc = n1**dim
    n_pts = len(points)
    vals_d, ders_d = [], []
    for d in range(dim):
        v, g = _pw_linear_eval(nodes, points[:, d])
        vals_d.append(v)
        ders_d.append(g)
    S = np.ones((n_pts, n_loc))
    D = np.zeros((n_pts, n_loc, dim))
    idx = np.arange(n_loc)
    comp = []
    rem = idx.copy()
    for d in range(dim):
        comp.append(rem % n1)
        rem //= n1
    for d in range(dim):
        S *= vals_d[d][:, comp[d]]
    for r in range(dim):
        Dr = np.ones((n_pts, n_loc))
        for d in range(dim):
            tab = ders_d[d] if d == r else vals_d[d]
            Dr *= tab[:, comp[d]]
        D[:, :, r] = Dr
    return S, D


@dataclasses.dataclass(frozen=True)
class IsoQ1Element(Element):
    """FE_Q_iso_Q1-style element ("gmg coarse grid use fe q iso q1",
    reference ``main.cc`` GMG coarse level; deal.II ``FE_Q_iso_Q1``):
    the SAME node lattice as Q_degree, but piecewise-multilinear shape
    functions on the degree**dim sub-cells, integrated with a 2-point
    Gauss rule per sub-cell.  Node positions coincide with the Q_k space's,
    so transfers and constraints carry over unchanged while the coarse
    operator gets a Q1-sparse stencil (cheaper coarse AMG/LU)."""

    @functools.cached_property
    def _rule_1d(self):
        return _iso_q1_rule_1d(gauss_lobatto_points_1d(self.degree + 1))

    @property
    def n_q(self) -> int:
        return (2 * self.degree) ** self.dim

    @functools.cached_property
    def q_points(self) -> np.ndarray:
        return lex_points(self._rule_1d[0], self.dim)

    @functools.cached_property
    def q_weights(self) -> np.ndarray:
        w = self._rule_1d[1]
        out = np.ones(1)
        for _ in range(self.dim):
            out = np.kron(w, out)
        return out

    @functools.cached_property
    def tables(self):
        return tabulate_iso_q1_at(self.degree, self.dim, self.q_points)

    @functools.cached_property
    def face_q_weights(self) -> np.ndarray:
        w = self._rule_1d[1]
        out = np.ones(1)
        for _ in range(self.dim - 1):
            out = np.kron(w, out)
        return out

    def face_q_points(self, face: int) -> np.ndarray:
        q = self._rule_1d[0]
        fdir, fside = face // 2, face % 2
        free = [d for d in range(self.dim) if d != fdir]
        pts_f = lex_points(q, self.dim - 1)
        pts = np.empty((len(pts_f), self.dim))
        pts[:, fdir] = float(fside)
        for a, d in enumerate(free):
            pts[:, d] = pts_f[:, a]
        return pts

    @functools.cached_property
    def face_tables(self):
        return [
            tabulate_iso_q1_at(self.degree, self.dim, self.face_q_points(f))
            for f in range(self.n_faces)
        ]


def embedding_matrix(degree: int, dim: int) -> np.ndarray:
    """Prolongation embedding: value of coarse basis functions at the
    support points of each of the 2**dim children.

    Returns (2**dim, n_loc, n_loc): child c, child support point i,
    coarse basis j. Used to build MG two-level transfers
    (reference: ``MGTwoLevelTransfer``, ``main.cc:540-556``).
    """
    el = Element(dim, degree, degree + 1)
    sp = el.support_points  # (n_loc, dim) in [0,1]^dim
    n_children = 2**dim
    out = np.zeros((n_children, el.n_loc, el.n_loc))
    for c in range(n_children):
        shift = np.array([(c >> d) & 1 for d in range(dim)], dtype=np.float64)
        pts = 0.5 * (sp + shift)  # child c's support points in coarse coords
        S, _ = tabulate_at(degree, dim, pts)
        out[c] = S
    return out


def child_vertex_offsets(dim: int) -> np.ndarray:
    """(2**dim, dim) binary offsets of children, x fastest."""
    return np.array(
        [[(c >> d) & 1 for d in range(dim)] for c in range(2**dim)],
        dtype=np.int64,
    )


def cell_face_vertices(dim: int) -> list[list[int]]:
    """Local vertex indices (into the 2**dim lexicographic cell vertices)
    of each of the 2*dim faces, in lexicographic face order."""
    def vidx(coords):
        return sum(c << d for d, c in enumerate(coords))

    faces = []
    for face in range(2 * dim):
        fdir, fside = face // 2, face % 2
        free = [d for d in range(dim) if d != fdir]
        fv = []
        n_fv = 2 ** (dim - 1)
        for i in range(n_fv):
            coords = [0] * dim
            coords[fdir] = fside
            rem = i
            for d in free:
                coords[d] = rem % 2
                rem //= 2
            fv.append(vidx(coords))
        faces.append(fv)
    return faces


def cell_edge_vertices(dim: int) -> list[tuple[int, int]]:
    """Local vertex index pairs of cell edges (lexicographic vertices)."""
    edges = []
    for d in range(dim):  # edge direction
        others = [e for e in range(dim) if e != d]
        for combo in range(2 ** (dim - 1)):
            c0 = [0] * dim
            rem = combo
            for e in others:
                c0[e] = rem % 2
                rem //= 2
            c1 = list(c0)
            c1[d] = 1
            v0 = sum(c << k for k, c in enumerate(c0))
            v1 = sum(c << k for k, c in enumerate(c1))
            edges.append((v0, v1))
    return edges
