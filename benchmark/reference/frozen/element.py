"""Frozen copy of ``ns_gls_tpu_torch/fem/element.py``, taken when the
benchmark was defined, so that the reference works out its geometry
without the program. Changed: imports point at this folder; the parts
the reference does not use are left out.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from benchmark.reference.frozen.lagrange import (
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

    def face_normal_sign(self, face: int) -> float:
        """Outward normal points along -e_fdir for side 0, +e_fdir for 1."""
        return -1.0 if face % 2 == 0 else 1.0


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
