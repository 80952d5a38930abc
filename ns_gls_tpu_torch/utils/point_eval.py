"""Point location + solution evaluation at arbitrary physical points.

Host-side equivalent of the reference's ``RemotePointEvaluation`` usage for
the pressure-probe functional (``simulation.cc:513-541``): locate the owning
cell once (Newton-inverting the isoparametric mapping), then each step the
evaluation is a tiny gather + dot.
"""

from __future__ import annotations

import numpy as np
import torch

from ns_gls_tpu_torch.fem.element import tabulate_at
from ns_gls_tpu_torch.fem.space import FESpace


def locate_points(space: FESpace, points: np.ndarray, tol: float = 1e-8):
    """Returns (cells (n_p,), ref_coords (n_p, dim)). Raises if not found.

    Uses the native meshkit Q1 locator (native/meshkit.cc) to find the
    owning cell, then polishes the reference coordinates with Newton on
    the full isoparametric mapping."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    dim = space.dim
    centers = space.map_points.mean(axis=1)  # (n_c, dim)
    cells_out = np.empty(len(points), dtype=np.int64)
    refs_out = np.empty((len(points), dim))

    from ns_gls_tpu_torch.utils import native

    q1_hits = None
    if native.available():
        res = native.locate_points_q1(
            space.mesh.vertices, space.mesh.cells, points, tol=1e-9
        )
        if res is not None:
            q1_hits = res[0]

    for ip, p in enumerate(points):
        d2 = ((centers - p) ** 2).sum(axis=1)
        candidates = list(np.argsort(d2)[:32])
        if q1_hits is not None and q1_hits[ip] >= 0:
            candidates = [int(q1_hits[ip])] + candidates
        found = False
        for c in candidates:
            X = space.map_points[c]  # (n_map_loc, dim)
            xi = np.full(dim, 0.5)
            for _ in range(30):
                S, D = tabulate_at(space.mapping_degree, dim, xi[None, :])
                x = S[0] @ X                       # (dim,)
                J = np.einsum("ir,ix->xr", D[0], X)  # dx/dxi
                r = p - x
                if np.linalg.norm(r) < tol:
                    break
                try:
                    dxi = np.linalg.solve(J, r)
                except np.linalg.LinAlgError:
                    break
                xi = xi + np.clip(dxi, -0.5, 0.5)
            if (
                np.linalg.norm(r) < tol
                and (xi > -1e-6).all()
                and (xi < 1 + 1e-6).all()
            ):
                cells_out[ip] = c
                refs_out[ip] = np.clip(xi, 0.0, 1.0)
                found = True
                break
        if not found:
            raise ValueError(f"point {p} not found in mesh")
    return cells_out, refs_out


def locate_points_kd(space: FESpace, points: np.ndarray, k: int = 16,
                     tol: float = 1e-8):
    """Vectorized point location for many points: cKDTree candidate search
    over cell centers + batched Newton on the Q1 map, polished on the true
    mapping.  Returns (cells, ref_coords); cell = -1 where not found."""
    from scipy.spatial import cKDTree

    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    dim = space.dim
    n_p = len(points)
    centers = space.map_points.mean(axis=1)
    tree = cKDTree(centers)
    _, cand = tree.query(points, k=min(k, len(centers)))
    cand = np.atleast_2d(cand)

    cells_out = np.full(n_p, -1, dtype=np.int64)
    refs_out = np.full((n_p, dim), 0.5)

    for rank in range(cand.shape[1]):
        todo = cells_out < 0
        if not todo.any():
            break
        idx = np.nonzero(todo)[0]
        c = cand[idx, rank]
        X = space.map_points[c]  # (m, n_map_loc, dim)
        p = points[idx]
        xi = np.full((len(idx), dim), 0.5)
        for _ in range(30):
            S, D = tabulate_at(space.mapping_degree, dim, xi)
            x = np.einsum("mi,mix->mx", S, X)
            J = np.einsum("mir,mix->mxr", D, X)
            r = p - x
            if (np.linalg.norm(r, axis=1) < tol).all():
                break
            try:
                dxi = np.linalg.solve(J, r[:, :, None])[:, :, 0]
            except np.linalg.LinAlgError:
                dxi = np.zeros_like(xi)
            xi = xi + np.clip(dxi, -0.5, 0.5)
        ok = (
            (np.linalg.norm(r, axis=1) < 1e-7)
            & (xi > -1e-6).all(axis=1)
            & (xi < 1 + 1e-6).all(axis=1)
        )
        hit = idx[ok]
        cells_out[hit] = c[ok]
        refs_out[hit] = np.clip(xi[ok], 0.0, 1.0)
    return cells_out, refs_out


class PointEvaluator:
    """Precompiled evaluation of (dim+1)-component fields at fixed points."""

    def __init__(self, space: FESpace, points):
        self.space = space
        cells, refs = locate_points(space, points)
        # per point: basis values at its reference coords
        tabs = [
            tabulate_at(space.degree, space.dim, refs[i : i + 1])[0][0]
            for i in range(len(cells))
        ]
        self.S = np.stack(tabs)                    # (n_p, n_loc)
        self.nodes = space.cell_nodes[cells]       # (n_p, n_loc)

    def __call__(self, u: torch.Tensor) -> np.ndarray:
        """u: (n_nodes, C) tensor -> (n_p, C) host array (only the
        probes' nodes leave the device)."""
        idx = torch.as_tensor(self.nodes, device=u.device)
        u_loc = u[idx].double().cpu().numpy()      # (n_p, n_loc, C)
        return np.einsum("pi,pic->pc", self.S, u_loc)
