"""Hanging-node constraints on 1-irregular adaptive meshes.

Equivalent of deal.II ``make_hanging_node_constraints`` (``main.cc:293``):
nodes on the refined side of a coarse-fine interface are constrained to
the interpolation of the coarse side's basis:

    u(hanging node at x) = sum_j N_j^coarse(xi(x)) u(coarse node j).

Interfaces are found topologically (unmatched interior faces) and paired
geometrically by PROJECTING each fine-side node onto the coarse cell's Q1
face (Gauss-Newton on the face-restricted map).  Projection (rather than
exact inversion) also handles curved interfaces — e.g. the boundary-refined
polar-manifold annulus of rotation.json, where manifold-placed hanging
vertices sit on the arc while the coarse Q1 face is the chord; the
projected parametric weights reproduce deal.II's topological constraint
weights exactly.
"""

from __future__ import annotations

import numpy as np

from ns_gls_tpu_torch.fem.element import cell_face_vertices, tabulate_at
from ns_gls_tpu_torch.fem.space import FESpace


def _inverse_q1(verts_cell: np.ndarray, p: np.ndarray, tol=1e-10):
    """Newton-invert the multilinear map of one cell; returns xi or None."""
    dim = verts_cell.shape[1]
    xi = np.full(dim, 0.5)
    for _ in range(40):
        S, D = _q1_tab(xi[None, :], dim)
        x = S[0] @ verts_cell
        J = np.einsum("ir,ix->xr", D[0], verts_cell)
        r = p - x
        if np.linalg.norm(r) < tol:
            break
        try:
            dxi = np.linalg.solve(J, r)
        except np.linalg.LinAlgError:
            return None
        xi = xi + np.clip(dxi, -0.5, 0.5)
    if np.linalg.norm(r) > 1e-8:
        return None
    return xi


def _q1_tab(pts, dim):
    n = len(pts)
    n_loc = 2**dim
    S = np.ones((n, n_loc))
    D = np.zeros((n, n_loc, dim))
    for v in range(n_loc):
        for d in range(dim):
            t = pts[:, d] if (v >> d) & 1 else 1.0 - pts[:, d]
            S[:, v] *= t
        for r in range(dim):
            prod = np.full(n, 1.0 if (v >> r) & 1 else -1.0)
            for d in range(dim):
                if d == r:
                    continue
                prod *= pts[:, d] if (v >> d) & 1 else 1.0 - pts[:, d]
            D[:, v, r] = prod
    return S, D


def find_hanging_faces(mesh):
    """(coarse_faces, fine_faces): lists of (cell, local_face) of unmatched
    interior faces, split by cell level (the fine side is deeper)."""
    fv = np.array(cell_face_vertices(mesh.dim))
    quads = np.sort(mesh.cells[:, fv], axis=-1)
    flat = quads.reshape(-1, quads.shape[-1])
    _, inv, counts = np.unique(flat, axis=0, return_inverse=True,
                               return_counts=True)
    unmatched = (counts[inv] == 1).reshape(mesh.n_cells, 2 * mesh.dim)
    interior = mesh.boundary_ids < 0
    cand = unmatched & interior
    c, f = np.nonzero(cand)
    if len(c) == 0:
        return [], []
    levels = mesh.cell_level[c]
    coarse = [(int(ci), int(fi)) for ci, fi, l in zip(c, f, levels)
              if _is_coarse_side(mesh, ci, fi)]
    fine = [(int(ci), int(fi)) for ci, fi in zip(c, f)
            if (int(ci), int(fi)) not in set(coarse)]
    return coarse, fine


def _is_coarse_side(mesh, ci, fi):
    """A coarse interface face is larger than its partners: decide by
    comparing the cell level to the neighbors sharing its vertices."""
    fv = np.array(cell_face_vertices(mesh.dim))
    verts = mesh.cells[ci, fv[fi]]
    # any other cell using one of these vertices with a higher level?
    mask = np.isin(mesh.cells, verts).any(axis=1)
    mask[ci] = False
    if not mask.any():
        return False
    return mesh.cell_level[mask].max() > mesh.cell_level[ci]


def hanging_node_constraints(space: FESpace):
    """Returns a list of (hanging_node, master_nodes (n_loc,), weights).

    Empty on conforming meshes."""
    mesh = space.mesh
    if not mesh.is_adaptive:
        return []
    coarse, fine = find_hanging_faces(mesh)
    if not fine:
        return []
    fv = np.array(cell_face_vertices(mesh.dim))

    # bounding boxes of coarse faces
    cf_info = []
    for ci, fi in coarse:
        verts = mesh.vertices[mesh.cells[ci, fv[fi]]]
        cf_info.append((ci, fi, verts.min(0), verts.max(0)))

    out = []
    seen = set()
    deg = space.degree
    for ci, fi in fine:
        loc = space.face_node_lattice(fi)
        fnodes = space.cell_nodes[ci, loc]
        pos = space.node_pos[fnodes]
        lvl_fine = mesh.cell_level[ci]
        h_fine = np.linalg.norm(
            mesh.vertices[mesh.cells[ci, 0]]
            - mesh.vertices[mesh.cells[ci, -1]]
        )
        # find the owning coarse face via bbox + face-projected inverse map
        for node, p in zip(fnodes, pos):
            node = int(node)
            if node in seen:
                continue
            for cj, fj, lo, hi in cf_info:
                if mesh.cell_level[cj] >= lvl_fine:
                    continue
                pad = 1e-8 + 0.2 * np.abs(hi - lo).max()
                if ((p < lo - pad) | (p > hi + pad)).any():
                    continue
                xi = _project_to_face(mesh, cj, fj, p)
                if xi is None:
                    continue
                # distance of the node to the (possibly chordal) coarse
                # face: curved interfaces put hanging vertices off the Q1
                # surface; deal.II's constraint is topological, and the
                # face projection reproduces exactly its parametric weights
                S1, _ = _q1_tab(xi[None, :], mesh.dim)
                x_face = S1[0] @ mesh.vertices[mesh.cells[cj]]
                if np.linalg.norm(x_face - p) > 0.3 * h_fine:
                    continue
                S, _ = tabulate_at(deg, mesh.dim, np.clip(xi, 0, 1)[None, :])
                w = S[0]
                masters = space.cell_nodes[cj]
                # shared (conforming) node: interpolation is the identity
                if w.max() > 1 - 1e-9 and int(masters[np.argmax(w)]) == node:
                    break
                keep = np.abs(w) > 1e-12
                out.append((node, masters[keep].tolist(), w[keep].tolist()))
                break
            seen.add(node)
    return out


def _project_to_face(mesh, cj, fj, p, tol=1e-10):
    """Gauss-Newton on the coarse cell's Q1 map restricted to face fj:
    find the in-face reference coords closest to p.  Returns the full-dim
    xi (with xi[fdir] pinned to the face) or None."""
    dim = mesh.dim
    fdir, fside = fj // 2, fj % 2
    free = [d for d in range(dim) if d != fdir]
    verts = mesh.vertices[mesh.cells[cj]]
    xi = np.full(dim, 0.5)
    xi[fdir] = float(fside)
    for _ in range(40):
        S, D = _q1_tab(xi[None, :], dim)
        x = S[0] @ verts
        J = np.einsum("ir,ix->xr", D[0], verts)  # dx/dxi
        r = p - x
        Jf = J[:, free]  # (dim, dim-1)
        try:
            dxi_f, *_ = np.linalg.lstsq(Jf, r, rcond=None)
        except np.linalg.LinAlgError:
            return None
        if np.linalg.norm(dxi_f) < tol:
            break
        for a, d in enumerate(free):
            xi[d] += float(np.clip(dxi_f[a], -0.5, 0.5))
    if ((xi[free] < -1e-6) | (xi[free] > 1 + 1e-6)).any():
        return None
    return xi
