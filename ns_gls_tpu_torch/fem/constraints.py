"""Affine constraints: u_i = sum_j w_ij u_j + b_i  (host build, device apply).

Equivalent of deal.II ``AffineConstraints`` as the reference uses it
(``main.cc:258-310``): homogeneous Dirichlet, pressure pinning,
no-normal-flux (slip), periodicity, hanging nodes, and time-dependent
inhomogeneous Dirichlet values.  The closed form is a set of padded
tensors; ``distribute`` / ``set_zero`` / the C/Cᵀ sandwich used inside the
matrix-free operator are plain tensor functions.  They return new
tensors and leave their arguments unchanged, as the JAX reference does.

DoF convention: scalar dof = node * n_comp + comp, on vectors stored as
(n_nodes, n_comp).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.utils.segment import class_sum, fixed_scatter


class ConstraintArrays(NamedTuple):
    """Closed constraints as tensors."""

    rows: torch.Tensor      # (n_cstr,) int64 flattened dof ids
    cols: torch.Tensor      # (n_cstr, max_deps) int64 (pad: 0)
    weights: torch.Tensor   # (n_cstr, max_deps) (pad: 0)
    inhom: torch.Tensor     # (n_cstr,)

    @property
    def n(self) -> int:
        return self.rows.shape[0]


class AffineConstraints:
    """Host-side builder.  First-added line for a dof wins (callers add in
    the reference's precedence order, ``main.cc:273-293``)."""

    def __init__(self, n_nodes: int, n_comp: int):
        self.n_nodes = n_nodes
        self.n_comp = n_comp
        # dof -> (list[(col_dof, weight)], inhomogeneity)
        self.lines: dict[int, tuple[list, float]] = {}

    def dof(self, node: int, comp: int) -> int:
        return int(node) * self.n_comp + int(comp)

    def add_line(self, dof: int, entries=(), inhom: float = 0.0) -> None:
        if dof not in self.lines:
            self.lines[dof] = (list(entries), float(inhom))

    def is_constrained(self, dof: int) -> bool:
        return dof in self.lines

    # ---- high-level builders ------------------------------------------
    def add_dirichlet(self, nodes, comps, values=None) -> None:
        """Constrain components `comps` at `nodes` to fixed values.
        `values`: None (zero), or (n_nodes_sel, n_comps_sel) array."""
        nodes = np.atleast_1d(nodes)
        comps = list(np.atleast_1d(comps))
        for a, node in enumerate(nodes):
            for b, comp in enumerate(comps):
                v = 0.0 if values is None else float(values[a][b])
                self.add_line(self.dof(node, comp), (), v)

    def add_periodic(self, nodes_a, nodes_b, comps) -> None:
        """u(node_a) = u(node_b) for each pair, per component."""
        for na, nb in zip(np.atleast_1d(nodes_a), np.atleast_1d(nodes_b)):
            for comp in np.atleast_1d(comps):
                self.add_line(
                    self.dof(na, comp), [(self.dof(nb, comp), 1.0)], 0.0
                )

    def add_no_normal_flux(self, nodes, normals) -> None:
        """Slip: n·u = 0 at each node; constrains the largest-|n| component
        (deal.II ``compute_no_normal_flux_constraints``)."""
        for node, n in zip(np.atleast_1d(nodes), np.atleast_2d(normals)):
            dmax = int(np.argmax(np.abs(n)))
            if abs(n[dmax]) < 1e-14:
                continue
            entries = [
                (self.dof(node, d), -float(n[d] / n[dmax]))
                for d in range(len(n))
                if d != dmax and abs(n[d]) > 1e-14
            ]
            self.add_line(self.dof(node, dmax), entries, 0.0)

    def add_hanging_node(self, node, comp_all, master_nodes, weights) -> None:
        """u(node) = sum_k weights[k] * u(master_nodes[k]) per component."""
        for comp in range(self.n_comp):
            self.add_line(
                self.dof(node, comp),
                [(self.dof(m, comp), float(w)) for m, w in zip(master_nodes, weights)],
                0.0,
            )

    # ---- closing --------------------------------------------------------
    def close(self, dtype=torch.float64,
              device: str | torch.device = "cpu") -> ConstraintArrays:
        """Resolve constraint chains and emit padded device tensors."""
        resolved: dict[int, tuple[list, float]] = {}

        def resolve(dof, depth=0):
            if depth > 16:
                raise ValueError("constraint chain too deep / cyclic")
            if dof in resolved:
                return resolved[dof]
            entries, inhom = self.lines[dof]
            out: dict[int, float] = {}
            acc_inhom = inhom
            for col, w in entries:
                if col in self.lines:
                    sub_entries, sub_inhom = resolve(col, depth + 1)
                    acc_inhom += w * sub_inhom
                    for c2, w2 in sub_entries:
                        out[c2] = out.get(c2, 0.0) + w * w2
                else:
                    out[col] = out.get(col, 0.0) + w
            res = (sorted(out.items()), acc_inhom)
            resolved[dof] = res
            return res

        for dof in self.lines:
            resolve(dof)

        rows = sorted(resolved.keys())
        max_deps = max((len(resolved[r][0]) for r in rows), default=0)
        max_deps = max(max_deps, 1)
        n = len(rows)
        cols = np.zeros((n, max_deps), dtype=np.int32)
        wts = np.zeros((n, max_deps), dtype=np.float64)
        inh = np.zeros(n, dtype=np.float64)
        for i, r in enumerate(rows):
            entries, b = resolved[r]
            inh[i] = b
            for k, (c, w) in enumerate(entries):
                cols[i, k] = c
                wts[i, k] = w
        return ConstraintArrays(
            rows=torch.as_tensor(np.array(rows, dtype=np.int64), device=device),
            cols=torch.as_tensor(cols.astype(np.int64), device=device),
            weights=torch.as_tensor(wts, dtype=dtype, device=device),
            inhom=torch.as_tensor(inh, dtype=dtype, device=device),
        )


# --------------------------------------------------------------------------
# tensor-side application (pure functions of ConstraintArrays)
# --------------------------------------------------------------------------
def distribute(ca: ConstraintArrays, u: torch.Tensor,
               homogeneous: bool = False) -> torch.Tensor:
    """u[rows] = sum w * u[cols] (+ inhom).  u: (n_nodes, n_comp)."""
    if ca.n == 0:
        return u
    uf = u.reshape(-1)
    vals = (uf[ca.cols] * ca.weights).sum(dim=1)
    if not homogeneous:
        vals = vals + ca.inhom
    out = uf.clone()
    # weights/inhom may be wider (f64) than u (f32)
    out[ca.rows] = vals.to(uf.dtype)
    return out.reshape(u.shape)


def set_zero(ca: ConstraintArrays, u: torch.Tensor) -> torch.Tensor:
    if ca.n == 0:
        return u
    out = u.reshape(-1).clone()
    # a fill on the device: a Python number set through an index tensor
    # would be copied from the host, a wait for the stream
    out.index_fill_(0, ca.rows, 0.0)
    return out.reshape(u.shape)


def condense_transpose(ca: ConstraintArrays, r: torch.Tensor) -> torch.Tensor:
    """r <- Cᵀ r: move contributions of constrained rows onto their
    dependency columns, then zero the constrained rows (the write-side half
    of the matrix-free constraint sandwich dst = Cᵀ A C src)."""
    if ca.n == 0:
        return r
    rf = r.reshape(-1).clone()
    vals = rf[ca.rows]
    src = (ca.weights * vals[:, None]).reshape(-1).to(rf.dtype)
    # in place on the clone; on the card by fixed-order class sums
    # (``index_add_`` there sums with atomics in a varying order)
    if rf.is_cuda:
        fs = fixed_scatter(ca.cols, ca.weights)
        if fs.gather is not None:
            rf[fs.targets] += class_sum(fs.gather, src)
    else:
        rf.index_add_(0, ca.cols.reshape(-1), src)
    # a fill on the device, as in ``set_zero`` (once every apply)
    rf.index_fill_(0, ca.rows, 0.0)
    return rf.reshape(r.shape)


def copy_constrained(ca: ConstraintArrays, dst: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """dst[rows] = src[rows] (reference ``operator_ns.cc:719-721``)."""
    if ca.n == 0:
        return dst
    df = dst.reshape(-1).clone()
    df[ca.rows] = src.reshape(-1)[ca.rows]
    return df.reshape(dst.shape)
