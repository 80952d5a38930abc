"""Judging applies of the GLS operator on the unit hypercube lattice.

From the configuration and the state the benchmark drew (on the node
lattice, x fastest), the reference works out the lattice's cells and
geometry and applies the plain GLS operator (``gls.sweep``) to each
judged input.  It reads the program's answers (the node positions, and
the input and output of each judged apply) only to judge them:

- ``apply_gap``: the largest gap between an apply's output and the
  reference's on the same input, relative to the largest entry of the
  reference's.

``lower_precision`` computes in float32 with TF32 matrix products: the
step below the float32 with TF32 off that the configuration states.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference import gls
from benchmark.reference.frozen.element import Element


class Reference:
    def __init__(self, config, state_lattice, device, dtype=torch.float64):
        p = config["program"]
        self.p, self.device, self.dtype = p, device, dtype
        d, P = p["dim"], p["fe_degree"]
        n = 2 ** p["n_global_refinements"]
        self.d, self.n, self.N = d, n, P * n + 1
        el = Element(d, P, P + 1)
        S, D = el.tables
        self.S = torch.as_tensor(S, dtype=dtype, device=device)
        self.D = torch.as_tensor(D, dtype=dtype, device=device)
        # cells x fastest; local nodes x fastest, as the element's
        loc = np.rint(el.support_points * P).astype(np.int64)   # (loc, d)
        cell = np.stack(np.meshgrid(*[np.arange(n)] * d, indexing="ij"),
                        -1).reshape(-1, d)[:, ::-1]            # x fastest
        ijk = P * cell[:, None, :] + loc[None, :, :]
        lin = np.zeros(ijk.shape[:2], np.int64)
        for a in reversed(range(d)):
            lin = lin * self.N + ijk[..., a]
        self.cells = torch.as_tensor(lin, device=device)
        self.u_lin = state_lattice.to(device=device, dtype=dtype)
        # BDF of equal steps dt: the weights of the configured order
        order, dt = p["bdf_order"], p["dt"]
        w0 = {1: 1.0, 2: 1.5, 3: 11.0 / 6.0}[order] / dt
        self.params = dict(nu=p["nu"], c1=p["c1"], c2=p["c2"], weight=w0,
                           stau=1.0 / dt,
                           cell_wise=p["cell_wise_stabilization"],
                           pspg=p["consider_time_derivative"])
        if p["flavor"] != "fixed":
            raise ValueError("the reference applies the fixed-point flavor")
        h = 1.0 / n
        self.jinv1 = torch.eye(d, dtype=dtype, device=device) / h
        self.jxw1 = self.S.new_tensor(el.q_weights * h ** d)

    def geometry(self, lo, hi):
        m = hi - lo
        return (self.jinv1.expand(m, self.S.shape[0], self.d, self.d),
                self.jxw1.expand(m, -1),
                self.jxw1.new_full((m,), 1.0 / self.n))

    def apply_lattice(self, x):
        x = x.to(self.dtype)
        return gls.sweep(x, self.u_lin, None, self.cells, self.S, self.D,
                         self.geometry, self.params)

    def lattice_index(self, node_pos):
        ijk = np.rint(np.asarray(node_pos) * (self.N - 1)).astype(np.int64)
        if np.abs(ijk / (self.N - 1) - node_pos).max() > 1e-9:
            return None
        lin = np.zeros(len(ijk), np.int64)
        for a in reversed(range(self.d)):
            lin = lin * self.N + ijk[:, a]
        if len(np.unique(lin)) != self.N ** self.d:
            return None
        return torch.as_tensor(lin, device=self.device)

    def judge(self, node_pos, answers) -> dict:
        idx = self.lattice_index(node_pos)
        if idx is None:
            return dict(apply_gap=float("inf"))
        worst = 0.0
        for a in answers:
            x = torch.zeros((self.N ** self.d, a["x"].shape[1]),
                            dtype=self.dtype, device=self.device)
            x[idx] = a["x"].to(self.device, self.dtype)
            want = self.apply_lattice(x)[idx]
            got = a["y"].to(self.device, torch.float64)
            gap = float((got - want.double()).abs().max()
                        / want.double().abs().max())
            if not np.isfinite(gap):
                return dict(apply_gap=float("inf"))
            worst = max(worst, gap)
        return dict(apply_gap=worst)


@contextlib.contextmanager
def lower_precision():
    """float32 with TF32 matrix products, for the control."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def judge(config, run, device) -> dict:
    ref = Reference(config, run.state, device)
    return ref.judge(run.node_pos, run.answers)
