"""Node-sharded structured operator: slab partition and plane exchange.

Port of ``ns_gls_tpu/parallel/structured_sharded.py`` (the counterpart
of the reference's partitioned vectors with ghost update and compress,
``operator_ns.cc:260,346,634-639``; ``main.cc:265-266``), driven by one
process over a list of devices, as ``parallel/halo.py``:

- the cell slabs (z layers in 3D, y rows in 2D) split into equal,
  contiguous blocks over the shards; each shard stores only its own node
  planes of the class-grouped lattice (``ops/structured.py``
  ``class_offsets``): classes 1..P-1 of its m slabs, then its m + 1
  class-0 planes, the top one shared with the next shard,
- the fused structured sweep (``ops/structured.py`` ``structured_sweep``:
  ``structured3d_kernel<P>`` or ``structured2d_kernel<P>`` on the card,
  each under its own plan at the shard's cell shape) runs on each shard
  with no input exchange: the shared class-0 plane is the ghost layer,
- after the sweeps, two plane-sized copies per neighbour pair sum the
  shared planes: a shard's bottom class-0 plane goes down to the shard
  below, its top one up to the shard above (JAX's two ``ppermute``),
- dot products weight the shared planes 1/2 on both holders and sum the
  shards' partials on the first shard's device in shard order.

Distributed vectors are lists of per-shard ``(C, m_pl, Yr, Nx)`` tensors,
``m_pl = P m + 1``; :meth:`StructuredShardedOperator.scatter` and
:meth:`~StructuredShardedOperator.gather_global` convert from and to the
global ``(C,) + lattice_shape`` layout (set-up and output only).  Like
JAX's operator this is the raw cell sweep: Dirichlet constraints stay
with the caller, and no driver path selects it (the JAX halo path puts
the general sweep on structured spaces).
"""

from __future__ import annotations

import numpy as np
import torch

from ns_gls_tpu_torch.ops.structured import (
    StructuredSweep,
    build_structured_tables,
    lattice_shape,
    structured_sweep,
)
from ns_gls_tpu_torch.parallel.dist import on_device
from ns_gls_tpu_torch.parallel.sharding import make_device_mesh


def local_plane_index(P: int, n_slabs: int, m: int, dev: int) -> np.ndarray:
    """Global class-grouped plane indices held by shard ``dev`` (local
    layout: classes 1..P-1 of its m slabs, then its m + 1 class-0
    planes)."""
    s0 = dev * m
    idx = []
    for k in range(1, P):
        base = (k - 1) * n_slabs
        idx.extend(range(base + s0, base + s0 + m))
    base = (P - 1) * n_slabs
    idx.extend(range(base + s0, base + s0 + m + 1))
    return np.asarray(idx, np.int64)


def _copy_to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A copy on ``dev`` that shares no storage with ``t`` (``.to`` onto
    the same device aliases)."""
    return t.to(dev, copy=True)


class StructuredShardedOperator:
    """Plane-exchange apply of a structured-lattice NS operator over
    ``devices`` (a device may repeat: four shards on one card, or on the
    CPU).  ``n_slabs`` must be divisible by the number of shards."""

    def __init__(self, op, devices):
        sw = op._fast
        if isinstance(sw, StructuredSweep):
            tables = sw.tables
        else:
            tables = build_structured_tables(op)
            if tables is None:
                raise ValueError("operator/space is not structured-"
                                 "compatible")
            sw = StructuredSweep(op, tables)
        self.op = op
        self.devices = make_device_mesh(devices)
        self.n_dev = n_dev = len(self.devices)
        cs = tables.cell_shape
        n_slabs = cs[-1]
        if n_slabs % n_dev:
            raise ValueError(f"{n_slabs} slabs not divisible by {n_dev} "
                             "devices")
        self.m = m = n_slabs // n_dev
        self.P = P = tables.P
        self.C = tables.d + 1
        self.n_planes, self.Yr, self.Nx = lattice_shape(P, cs)
        self.m_pl = P * m + 1
        self.cls0 = (P - 1) * m           # local index of the bottom plane
        self.consider_dt = sw.consider_dt
        self.cell_wise = sw.cell_wise
        self.nu, self.c1, self.c2 = sw.nu, sw.c1, sw.c2

        # per shard: its slabs' cells (the slab axis is the outermost of
        # the lattice cell order) and copies of the 1D tables
        per_slab = int(np.prod(cs[:-1]))
        loc_shape = tuple(cs[:-1]) + (m,)
        self.tables = []
        for k, dev in enumerate(self.devices):
            sl = slice(k * m * per_slab, (k + 1) * m * per_slab)
            self.tables.append(tables._replace(
                cell_shape=loc_shape,
                S1=_copy_to(tables.S1, dev), D1=_copy_to(tables.D1, dev),
                jinv=_copy_to(tables.jinv[sl], dev).contiguous(),
                jxw=_copy_to(tables.jxw[sl], dev).contiguous(),
                h=_copy_to(tables.h[sl], dev).contiguous()))
        self._gidx_np = [local_plane_index(P, n_slabs, m, k)
                         for k in range(n_dev)]
        self._gidx = [torch.as_tensor(g, device=dev)
                      for g, dev in zip(self._gidx_np, self.devices)]
        # ownership weights: a shared plane is held twice, weight 1/2 on
        # each holder
        self.plane_weight = []
        for k, dev in enumerate(self.devices):
            w = torch.ones(self.m_pl, dtype=torch.float64)
            if k > 0:
                w[self.cls0] = 0.5
            if k < n_dev - 1:
                w[self.cls0 + m] = 0.5
            self.plane_weight.append(w.reshape(1, -1, 1, 1).to(dev))
        # elements one apply's exchange moves: two class-0 planes per
        # neighbour pair (and the count moved so far, for the tests)
        self.exchange_elements = 2 * (n_dev - 1) * self.C * self.Yr * self.Nx
        self.elements_moved = 0

    # ------------------------------------------------------------------
    def scatter(self, uT: torch.Tensor) -> list:
        """Global ``(C, n_planes, Yr, Nx)`` -> per-shard ``(C, m_pl, Yr,
        Nx)`` on each shard's device."""
        return [uT[:, torch.as_tensor(g, device=uT.device)].to(dev)
                .contiguous()
                for g, dev in zip(self._gidx_np, self.devices)]

    def gather_global(self, parts) -> torch.Tensor:
        """Per-shard parts -> the global lattice on the first shard's
        device; a shared plane is equal on both holders after an apply,
        and the later shard's copy is the one kept."""
        dev = self.devices[0]
        out = torch.zeros((parts[0].shape[0], self.n_planes, self.Yr,
                           self.Nx), dtype=parts[0].dtype, device=dev)
        for g, p in zip(self._gidx, parts):
            out[:, g.to(dev)] = p.to(dev)
        return out

    def local_sweeps(self, weight, stau, u, ul, vo, flavor: str) -> list:
        """Each shard's fused sweep on its own planes (partial sums on the
        shared planes)."""
        sc = dict(weight=float(weight), stau=float(stau), nu=self.nu,
                  c1=self.c1, c2=self.c2)
        out = []
        for k, dev in enumerate(self.devices):
            with on_device(dev):
                out.append(structured_sweep(
                    self.tables[k], sc, u[k].contiguous(),
                    ul[k].contiguous(), vo[k].contiguous(), flavor,
                    self.consider_dt, self.cell_wise))
        return out

    def exchange(self, rs: list) -> list:
        """Sum the shared class-0 planes in place: each shard's bottom
        plane is added to the top plane of the shard below, its top plane
        to the bottom plane of the shard above.  The planes are copied
        before any is added to, so the order of the adds does not
        matter."""
        lo, hi = self.cls0, self.cls0 + self.m
        dv = self.devices
        from_up = [_copy_to(rs[k + 1][:, lo], dv[k])
                   for k in range(self.n_dev - 1)]
        from_dn = [_copy_to(rs[k][:, hi], dv[k + 1])
                   for k in range(self.n_dev - 1)]
        for k in range(self.n_dev - 1):
            rs[k][:, hi] += from_up[k]
            rs[k + 1][:, lo] += from_dn[k]
            self.elements_moved += from_up[k].numel() + from_dn[k].numel()
        return rs

    def apply(self, weight, stau, u, ul, vo, flavor: str) -> list:
        """The sharded apply: the local sweeps, then the plane exchange."""
        return self.exchange(self.local_sweeps(weight, stau, u, ul, vo,
                                               flavor))

    def dot(self, a, b) -> torch.Tensor:
        """The global dot product of two distributed vectors (shared
        planes counted once), in f64, summed on the first shard's device
        in shard order."""
        dev = self.devices[0]
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for x, y, w in zip(a, b, self.plane_weight):
            total = total + (x.double() * y.double() * w).sum().to(dev)
        return total
