"""Distributed vectors: one ``(n_own_max, C)`` tensor per shard.

The JAX package's ``(n_dev, n_own_max, C)`` layout split by shard: shard
d holds the values of the nodes it owns in its window order, followed by
zero rows up to the largest shard's count, on its own device.  The zero
pads make dot products and norms need no ownership mask.

Arithmetic acts shard by shard.  A scalar (a number or a 0-dim tensor)
is moved to each shard's device; a dot product or norm sums its f64
per-shard partials on the first shard's device, in shard order.
"""

from __future__ import annotations

import contextlib

import torch


def on_device(dev: torch.device):
    """The CUDA device ``dev`` as the current one inside the block (kernel
    launches go to the current device); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _scalar_to(s, dev):
    return s.to(dev) if isinstance(s, torch.Tensor) else s


class DistVector:
    """Per-shard parts; rows past a shard's own count are zero."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    # -- shape and type ---------------------------------------------------
    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        """The first shard's device, where sums over shards land."""
        return self.parts[0].device

    def to(self, dtype) -> "DistVector":
        return DistVector(p.to(dtype) for p in self.parts)

    def zeros_like(self) -> "DistVector":
        return DistVector(torch.zeros_like(p) for p in self.parts)

    # -- arithmetic -------------------------------------------------------
    def _zip(self, other, fn):
        if isinstance(other, DistVector):
            return DistVector(fn(a, b) for a, b in zip(self.parts,
                                                       other.parts))
        return DistVector(fn(a, _scalar_to(other, a.device))
                          for a in self.parts)

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._zip(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._zip(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._zip(other, lambda a, b: a / b)

    def div_or_zero(self, s: torch.Tensor) -> "DistVector":
        """self / s where s > 0, else zero (no host sync)."""
        return self._zip(s, lambda a, b: torch.where(b > 0, a / b,
                                                     torch.zeros_like(a)))

    # -- reductions -------------------------------------------------------
    def _sum_partials(self, partials):
        dev = self.device
        total = partials[0]
        for p in partials[1:]:
            total = total + p.to(dev)
        return total

    def dot(self, other: "DistVector") -> torch.Tensor:
        """f64-accumulated dot product (f32 parts), rounded back to the
        vector dtype; a 0-dim tensor on the first shard's device."""
        if self.dtype == torch.float32:
            partials = [torch.dot(a.reshape(-1).double(), b.reshape(-1)
                                  .double())
                        for a, b in zip(self.parts, other.parts)]
            return self._sum_partials(partials).to(self.dtype)
        return self._sum_partials([torch.dot(a.reshape(-1), b.reshape(-1))
                                   for a, b in zip(self.parts, other.parts)])

    def norm(self) -> torch.Tensor:
        if self.dtype == torch.float32:
            partials = [torch.dot(a.reshape(-1).double(), a.reshape(-1)
                                  .double()) for a in self.parts]
            return torch.sqrt(self._sum_partials(partials)).to(self.dtype)
        return torch.sqrt(self._sum_partials(
            [torch.dot(a.reshape(-1), a.reshape(-1)) for a in self.parts]))

    # -- a Krylov basis of such vectors -----------------------------------
    def basis(self, n: int) -> "DistBasis":
        return DistBasis([p.new_zeros((n,) + tuple(p.shape))
                          for p in self.parts])


class DistBasis:
    """``n`` distributed vectors stored row by row in each shard."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    def __getitem__(self, j: int) -> DistVector:
        return DistVector(p[j] for p in self.parts)

    def __setitem__(self, j: int, v: DistVector):
        for p, q in zip(self.parts, v.parts):
            p[j] = q                 # in place on the basis's own rows

    def combine(self, y: torch.Tensor, j: int) -> DistVector:
        """sum_i<j y[i] * self[i], per shard."""
        out = []
        for p in self.parts:
            yd = y.to(p.device).reshape((-1,) + (1,) * (p.dim() - 1))
            out.append((yd * p[:j]).sum(dim=0))
        return DistVector(out)
