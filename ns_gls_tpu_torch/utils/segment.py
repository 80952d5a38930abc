"""Deterministic segment sums by dense multiplicity classes.

A scatter-add on the card (``index_add_``) sums with atomics, in an order
that changes from run to run.  Where the map from sources to targets is
fixed, the port instead groups the targets by how many sources they have
(the multiplicity classes, as the JAX package's seam compress and
transpose gathers do): each class is one dense (n_k, K) gather whose rows
are summed in a fixed order, and a permutation puts the class results
back in target order.  Two runs give the same bits.

:class:`SeamSums` is the same sum as one launch of a CUDA kernel
(``csrc/seam_sum.cu``) over a CSR table, with a plain version beside it:
the seam sums of the patch-2D and patch-3D sweeps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class ClassGather(NamedTuple):
    classes: tuple                  # per class: (n_k, K) source positions
    perm: Optional[torch.Tensor]    # class order -> target order, or None


def class_gather(target: np.ndarray, n_out: int, device) -> ClassGather:
    """Tables that sum, for every target 0..n_out-1, the source positions
    p with ``target[p]`` equal to it.  Every target needs a source."""
    target = np.asarray(target, np.int64)
    order = np.argsort(target, kind="stable")
    uniq, starts, counts = np.unique(target[order], return_index=True,
                                     return_counts=True)
    if len(uniq) != n_out or not (uniq == np.arange(n_out)).all():
        raise ValueError("every target needs at least one source")
    classes, node_order = [], []
    for K in np.unique(counts):
        sel = np.nonzero(counts == K)[0]
        idx = order[starts[sel][:, None] + np.arange(K)[None, :]]
        classes.append(torch.as_tensor(idx, device=device))
        node_order.append(sel)
    node_order = np.concatenate(node_order)
    perm = None
    if not (node_order == np.arange(n_out)).all():
        inv = np.empty(n_out, np.int64)
        inv[node_order] = np.arange(n_out)
        perm = torch.as_tensor(inv, device=device)
    return ClassGather(tuple(classes), perm)


def _in_order(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``src[idx[:, k]]`` summed one k after the other: the order of a
    serial scatter-add over the sources."""
    out = src[idx[:, 0]]
    for k in range(1, idx.shape[1]):
        out = out + src[idx[:, k]]
    return out


def class_sum(cg: ClassGather, src: torch.Tensor, dim: int = 0,
              in_order: bool = False):
    """Segment sum of ``src`` along ``dim`` with the tables of
    :func:`class_gather` (the other dimensions ride along).  With
    ``in_order`` each target's sources are added one after the other in
    source order, as a serial scatter-add would (one gather per source
    slot instead of one per class)."""
    src = src.movedim(dim, 0)
    if in_order:
        out = torch.cat([_in_order(src, idx) for idx in cg.classes], dim=0)
    else:
        out = torch.cat([src[idx].sum(dim=1) for idx in cg.classes], dim=0)
    if cg.perm is not None:
        out = out[cg.perm]
    return out.movedim(0, dim)


class TargetSums(NamedTuple):
    gather: ClassGather     # sums over the targets that have a source
    targets: torch.Tensor   # (n_present,) those targets, ascending


def target_sums(target: np.ndarray, device) -> TargetSums:
    """Tables that sum, for every value t present in ``target``, the
    source positions p with ``target[p] == t`` (targets without a source
    are left out, unlike :func:`class_gather`)."""
    uniq, inv = np.unique(np.asarray(target, np.int64).reshape(-1),
                          return_inverse=True)
    return TargetSums(class_gather(inv, len(uniq), device),
                      torch.as_tensor(uniq, device=device))


class FixedScatter(NamedTuple):
    """A scatter-add over a fixed map as class sums: the sum of the
    sources of every target in ``targets`` (``gather`` over the flat
    source positions); no targets when nothing is scattered."""

    gather: Optional[ClassGather]
    targets: torch.Tensor


# index tensor id -> (weak reference to it, its FixedScatter)
_FIXED_SCATTERS: dict = {}


def fixed_scatter(index: torch.Tensor,
                  weights: torch.Tensor) -> FixedScatter:
    """The class-sum tables of ``out[index[i, k]] += weights[i, k] * ...``
    over the entries of nonzero weight (the others add exactly zero),
    built once for the index tensor (a map that stays fixed: a transfer's
    or a constraint set's) and cached on it.  On the card this replaces
    ``index_add_``, whose atomics sum in an order that changes from run to
    run."""
    import weakref

    key = id(index)
    hit = _FIXED_SCATTERS.get(key)
    if hit is not None and hit[0]() is index:
        return hit[1]
    idx = index.reshape(-1).cpu().numpy()
    sel = np.nonzero(weights.reshape(-1).cpu().numpy() != 0)[0]
    if len(sel) == 0:
        fs = FixedScatter(None, index.new_zeros(0))
    else:
        ts = target_sums(idx[sel], index.device)
        sel_t = torch.as_tensor(sel, device=index.device)
        fs = FixedScatter(
            ClassGather(tuple(sel_t[c] for c in ts.gather.classes),
                        ts.gather.perm), ts.targets)
    _FIXED_SCATTERS[key] = (weakref.ref(index), fs)
    return fs


# ---------------------------------------------------------------------------
# seam sums: one launch over a CSR table (csrc/seam_sum.cu)
# ---------------------------------------------------------------------------
class SeamSums(NamedTuple):
    """For each node n, the rows ``sources[offsets[n]:offsets[n + 1]]`` of
    a sweep's output tiles that hold a part of it, ascending (int32)."""

    offsets: torch.Tensor   # (n_out + 1,)
    sources: torch.Tensor   # (n_rows,) every row belongs to one node


def seam_sums(target: np.ndarray, n_out: int, device,
              every_node: bool = True) -> SeamSums:
    """The table that sums, for every node 0..n_out-1, the rows p with
    ``target[p]`` equal to it.  Every node needs a row, unless
    ``every_node`` is false: a node without one then sums to zero (a
    shard's window, whose ghost slots of constraint masters no tile of
    the shard touches)."""
    target = np.asarray(target, np.int64).reshape(-1)
    counts = np.bincount(target, minlength=n_out)
    if len(counts) != n_out or (every_node and (counts == 0).any()):
        raise ValueError("every node needs at least one row")
    if len(target) >= 2**31:
        raise ValueError("the rows need 64-bit positions")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(target, kind="stable")
    return SeamSums(torch.as_tensor(offsets.astype(np.int32), device=device),
                    torch.as_tensor(order.astype(np.int32), device=device))


def seam_sum_plain(ss: SeamSums, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the seam-sum kernel: src (n_rows, C) ->
    (n_out, C), each node's rows added one after the other in table order,
    starting from zero (the kernel's order, so the same sums).  A node
    with fewer rows than the most adds zeros at the end, which changes no
    sum."""
    off = ss.offsets.long()
    start, counts = off[:-1], off[1:] - off[:-1]
    n_rows = ss.sources.shape[0]
    out = src.new_zeros((len(counts), src.shape[1]))
    if n_rows == 0:
        return out
    k = torch.arange(int(counts.max()), device=src.device)
    pos = (start[:, None] + k[None, :]).clamp(max=n_rows - 1)
    rows = torch.where(k[None, :] < counts[:, None], ss.sources[pos].long(),
                       n_rows)
    padded = torch.cat([src, src.new_zeros((1, src.shape[1]))])
    for j in range(rows.shape[1]):
        out = out + padded[rows[:, j]]
    return out


class SeamSumKernel:
    """ctypes binding of ``csrc/seam_sum.cu``; the library is built at
    first use (``utils/cuda_build.py``)."""

    # launches of the CUDA kernel in this process: one per successful
    # ``launch``, nowhere else
    launches = 0
    _fn = None

    @classmethod
    def _load(cls):
        if cls._fn is None:
            import ctypes

            from ns_gls_tpu_torch.utils.cuda_build import load_library

            fn = load_library("seam_sum").seam_sum_launch
            vp, ci = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [vp, vp, vp, vp, ci, ci, vp]
            fn.restype = ctypes.c_int
            cls._fn = fn
        return cls._fn

    @classmethod
    def launch(cls, ss: SeamSums, src: torch.Tensor) -> torch.Tensor:
        """src (n_rows, C), C = 3 or 4 components a row -> (n_out, C)."""
        n_rows = ss.sources.shape[0]
        if not src.is_cuda or src.dtype != torch.float32:
            raise TypeError("seam sums: need a float32 CUDA tensor")
        if (src.dim() != 2 or src.shape[0] != n_rows
                or src.shape[1] not in (3, 4) or not src.is_contiguous()):
            raise ValueError(f"seam sums: need a contiguous ({n_rows}, 3 "
                             f"or 4) tensor, got {tuple(src.shape)}")
        for t in ss:
            if t.device != src.device or t.dtype != torch.int32:
                raise ValueError("seam-sum tables: int32 on src's device")
        n_out = ss.offsets.shape[0] - 1
        C = src.shape[1]
        out = torch.empty((n_out, C), dtype=torch.float32, device=src.device)
        err = cls._load()(
            src.data_ptr(), ss.offsets.data_ptr(), ss.sources.data_ptr(),
            out.data_ptr(), n_out, C,
            torch.cuda.current_stream(src.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"seam-sum kernel launch failed: CUDA error "
                               f"{err}")
        cls.launches += 1
        return out


def seam_sum(ss: SeamSums, src: torch.Tensor) -> torch.Tensor:
    """The seam sums: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    if src.is_cuda:
        return SeamSumKernel.launch(ss, src)
    if src.device.type != "cpu":
        raise TypeError(f"seam sums: unsupported device {src.device}")
    return seam_sum_plain(ss, src)
