"""Deterministic segment sums by dense multiplicity classes.

A scatter-add on the card (``index_add_``) sums with atomics, in an order
that changes from run to run.  Where the map from sources to targets is
fixed, the port instead groups the targets by how many sources they have
(the multiplicity classes, as the JAX package's seam compress and
transpose gathers do): each class is one dense (n_k, K) gather whose rows
are summed in a fixed order, and a permutation puts the class results
back in target order.  Two runs give the same bits.
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


def class_sum(cg: ClassGather, src: torch.Tensor, dim: int = 0):
    """Segment sum of ``src`` along ``dim`` with the tables of
    :func:`class_gather` (the other dimensions ride along)."""
    src = src.movedim(dim, 0)
    out = torch.cat([src[idx].sum(dim=1) for idx in cg.classes], dim=0)
    if cg.perm is not None:
        out = out[cg.perm]
    return out.movedim(0, dim)
