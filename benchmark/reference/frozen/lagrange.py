"""Frozen copy of ``ns_gls_tpu_torch/fem/lagrange.py``, taken when the
benchmark was defined, so that the reference works out its geometry
without the program. Changed: imports point at this folder; the parts
the reference does not use are left out.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def gauss_points_1d(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0,1] -> (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x + 1.0), 0.5 * w)


@functools.lru_cache(maxsize=None)
def gauss_lobatto_points_1d(n: int) -> np.ndarray:
    """n Gauss-Lobatto points on [0,1] (includes endpoints), n >= 2."""
    if n == 2:
        return np.array([0.0, 1.0])
    # interior points: roots of P'_{n-1}
    leg = np.polynomial.legendre.Legendre.basis(n - 1)
    interior = leg.deriv().roots()
    pts = np.concatenate([[-1.0], np.sort(interior.real), [1.0]])
    return 0.5 * (pts + 1.0)


@functools.lru_cache(maxsize=None)
def lagrange_weights(nodes: tuple) -> np.ndarray:
    """Barycentric weights for Lagrange interpolation on `nodes`."""
    x = np.asarray(nodes)
    n = len(x)
    w = np.ones(n)
    for i in range(n):
        w[i] = 1.0 / np.prod(x[i] - np.delete(x, i))
    return w


def eval_lagrange(nodes, pts):
    """Evaluate Lagrange basis on `nodes` at `pts`.

    Returns (values, derivatives) with shape (len(pts), len(nodes)).
    """
    x = np.asarray(nodes, dtype=np.float64)
    p = np.atleast_1d(np.asarray(pts, dtype=np.float64))
    n, m = len(x), len(p)
    vals = np.empty((m, n))
    ders = np.empty((m, n))
    for j in range(n):
        others = np.delete(x, j)
        denom = np.prod(x[j] - others)
        # value: prod(p - others) / denom
        diffs = p[:, None] - others[None, :]           # (m, n-1)
        vals[:, j] = np.prod(diffs, axis=1) / denom
        # derivative: sum over k of prod_{l != k}(p - others_l) / denom
        der = np.zeros(m)
        for k in range(n - 1):
            der += np.prod(np.delete(diffs, k, axis=1), axis=1)
        ders[:, j] = der / denom
    return vals, ders

