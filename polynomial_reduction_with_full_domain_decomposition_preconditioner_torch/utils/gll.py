"""Gauss-Lobatto-Legendre (GLL) spectral primitives.

The port's own copy of the JAX package's ``utils/gll.py`` (the port
imports nothing of that package). Host-side setup math: pure numpy in
float64, cached, converted to tensors by callers. The tables are bitwise
equal to the JAX package's (tests/test_torch_gll_mesh.py).

All matrices use row-major "operator" convention: ``(D @ u)[i] = u'(r_i)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "gll_points_weights",
    "diff_matrix",
    "interp_matrix",
    "lagrange_eval",
]


def _legendre_and_deriv(n: int, x: np.ndarray):
    """Value and derivative of the Legendre polynomial P_n at points x."""
    x = np.asarray(x, dtype=np.float64)
    p_prev = np.ones_like(x)
    if n == 0:
        return p_prev, np.zeros_like(x)
    p = x.copy()
    for k in range(2, n + 1):
        p_prev, p = p, ((2 * k - 1) * x * p - (k - 1) * p_prev) / k
    # P'_n(x) = n (x P_n - P_{n-1}) / (x^2 - 1); endpoints handled by callers.
    denom = x * x - 1.0
    safe = np.where(np.abs(denom) < 1e-300, 1.0, denom)
    dp = n * (x * p - p_prev) / safe
    return p, dp


@lru_cache(maxsize=None)
def gll_points_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n GLL nodes on [-1, 1] and their quadrature weights.

    Nodes are the endpoints plus the roots of P'_{n-1}; weights are
    2 / (n(n-1) P_{n-1}(r)^2).
    """
    if n < 2:
        if n == 1:
            return np.array([0.0]), np.array([2.0])
        raise ValueError(f"need n >= 2 GLL points, got {n}")

    m = n - 1  # polynomial degree
    # Chebyshev-Lobatto initial guess, refined with Newton on P'_m.
    r = -np.cos(np.pi * np.arange(n) / m)
    for _ in range(100 if n > 2 else 0):
        p, dp = _legendre_and_deriv(m, r)
        # f = P'_m, f' = P''_m = (2x P'_m - m(m+1) P_m) / (1 - x^2)
        denom = 1.0 - r * r
        interior = slice(1, n - 1)
        f = dp[interior]
        fp = (2.0 * r[interior] * dp[interior] - m * (m + 1) * p[interior]) / denom[interior]
        dr = f / fp
        r[interior] -= dr
        if np.max(np.abs(dr)) < 1e-15:
            break
    r[0], r[-1] = -1.0, 1.0
    # enforce symmetry exactly
    r = 0.5 * (r - r[::-1])

    p, _ = _legendre_and_deriv(m, r)
    w = 2.0 / (m * (m + 1) * p * p)
    return r, w


def _barycentric_weights(r: np.ndarray) -> np.ndarray:
    diff = r[:, None] - r[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


@lru_cache(maxsize=None)
def diff_matrix(n: int) -> np.ndarray:
    """Differentiation matrix D on n GLL nodes: (D @ u)[i] = u'(r_i)."""
    r, _ = gll_points_weights(n)
    wb = _barycentric_weights(r)
    diff = r[:, None] - r[None, :]
    np.fill_diagonal(diff, 1.0)
    D = (wb[None, :] / wb[:, None]) / diff
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -np.sum(D, axis=1))  # exact row sums = 0
    return D


def lagrange_eval(r: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Matrix L with L[i, j] = ell_j(x_i), the j-th Lagrange cardinal
    polynomial on nodes ``r`` evaluated at points ``x``.

    Uses the barycentric form; exact when x coincides with a node.
    """
    r = np.asarray(r, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    wb = _barycentric_weights(r)
    diff = x[:, None] - r[None, :]
    exact = np.isclose(diff, 0.0, atol=1e-14)
    safe = np.where(exact, 1.0, diff)
    terms = wb[None, :] / safe
    L = terms / np.sum(terms, axis=1, keepdims=True)
    hit = exact.any(axis=1)
    L[hit] = exact[hit].astype(np.float64)
    return L


@lru_cache(maxsize=None)
def interp_matrix(n_from: int, n_to: int) -> np.ndarray:
    """1-D interpolation matrix J with shape (n_to, n_from) from the GLL
    grid with n_from nodes to the GLL grid with n_to nodes: (J @ u_c)(x_f).
    Its transpose is the restriction."""
    r_from, _ = gll_points_weights(n_from)
    r_to, _ = gll_points_weights(n_to)
    return lagrange_eval(r_from, r_to)
