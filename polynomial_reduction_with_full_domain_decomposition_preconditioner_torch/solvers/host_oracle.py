"""Host-side float64 SEM operator oracle and iterative refinement.

Port of the JAX package's ``solvers/host_oracle.py``: the f64 side of
iterative refinement kept on the HOST, for sizes where an f64 Domain
beside the f32 solver and its preconditioner does not fit in device
memory. ``HostOperator`` is a chunked numpy f64 stiffness apply (the
arithmetic of ops/sem.stiffness_apply) and a bincount direct stiffness
summation over global node ids; only the f32 correction solves run on
the device. It launches nothing itself.

Fields here are GLOBAL element-ordered flat host arrays
(num_elements * npe,); ``owned_to_global`` / ``global_to_owned`` map them
from and to the (P, E*npe) per-shard layout of ``Domain.from_device_field``
/ ``to_device_field`` (pad slots zero), over every shard of the one
process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.gll import diff_matrix

__all__ = ["HostOperator", "host_refine_solve", "HostRefinedResult",
           "owned_to_global", "global_to_owned"]


def owned_to_global(dom, vals: np.ndarray) -> np.ndarray:
    """Per-shard padded host layout (P, elems_per_shard*npe) -> GLOBAL
    element-ordered flat field (num_total_elements*npe,); pad-element
    slots are dropped through the partition's element offsets."""
    st = dom.sharded
    npe = st.num_points_per_elem
    vals = np.asarray(vals, dtype=np.float64).reshape(st.num_shards, -1)
    g = np.zeros(st.num_total_elements * npe)
    for p in range(st.num_shards):
        lo, hi = st.elem_offsets[p], st.elem_offsets[p + 1]
        g[lo * npe:hi * npe] = vals[p, :(hi - lo) * npe]
    return g


def global_to_owned(dom, vals: np.ndarray) -> np.ndarray:
    """GLOBAL element-ordered flat field -> per-shard padded host layout
    for Domain.to_device_field (pad slots zero)."""
    st = dom.sharded
    npe = st.num_points_per_elem
    vals = np.asarray(vals).reshape(-1)
    out = np.zeros((st.num_shards, st.elems_per_shard * npe),
                   dtype=vals.dtype)
    for p in range(st.num_shards):
        lo, hi = st.elem_offsets[p], st.elem_offsets[p + 1]
        out[p, :(hi - lo) * npe] = vals[lo * npe:hi * npe]
    return out


class HostOperator:
    """f64 numpy replica of the fine SEM operator on a GlobalMesh (2-D or
    3-D arrays; either package's mesh fields).

    Operates on GLOBAL element-ordered flat fields (num_elements * npe,).
    ``apply`` is the non-assembled local stiffness image; ``dssum`` the
    masked Q Q^T sum; ``residual_norm`` the solvers' sqrt(<r, Q Q^T masked
    r>) convergence metric.
    """

    def __init__(self, mesh, chunk: int = 16384):
        self.dim = mesh.dim
        self.n = mesh.poly_degree + 1
        self.npe = mesh.num_points_per_elem
        self.E = mesh.num_elements
        self.chunk = chunk
        self.geom = np.asarray(mesh.geom, dtype=np.float64)
        self.glo = np.asarray(mesh.glo_num, dtype=np.int64).reshape(-1)
        self.mask = np.asarray(mesh.dirichlet_mask,
                               dtype=np.float64).reshape(-1)
        self.num_nodes = int(self.glo.max()) + 1
        self.D = np.asarray(diff_matrix(self.n), dtype=np.float64)

    def apply(self, u: np.ndarray) -> np.ndarray:
        """A_local u, chunked over elements (f64, host)."""
        n, dim, E, npe = self.n, self.dim, self.E, self.npe
        D, Dt = self.D, self.D.T
        u = np.asarray(u, dtype=np.float64).reshape(E, npe)
        out = np.empty_like(u)

        def contract_last(M, U):
            # out[..., i] = sum_k M[i, k] U[..., k]
            return np.einsum("ik,...k->...i", M, U, optimize=True)

        for s in range(0, E, self.chunk):
            e = min(s + self.chunk, E)
            C = e - s
            if dim == 2:
                U = u[s:e].reshape(C, n, n)
                G = self.geom[s:e].reshape(C, n, n, 3)
                Dr = contract_last(D, U)
                Ds = np.swapaxes(contract_last(D, np.swapaxes(U, 1, 2)), 1, 2)
                Wr = G[..., 0] * Dr + G[..., 2] * Ds
                Ws = G[..., 2] * Dr + G[..., 1] * Ds
                Au = contract_last(Dt, Wr)
                Au += np.swapaxes(
                    contract_last(Dt, np.swapaxes(Ws, 1, 2)), 1, 2)
            else:
                U = u[s:e].reshape(C, n, n, n)
                G = self.geom[s:e].reshape(C, n, n, n, 6)
                Dr = contract_last(D, U)
                Ds = np.swapaxes(contract_last(D, np.swapaxes(U, 2, 3)), 2, 3)
                Dt_ = np.swapaxes(contract_last(D, np.swapaxes(U, 1, 3)), 1, 3)
                Wr = G[..., 0] * Dr + G[..., 3] * Ds + G[..., 4] * Dt_
                Ws = G[..., 3] * Dr + G[..., 1] * Ds + G[..., 5] * Dt_
                Wt = G[..., 4] * Dr + G[..., 5] * Ds + G[..., 2] * Dt_
                Au = contract_last(Dt, Wr)
                Au += np.swapaxes(
                    contract_last(Dt, np.swapaxes(Ws, 2, 3)), 2, 3)
                Au += np.swapaxes(
                    contract_last(Dt, np.swapaxes(Wt, 1, 3)), 1, 3)
            out[s:e] = Au.reshape(C, npe)
        return out.reshape(-1)

    def dssum(self, r: np.ndarray, apply_mask: bool = True) -> np.ndarray:
        """Masked Q Q^T r over shared global node ids."""
        s = np.bincount(self.glo, weights=r.reshape(-1),
                        minlength=self.num_nodes)
        out = s[self.glo]
        if apply_mask:
            out *= self.mask
        return out

    def residual_norm(self, r: np.ndarray) -> float:
        return float(np.sqrt(max(np.dot(r.reshape(-1), self.dssum(r)), 0.0)))

    def residual(self, u, f):
        r = np.asarray(f, dtype=np.float64) - self.apply(u)
        return r, self.residual_norm(r)


@dataclass
class HostRefinedResult:
    u: np.ndarray                 # f64 host solution (E*npe,)
    rel_residual: float
    cycles: int
    inner_iterations: int
    history: list
    converged: bool


def host_refine_solve(host_op: HostOperator, dom32, solve32, f64,
                      *, tolerance: float = 1.0e-7, max_cycles: int = 10,
                      verbose=None) -> HostRefinedResult:
    """Solve A u = f to ``tolerance`` relative f64 residual, all f64
    arithmetic on the host and the f32 solver as the correction engine
    (classical iterative refinement).

    dom32: the f32 Domain whose solver produced ``solve32`` (used only
      for host <-> device field conversion).
    f64: f64 host right-hand side in GLOBAL element order, e.g.
      host_op.apply(u*).
    """
    f64 = np.asarray(f64, dtype=np.float64).reshape(-1)
    f_norm = host_op.residual_norm(f64)
    u = np.zeros_like(f64)
    if f_norm == 0.0:
        return HostRefinedResult(u=u, rel_residual=0.0, cycles=0,
                                 inner_iterations=0, history=[0.0],
                                 converged=True)
    history = []
    inner_total = 0
    for cycle in range(max_cycles):
        r, rn = host_op.residual(u, f64)
        rel = rn / f_norm
        history.append(rel)
        if verbose:
            verbose(cycle, rel)
        if rel < tolerance:
            return HostRefinedResult(u=u, rel_residual=rel, cycles=cycle,
                                     inner_iterations=inner_total,
                                     history=history, converged=True)
        rd = dom32.to_device_field(global_to_owned(
            dom32, r.astype(np.float32)))
        res = solve32(rd)
        inner_total += int(res.iterations)
        corr = owned_to_global(dom32, dom32.from_device_field(res.u))
        u = u + corr
    r, rn = host_op.residual(u, f64)
    rel = rn / f_norm
    history.append(rel)
    if verbose:
        verbose(max_cycles, rel)
    return HostRefinedResult(u=u, rel_residual=rel, cycles=max_cycles,
                             inner_iterations=inner_total, history=history,
                             converged=rel < tolerance)
