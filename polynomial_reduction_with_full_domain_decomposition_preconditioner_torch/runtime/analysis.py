"""Cross-validation and convergence-history analysis.

Port of the JAX package's ``runtime/analysis.py``: in-repo oracles for
small problems.

- ``assembled_operator_dense``: the assembled SEM operator Q^T A_local Q
  as a dense host matrix, built column by column with the port's
  element-layout stiffness apply (ops/sem.stiffness_apply) on CPU f64
  tensors; tests hold the matrix-free Domain apply, and the solvers'
  iteration counts, to it.
- ``compare_histories``: the deviation of two residual histories.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sem
from ..utils.gll import diff_matrix

__all__ = ["assembled_operator_dense", "compare_histories"]


def assembled_operator_dense(mesh) -> np.ndarray:
    """Dense assembled stiffness matrix on the global nodes of a host mesh
    (2-D or 3-D, either package's ``GlobalMesh`` fields). A Dirichlet
    node's row and column are zero but for a 1 on the diagonal."""
    glo = np.asarray(mesh.glo_num, dtype=np.int64)
    E, npe = glo.shape
    N = int(glo.max()) + 1
    geom = np.asarray(mesh.geom, dtype=np.float64)
    G = tuple(torch.as_tensor(np.ascontiguousarray(geom[..., k]))
              for k in range(geom.shape[-1]))
    D = torch.as_tensor(diff_matrix(mesh.poly_degree + 1),
                        dtype=torch.float64)
    A = np.zeros((N, N))
    for v in range(npe):
        # column v of every element's local operator, all elements at once
        u = torch.zeros((E, npe), dtype=torch.float64)
        u[:, v] = 1.0
        au = sem.stiffness_apply(u, G, D, mesh.dim).numpy()
        # A[glo[e], glo[e, v]] += au[e], element after element
        np.add.at(A, (glo, glo[:, v:v + 1]), au)
    mask = np.ones(N)
    np.minimum.at(mask, glo.reshape(-1),
                  np.asarray(mesh.dirichlet_mask, np.float64).reshape(-1))
    return A * mask[:, None] * mask[None, :] + np.diag(1.0 - mask)


def compare_histories(hist_a, hist_b, rtol: float = 0.2) -> dict:
    """Two residual histories (non-finite entries dropped): their
    iteration counts and the largest relative deviation of their logs
    over the common prefix; ``match`` if the counts differ by at most 2
    and that deviation stays under ``rtol``."""
    a = np.asarray([h for h in np.asarray(hist_a) if np.isfinite(h)])
    b = np.asarray([h for h in np.asarray(hist_b) if np.isfinite(h)])
    n = min(a.size, b.size)
    la = np.log(np.maximum(a[:n], 1e-300))
    lb = np.log(np.maximum(b[:n], 1e-300))
    rel = np.abs(la - lb) / np.maximum(np.abs(la), 1.0)
    dev = float(rel.max()) if n else 0.0
    return {
        "iters_a": int(a.size - 1),
        "iters_b": int(b.size - 1),
        "max_log_rel_dev": dev,
        "match": abs(a.size - b.size) <= 2 and dev < rtol,
    }
