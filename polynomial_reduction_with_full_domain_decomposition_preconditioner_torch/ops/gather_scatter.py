"""Direct stiffness summation (dssum) on the structured point lattice.

Port of the structured, one-shard half of the JAX package's
``ops/gather_scatter.py``. A 3-D face sum runs through the hand-written
kernel ``ops/kernels.lattice_face_sum_3d`` with the Dirichlet mask and the
inverse-multiplicity weight fused in; the roll form below is its plain
arithmetic (``axes`` given, or not 3-D).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["lattice_face_sum", "structured_dssum"]


@functools.lru_cache(maxsize=None)
def _roll_masks(M: int, n: int, dtype, device):
    """hi[X]=1 iff X is the last node of a non-final element (receives from
    X+1); lo[X]=1 iff X is the first node of a non-initial element. Kept
    per (M, n, dtype, device): on a card a call then copies nothing from
    the host. The callers only read them."""
    hi = np.zeros(M); hi[n - 1::n] = 1.0; hi[M - 1] = 0.0
    lo = np.zeros(M); lo[0::n] = 1.0; lo[0] = 0.0
    return (torch.as_tensor(hi, dtype=dtype, device=device),
            torch.as_tensor(lo, dtype=dtype, device=device))


def lattice_face_sum(U, n: int, axes=None):
    """Coincident-face summation per direction:
    ``U += hi_d * roll(U,-1,d) + lo_d * roll(U,+1,d)``, in the order
    x, y, z. A 3-D lattice with ``axes=None`` runs the fused kernel."""
    if axes is None and U.dim() == 3:
        from .kernels import lattice_face_sum_3d
        return lattice_face_sum_3d(U, n)
    ndim = U.dim()
    for ax in (axes if axes is not None else range(ndim - 1, -1, -1)):
        M = U.shape[ax]
        hi, lo = _roll_masks(M, n, U.dtype, U.device)
        shape = [1] * ndim
        shape[ax] = M
        U = (U + hi.reshape(shape) * torch.roll(U, -1, ax)
             + lo.reshape(shape) * torch.roll(U, 1, ax))
    return U


def structured_dssum(U, *, n: int, dim: int, mask, inv_degree_pts,
                     apply_mask: bool = True, apply_weight: bool = False):
    """Direct stiffness summation on a one-shard structured lattice: face
    sum, then x inverse multiplicity (apply_weight), then x Dirichlet
    mask (apply_mask), fused into one kernel pass."""
    if dim != 3:
        raise NotImplementedError("the port's dssum is 3-D")
    from .kernels import lattice_face_sum_3d
    return lattice_face_sum_3d(
        U, n,
        mask=mask if apply_mask else None,
        weight=inv_degree_pts if apply_weight else None)
