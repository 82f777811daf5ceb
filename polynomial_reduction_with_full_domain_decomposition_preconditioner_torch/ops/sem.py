"""Matrix-free SEM stiffness operator on point-lattice fields.

Port of the JAX package's ``ops/sem.py`` (lattice forms). The 3-D apply
runs through the hand-written kernel ``ops/kernels.stiffness_lattice_3d``
(its plain twin on CPU tensors); ``dmul`` is the generic per-element axis
contraction used by the plain forms and by setup code. The result is the
non-assembled (local) operator image; direct stiffness summation is a
separate op (ops/gather_scatter.py).

Both forms also take a (P, Mz, My, Mx) stack of slab shards: every shard
is a whole number of elements in z and both are element-local, so they
run once on the contiguous (P*Mz, My, Mx) view.

The element-layout forms (``stiffness_apply``, ``stiffness_diagonal``)
serve unstructured meshes: fields (..., E, n^3) with the local ordering
x fastest, geometry a tuple of six such factor tensors. The apply runs
kernel K1 on the (E*n, n, n) lattice view of the element stack, in which
every n^3 block is one element (the six factors viewed alike); the
diagonal is torch matmuls, accumulated in f32 for bf16 factors.
"""

from __future__ import annotations

import torch

__all__ = ["dmul", "stiffness_apply_lattice", "stiffness_diagonal_lattice",
           "stiffness_apply", "stiffness_diagonal"]


def stiffness_apply(u, G, D, dim: int):
    """Local SEM stiffness apply element by element on an element-layout
    field u (..., E, n^3), G the six factors (G_rr, G_ss, G_tt, G_rs,
    G_rt, G_st) of u's shape: Au = sum_a D_a^T sum_b G_ab D_b u, by K1 on
    the (E*n, n, n) lattice view (its plain twin on CPU tensors; f32
    accumulation for bf16, D from the f64 GLL table). Returns the
    non-assembled image in u's dtype."""
    if dim != 3 or len(G) != 6:
        raise NotImplementedError("the port's element operator is 3-D")
    if u.numel() == 0:
        return u.clone()
    n = D.shape[0]
    from .kernels import stiffness_lattice_3d
    view = lambda t: t.reshape(-1, n, n)
    return stiffness_lattice_3d(view(u), tuple(view(g) for g in G),
                                n).view(u.shape)


def stiffness_diagonal(G, D, dim: int):
    """Exact diagonal of the local operator in the element layout (..., E,
    n^3), closed form (setup only); bf16 factors are summed in f32 and
    rounded once."""
    if dim != 3 or len(G) != 6:
        raise NotImplementedError("the port's element operator is 3-D")
    from .kernels import _acc_dtype, _diff
    n = D.shape[0]
    out_dtype = G[0].dtype
    acc = _acc_dtype(out_dtype)
    Dm = _diff(n, acc, G[0].device)
    D2 = Dm * Dm
    d = torch.diagonal(Dm)
    shape = G[0].shape
    g = [x.to(acc).reshape(-1, n, n, n) for x in G]
    t_r = torch.matmul(g[0], D2)
    t_s = torch.matmul(D2.T, g[1])
    t_t = torch.matmul(D2.T, g[2].reshape(-1, n, n * n)).view(g[2].shape)
    di = d.view(1, 1, 1, n)
    dj = d.view(1, 1, n, 1)
    dk = d.view(1, n, 1, 1)
    t_cross = 2.0 * (di * dj * g[3] + di * dk * g[4] + dj * dk * g[5])
    return (t_r + t_s + t_t + t_cross).reshape(shape).to(out_dtype)


def dmul(D, U, axis: int, n: int):
    """Per-element contraction of one lattice axis with a 1-D operator
    D (n_out, n): split (m*n) -> (m, n), out[a] = sum_k D[a, k] U[k],
    merge back. Handles n_out != n (order transfer)."""
    shape = tuple(U.shape)
    n_out = D.shape[0]
    m = shape[axis] // n
    V = U.reshape(shape[:axis] + (m, n) + shape[axis + 1:])
    V = torch.tensordot(V, D, dims=([axis + 1], [1]))
    V = torch.movedim(V, -1, axis + 1)
    return V.reshape(shape[:axis] + (m * n_out,) + shape[axis + 1:])


def stiffness_apply_lattice(U, G, D, dim: int):
    """SEM stiffness apply on a (Mz, My, Mx) lattice, or a (P, Mz, My,
    Mx) stack, with G the tuple of six per-factor lattices of U's shape
    (G_rr, G_ss, G_tt, G_rs, G_rt, G_st).

    3-D runs the fused kernel (ops/kernels.stiffness_lattice_3d), which
    takes its differentiation matrix from the GLL tables of order
    n = D.shape[0] in its accumulation type — as the TPU kernel bakes the
    host f64 matrix in — so a bf16 D is never used to contract.
    """
    if dim != 3 or len(G) != 6 or D.shape[0] != D.shape[1]:
        raise NotImplementedError("the port's operator is the 3-D lattice apply")
    from .kernels import stiffness_lattice_3d
    return stiffness_lattice_3d(U, tuple(G), D.shape[0])


def stiffness_diagonal_lattice(G, D, dim: int):
    """Exact matrix-free operator diagonal in the lattice layout (setup
    only). bf16/f16 factors are summed in f32 and rounded once."""
    if dim != 3:
        raise NotImplementedError("the port's operator is 3-D")
    if G[0].dim() == 4:
        stacked = G[0].shape
        flat = [g.reshape((-1,) + tuple(stacked[2:])) for g in G]
        return stiffness_diagonal_lattice(flat, D, dim).view(stacked)
    out_dtype = G[0].dtype
    acc = torch.float32 if out_dtype in (torch.bfloat16, torch.float16) \
        else out_dtype
    G = [g.to(acc) for g in G]
    D = D.to(acc)
    n = D.shape[0]
    D2t = (D * D).T
    d = torch.diagonal(D)
    shape = G[0].shape

    def tiled_diag(axis):
        s = [1, 1, 1]
        s[axis] = shape[axis]
        return d.repeat(shape[axis] // n).reshape(s)

    t_r = dmul(D2t, G[0], 2, n)
    t_s = dmul(D2t, G[1], 1, n)
    t_t = dmul(D2t, G[2], 0, n)
    di, dj, dk = tiled_diag(2), tiled_diag(1), tiled_diag(0)
    t_cross = 2.0 * (di * dj * G[3] + di * dk * G[4] + dj * dk * G[5])
    return (t_r + t_s + t_t + t_cross).to(out_dtype)
