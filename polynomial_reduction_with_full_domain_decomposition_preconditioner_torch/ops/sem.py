"""Matrix-free SEM stiffness operator on point-lattice fields.

Port of the JAX package's ``ops/sem.py`` (lattice forms). The 3-D apply
runs through the hand-written kernel ``ops/kernels.stiffness_lattice_3d``
(its plain twin on CPU tensors); the 2-D apply is plain torch on every
device, as the JAX package leaves its 2-D forms to XLA, and never reaches
a 3-D kernel. ``dmul`` is the generic per-element axis contraction used
by the plain forms and by setup code. The result is the non-assembled
(local) operator image; direct stiffness summation is a separate op
(ops/gather_scatter.py).

Every form also takes a (P, Mz, My, Mx) stack of slab shards ((P, My,
Mx) in 2-D): every shard is a whole number of elements along its
leading axis and the forms are element-local, so they run once on the
contiguous (P*Mz, My, Mx) view. Which is a lattice and which a stack
follows from ``dim``, never from the tensor's rank alone.

Precision: every form contracts a bf16 field in f32 with D taken from
the f64 GLL table in the accumulation type, and rounds once at the end
(K1's arithmetic; in 2-D a deliberate deviation from the JAX package's
CPU path, which contracts in bf16 with a bf16 D).

The element-layout forms (``stiffness_apply``, ``stiffness_diagonal``)
serve unstructured meshes: fields (..., E, n^dim) with the local
ordering x fastest, geometry a tuple of 3 (2-D) or 6 (3-D) such factor
tensors. The 3-D apply runs kernel K1 on the (E*n, n, n) lattice view of
the element stack, in which every n^3 block is one element (the factors
viewed alike), the 2-D apply the 2-D lattice form on the (E*n, n) view;
the diagonal is torch matmuls, accumulated in f32 for bf16 factors.
"""

from __future__ import annotations

import torch

__all__ = ["dmul", "stiffness_apply_lattice", "stiffness_diagonal_lattice",
           "stiffness_apply", "stiffness_diagonal"]

_NUM_GEOM = {2: 3, 3: 6}


def _check_dim(dim: int, G) -> None:
    if dim not in _NUM_GEOM:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    if len(G) != _NUM_GEOM[dim]:
        raise ValueError(f"a {dim}-D operator takes {_NUM_GEOM[dim]} "
                         f"geometric factors, got {len(G)}")


def stiffness_apply(u, G, D, dim: int):
    """Local SEM stiffness apply element by element on an element-layout
    field u (..., E, n^dim), G the factors of u's shape ((G_rr, G_ss,
    G_rs) in 2-D, (G_rr, G_ss, G_tt, G_rs, G_rt, G_st) in 3-D): Au =
    sum_a D_a^T sum_b G_ab D_b u, on the (E*n, n[, n]) lattice view (3-D:
    K1, its plain twin on CPU tensors; f32 accumulation for bf16, D from
    the f64 GLL table). Returns the non-assembled image in u's dtype."""
    _check_dim(dim, G)
    if u.numel() == 0:
        return u.clone()
    n = D.shape[0]
    view = lambda t: t.reshape((-1,) + (n,) * (dim - 1))
    if dim == 2:
        return _stiffness_lattice_2d(view(u), tuple(view(g) for g in G),
                                     n).view(u.shape)
    from .kernels import stiffness_lattice_3d
    return stiffness_lattice_3d(view(u), tuple(view(g) for g in G),
                                n).view(u.shape)


def stiffness_diagonal(G, D, dim: int):
    """Exact diagonal of the local operator in the element layout (..., E,
    n^dim), closed form (setup only); bf16 factors are summed in f32 and
    rounded once."""
    _check_dim(dim, G)
    from .kernels import _acc_dtype, _diff
    n = D.shape[0]
    out_dtype = G[0].dtype
    acc = _acc_dtype(out_dtype)
    Dm = _diff(n, acc, G[0].device)
    D2 = Dm * Dm
    d = torch.diagonal(Dm)
    shape = G[0].shape
    g = [x.to(acc).reshape((-1,) + (n,) * dim) for x in G]
    if dim == 2:
        # (e, j, i): t_r[j, i] = sum_k G_rr[j, k] D2[k, i], t_s alike in j
        t_r = torch.matmul(g[0], D2)
        t_s = torch.matmul(D2.T, g[1])
        t_cross = 2.0 * d.view(1, 1, n) * d.view(1, n, 1) * g[2]
        return (t_r + t_s + t_cross).reshape(shape).to(out_dtype)
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


def _stiffness_lattice_2d(U, G, n: int):
    """The 2-D lattice apply on an element-aligned (My, Mx) lattice: the
    JAX package's XLA form (ops/sem.py, dim == 2) in f32 for bf16 and f32
    fields (f64 for f64) with D from the f64 GLL table, one cast at the
    end."""
    from .kernels import _acc_dtype, _diff
    acc = _acc_dtype(U.dtype)
    D = _diff(n, acc, U.device)
    Dt = D.T
    Uc = U.to(acc)
    G0, G1, G2 = (g.to(acc) for g in G)
    Dr = dmul(D, Uc, 1, n)
    Ds = dmul(D, Uc, 0, n)
    Wr = G0 * Dr + G2 * Ds
    Ws = G2 * Dr + G1 * Ds
    return (dmul(Dt, Wr, 1, n) + dmul(Dt, Ws, 0, n)).to(U.dtype)


def _flat_stack(t, dim: int):
    """A (P, M0, ...) stack of ``dim``-axis lattices as its (P*M0, ...)
    view; a lattice as it is."""
    if t.dim() == dim + 1:
        return t.reshape((-1,) + tuple(t.shape[2:]))
    if t.dim() != dim:
        raise ValueError(f"a {dim}-D lattice or a stack of them, got shape "
                         f"{tuple(t.shape)}")
    return t


def stiffness_apply_lattice(U, G, D, dim: int):
    """SEM stiffness apply on a (Mz, My, Mx) lattice or a (P, Mz, My, Mx)
    stack (2-D: (My, Mx) or (P, My, Mx)), with G the tuple of per-factor
    lattices of U's shape ((G_rr, G_ss, G_rs) in 2-D, (G_rr, G_ss, G_tt,
    G_rs, G_rt, G_st) in 3-D).

    3-D runs the fused kernel (ops/kernels.stiffness_lattice_3d), 2-D the
    plain torch form; both take the differentiation matrix from the GLL
    tables of order n = D.shape[0] in the accumulation type — as the TPU
    kernel bakes the host f64 matrix in — so a bf16 D is never used to
    contract.
    """
    _check_dim(dim, G)
    if D.shape[0] != D.shape[1]:
        raise ValueError("the operator's D must be square")
    n = D.shape[0]
    if dim == 3:
        from .kernels import stiffness_lattice_3d
        if U.dim() not in (3, 4):
            raise ValueError(f"a 3-D lattice or a stack of them, got shape "
                             f"{tuple(U.shape)}")
        return stiffness_lattice_3d(U, tuple(G), n)
    flat = _flat_stack(U, dim)
    return _stiffness_lattice_2d(
        flat, tuple(_flat_stack(g, dim) for g in G), n).view(U.shape)


def stiffness_diagonal_lattice(G, D, dim: int):
    """Exact matrix-free operator diagonal in the lattice layout, of a
    lattice or a (P, ...) stack of them (setup only). bf16/f16 factors are
    summed in f32 and rounded once."""
    _check_dim(dim, G)
    if G[0].dim() == dim + 1:
        stacked = G[0].shape
        return stiffness_diagonal_lattice(
            [_flat_stack(g, dim) for g in G], D, dim).view(stacked)
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
        s = [1] * dim
        s[axis] = shape[axis]
        return d.repeat(shape[axis] // n).reshape(s)

    if dim == 2:
        t_r = dmul(D2t, G[0], 1, n)
        t_s = dmul(D2t, G[1], 0, n)
        t_rs = 2.0 * tiled_diag(1) * tiled_diag(0) * G[2]
        return (t_r + t_s + t_rs).to(out_dtype)
    t_r = dmul(D2t, G[0], 2, n)
    t_s = dmul(D2t, G[1], 1, n)
    t_t = dmul(D2t, G[2], 0, n)
    di, dj, dk = tiled_diag(2), tiled_diag(1), tiled_diag(0)
    t_cross = 2.0 * (di * dj * G[3] + di * dk * G[4] + dj * dk * G[5])
    return (t_r + t_s + t_t + t_cross).to(out_dtype)
