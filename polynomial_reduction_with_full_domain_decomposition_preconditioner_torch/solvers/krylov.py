"""Krylov solvers: flexible CG and restarted flexible GMRES.

Port of the JAX package's ``solvers/krylov.py``. The solvers are generic
over closures, as there:
  operator(u)       -> local (non-assembled) A u
  precond(r)        -> z, continuous (already stitched)
  dssum_plain(r)    -> QQt r with Dirichlet mask
  dot(u, v)         -> global plain point-space dot (0-d tensor)
  dot2(a,b,c,d)     -> (dot(a,b), dot(c,d))
  op_dssum(p)       -> (A p, QQt A p), optional: the fused operator and
                       dssum of a sharded Domain
Fields are tensors in their natural device shape, or lists of per-group
tensors (the composite problem). ``dot`` also takes a stacked basis
prefix (k, numel) against a flat vector and returns (k,). A sharded
field carries the leading shard axis, zero at padding, so its dot over
the whole stack is the sum of the shards' dots; ``tree_dot``'s ``comm``
sums that over the processes.

PyTorch runs eagerly, so the loop structure is plain Python: the
iteration counters are Python ints and every scalar of the recurrence is
a 0-d tensor in the field dtype (bf16 for the bf16 inner solve). Each
step reads one pair of flags (converged-or-NaN, breakdown) with
``.tolist()``, whatever the tolerance, so a cycle ends at a breakdown as
the JAX package's does. A Krylov basis is one contiguous (m+1, numel)
tensor.

The composite inner solve is rank-local at every shard count, as under
the JAX package's ``shard_map`` (its composite dot has no psum): it runs
a fixed count with ``batched=True`` on the stacked fields of P >= 1
shards, its breakdown guards ``torch.where`` (FGMRES reads one flag a
step, whether any shard's cycle ended); ``batched=True``
solves every shard's problem on the stacked fields at once with its own
Krylov scalars. Its ``dot`` is ``shard_dot`` (a (P,) tensor, or (k, P)
for a stacked basis prefix); every scalar of the recurrence is a (P,)
tensor broadcast over the shard axis, the residual history is
(max_iterations + 1, P), and the FGMRES bases are one (m + 1, P, ...)
tensor per field leaf, so a basis row is a contiguous stack of fields.

Residual norm = sqrt(<r, QQt r>_masked).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["KrylovResult", "fcg", "fgmres", "shard_dot", "tree_dot"]


def _leaves(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _tmap(fn, *xs):
    if isinstance(xs[0], (list, tuple)):
        return [fn(*parts) for parts in zip(*xs)]
    return fn(*xs)


def _flat(x):
    """A field as one flat vector (a view for a tensor or a single group)."""
    parts = _leaves(x)
    if len(parts) == 1:
        return parts[0].reshape(-1)
    return torch.cat([p.reshape(-1) for p in parts])


def _unflat(v, like):
    """A flat vector back in the layout of the field ``like``."""
    if not isinstance(like, (list, tuple)):
        return v.reshape(like.shape)
    out, off = [], 0
    for p in like:
        out.append(v[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return out


def _is_basis(a, b) -> bool:
    """A stacked basis prefix (k, numel) against a flat vector."""
    return (isinstance(a, torch.Tensor) and a.dim() == 2 and b.dim() == 1
            and a.shape[1] == b.numel())


def tree_dot(a, b, comm=None):
    """Inner product of two fields (0-d tensor in their dtype), or of a
    stacked basis prefix (k, numel) with a flat vector (-> (k,)). Reduced
    precision fields sum in f32 (PyTorch's CPU kernels and cuBLAS alike,
    with bf16 reduced-precision reductions switched off in the package
    root) and round the result once to their dtype.

    comm: for fields sharded over processes, the dot of this process's
    shards (the whole stack) is summed over the processes by one
    ``comm.allreduce``, as the JAX package psums the shard-local dots."""
    if _is_basis(a, b):
        acc = torch.mv(a, b)
    else:
        acc = None
        for xa, xb in zip(_leaves(a), _leaves(b)):
            d = torch.dot(xa.reshape(-1), xb.reshape(-1))
            acc = d if acc is None else acc + d
    if comm is not None:
        (acc,) = comm.allreduce(acc)
    return acc


def _shard_gram(A, B):
    """(k, P) rank-local dots of k stacks A (k, P, ...) with the stack B
    (P, ...): the (k P, P) product of the flat rows, one GEMM, whose
    diagonal blocks are the shards' own dots. A GEMM spreads the long
    reduction over the card (one row per shard in a batched product runs
    P blocks); reduced-precision rows sum in f32 and round once, as
    ``torch.dot`` does."""
    k, P = A.shape[0], A.shape[1]
    n = A.shape[2:].numel()          # explicit: a leaf may be empty
    C = torch.mm(A.reshape(k * P, n), B.reshape(P, n).T)
    return C.view(k, P, P).diagonal(dim1=1, dim2=2)


def shard_dot(a, b):
    """Rank-local inner products of two stacked fields (every leaf with a
    leading shard axis P): the (P,) dots of each shard's own part, summed
    over the leaves, with no sum across shards (the JAX package's
    composite ``tree_dot`` without an axis name under ``shard_map``). A
    stacked basis prefix (each leaf (k, P, ...)) against a field gives
    (k, P)."""
    acc = None
    for xa, xb in zip(_leaves(a), _leaves(b)):
        if xa.dim() == xb.dim():
            d = _shard_gram(xa[None], xb)[0]
        else:
            d = _shard_gram(xa, xb)
        acc = d if acc is None else acc + d
    return acc


def _bc(a, x):
    """A scalar tensor shaped to broadcast over the field leaf x: a 0-d
    scalar as it is, a (P,) per-shard scalar over x's shard axis."""
    return a if a.dim() == 0 else a.reshape(a.shape + (1,) * (x.dim() - a.dim()))


def _axpy(a, x, y):
    """a*x + y over fields (a a 0-d or a per-shard (P,) scalar tensor)."""
    return _tmap(lambda xl, yl: _bc(a, xl) * xl + yl, x, y)


def _sub(x, y):
    return _tmap(torch.sub, x, y)


def _safe(x):
    """x where x != 0, else 1 (breakdown guard on a 0-d tensor)."""
    return torch.where(x != 0, x, torch.ones_like(x))


@dataclass
class KrylovResult:
    u: object                       # field
    iterations: int                 # number of operator applications
    residual_history: torch.Tensor  # (max_iterations + 1,), padded with NaN
    r0_norm: torch.Tensor
    converged: torch.Tensor         # 0-d bool


def _res_norm(r, dssum_plain, dot):
    # clamp: <r, QQt r> >= 0 exactly, but roundoff can drive a tiny result
    # negative once the residual reaches machine precision
    return torch.sqrt(torch.clamp(dot(r, dssum_plain(r)), min=0.0))


def _target(tolerance, use_relative, r0_norm):
    """The residual norm a solve stops under: tolerance * ||r0||, or the
    tolerance itself (``use_relative=False``)."""
    if use_relative:
        return tolerance * r0_norm
    return torch.as_tensor(tolerance, dtype=r0_norm.dtype,
                           device=r0_norm.device)


def _check_batched(batched, tolerance):
    if batched and tolerance > 0:
        raise ValueError("a rank-local (batched) solve runs a fixed "
                         "iteration count: tolerance must be 0")


def fcg(operator, precond, dssum_plain, dot, dot2, f, *,
        max_iterations: int, tolerance: float, use_relative: bool = True,
        op_dssum=None, batched: bool = False):
    """Flexible (Notay) preconditioned CG; the target is tolerance * ||r0||
    (``use_relative``) or the absolute tolerance.

    op_dssum: the fused p -> (A p, QQt A p) of a sharded Domain. With it
    the assembled residual is carried, QQt r' = QQt r - alpha QQt q, so a
    step takes one dssum instead of two, as in the JAX package; it drifts
    from the re-assembled norm by round-off only.

    batched: every shard of the stacked fields solves its own problem
    (``dot`` / ``dot2`` rank-local, scalars (P,)); tolerance must be 0."""
    _check_batched(batched, tolerance)
    dtype = _leaves(f)[0].dtype
    u = _tmap(torch.zeros_like, f)
    r = f
    ra = dssum_plain(r)
    r0_norm = torch.sqrt(torch.clamp(dot(r, ra), min=0.0))
    z = precond(r)
    p = z
    hist = torch.full((max_iterations + 1,) + tuple(r0_norm.shape),
                      float("nan"), dtype=dtype, device=r0_norm.device)
    hist[0] = r0_norm
    target = _target(tolerance, use_relative, r0_norm)
    check = not batched
    # batched: a shard whose residual norm turns NaN ends its solve there
    # (the JAX package's per-shard loop exit); its u stays as that step
    # left it
    live = torch.ones_like(r0_norm, dtype=torch.bool) if batched else None
    it = 0
    done = check and bool(r0_norm < target)
    while not done and it < max_iterations:
        if op_dssum is None:
            q = operator(p)
        else:
            q, qq = op_dssum(p)
        gamma, theta = dot2(z, r, p, q)
        # breakdown guards: an exactly solved system gives gamma = theta =
        # 0; alpha and beta must come out 0, not NaN
        alpha = gamma / _safe(theta)
        u_new = _axpy(alpha, p, u)
        u = u_new if live is None else _tmap(
            lambda a, b: torch.where(_bc(live, a), a, b), u_new, u)
        r_new = _axpy(-alpha, q, r)
        ra = dssum_plain(r_new) if op_dssum is None else _axpy(-alpha, qq, ra)
        rn = torch.sqrt(torch.clamp(dot(r_new, ra), min=0.0))
        if live is None:
            hist[it + 1] = rn
        else:
            hist[it + 1] = torch.where(live, rn, float("nan"))
            live = live & ~torch.isnan(rn)
        it += 1
        if check:
            done = bool((rn < target) | torch.isnan(rn))
        z_new = precond(r_new)
        beta = dot(_sub(r_new, r), z_new) / _safe(gamma)
        p = _axpy(beta, p, z_new)
        r, z = r_new, z_new
    last = hist[it]
    converged = (last < target) & ~torch.isnan(last)
    return KrylovResult(u=u, iterations=it, residual_history=hist,
                        r0_norm=r0_norm, converged=converged)


def fgmres(operator, precond, dssum_plain, dot, f, *,
           max_iterations: int, num_vectors: int = 20,
           tolerance: float, use_relative: bool = True, op_dssum=None,
           z_dtype=None, batched: bool = False):
    """Restarted flexible GMRES(m) with Givens rotations and a masked
    back-substitution over the columns actually built; the target is
    tolerance * ||r0|| (``use_relative``) or the absolute tolerance.

    op_dssum: the fused z -> (A z, QQt A z) of a sharded Domain, in place
    of operator then dssum_plain (the same numbers).

    z_dtype: storage dtype of the flexible Z basis; the preconditioner
    output is quantized to it BEFORE the operator sees it, so the Arnoldi
    relation stays consistent with the stored basis.

    batched: every shard of the stacked fields solves its own problem
    (``dot`` is ``shard_dot``); tolerance must be 0 (``_fgmres_batched``).
    """
    _check_batched(batched, tolerance)
    if batched:
        return _fgmres_batched(operator, precond, dssum_plain, dot, f,
                               max_iterations=max_iterations,
                               num_vectors=num_vectors, op_dssum=op_dssum,
                               z_dtype=z_dtype)
    m = num_vectors
    dtype = _leaves(f)[0].dtype
    zdt = dtype if z_dtype is None else z_dtype
    u = _tmap(torch.zeros_like, f)
    r0_norm = _res_norm(f, dssum_plain, dot)
    device = r0_norm.device
    target = _target(tolerance, use_relative, r0_norm)
    hist = torch.full((max_iterations + 1,), float("nan"), dtype=dtype,
                      device=device)
    hist[0] = r0_norm
    numel = _flat(f).numel()
    one = torch.ones((), dtype=dtype, device=device)

    it = 0
    done = bool(r0_norm < target)
    last_rnorm = r0_norm
    while not done:
        if it > 0:                         # residual at restart
            r = _sub(f, operator(u))
            g0 = _res_norm(r, dssum_plain, dot)
        else:
            r, g0 = f, r0_norm
        g0_safe = torch.where(g0 > 0, g0, one)
        V = torch.zeros((m + 1, numel), dtype=dtype, device=device)
        V[0] = _flat(r) * (1.0 / g0_safe)
        Z = torch.zeros((m, numel), dtype=zdt, device=device)
        H = torch.zeros((m + 1, m), dtype=dtype, device=device)
        gam = torch.zeros((m + 1,), dtype=dtype, device=device)
        gam[0] = g0
        c = torch.zeros((m,), dtype=dtype, device=device)
        s = torch.zeros((m,), dtype=dtype, device=device)
        jlast = 0
        hit_tol = False
        for j in range(m):
            if it >= max_iterations:
                break
            z = precond(_unflat(V[j], f))
            if z_dtype is not None:
                zq = _tmap(lambda zl: zl.to(z_dtype), z)
                z = _tmap(lambda zl: zl.to(dtype), zq)
                Z[j] = _flat(zq)
            else:
                Z[j] = _flat(z)
            if op_dssum is None:
                q = operator(z)
                qq = dssum_plain(q)
            else:
                q, qq = op_dssum(z)
            # H[i] = <q, QQt V[i]>_masked for i <= j (mask/QQt symmetry)
            h = dot(V[:j + 1], _flat(qq)).to(dtype)
            q = _sub(q, _unflat(h @ V[:j + 1], q))
            alpha = torch.sqrt(torch.clamp(dot(q, dssum_plain(q)), min=0.0))

            hcol = torch.cat([h, torch.zeros(m - j, dtype=dtype,
                                             device=device)])
            for i in range(j):             # accumulated Givens rotations
                hi, hi1 = hcol[i].clone(), hcol[i + 1].clone()
                hcol[i] = c[i] * hi + s[i] * hi1
                hcol[i + 1] = -s[i] * hi + c[i] * hi1
            beta = torch.sqrt(hcol[j] ** 2 + alpha ** 2)
            beta_safe = torch.where(beta > 0, beta, one)
            cj = hcol[j] / beta_safe
            sj = alpha / beta_safe
            hcol[j] = beta
            gj = gam[j].clone()
            gam[j + 1] = -sj * gj
            gam[j] = cj * gj
            rnorm = torch.abs(gam[j + 1])
            H[:, j] = hcol
            c[j] = cj
            s[j] = sj
            V[j + 1] = _flat(q) * (1.0 / torch.where(alpha > 0, alpha, one))
            hist[it + 1] = rnorm
            it += 1
            jlast = j
            last_rnorm = rnorm
            tol_or_nan = (rnorm < target) | torch.isnan(rnorm)
            hit_tol, breakdown = torch.stack([tol_or_nan, alpha == 0]).tolist()
            if hit_tol or breakdown:
                break

        # masked back-substitution over columns 0..jlast
        y = torch.zeros((m,), dtype=dtype, device=device)
        for k in range(jlast, -1, -1):
            contrib = (H[k, k + 1:jlast + 1] * y[k + 1:jlast + 1]).sum()
            y[k] = (gam[k] - contrib) / _safe(H[k, k])
        Zp = Z[:jlast + 1]
        upd = y[:jlast + 1] @ (Zp if zdt == dtype else Zp.to(dtype))
        u = _tmap(torch.add, u, _unflat(upd, u))
        # only tolerance/NaN end the solve; a full basis or a breakdown
        # restarts (as long as iterations remain)
        done = hit_tol or it >= max_iterations

    converged = (last_rnorm < target) & ~torch.isnan(last_rnorm)
    return KrylovResult(u=u, iterations=it, residual_history=hist,
                        r0_norm=r0_norm, converged=converged)


def _rows_combine(h, V):
    """sum_i h[i, p] V[i, p] over a stacked basis V (k, P, ...) of one
    leaf with per-shard coefficients h (k, P): (P, ...)."""
    k, P = h.shape
    out = torch.einsum("ip,ipn->pn", h, V.reshape(k, P, V.shape[2:].numel()))
    return out.reshape(V.shape[1:])


def _rows_at(V, j):
    """Row j[p] of shard p of a stacked basis V (k, P, ...): (P, ...). A
    host int j (every shard at the same row) is a view."""
    if isinstance(j, int):
        return V[j]
    P = V.shape[1]
    n = V.shape[2:].numel()
    idx = j.view(1, P, 1).expand(1, P, n)
    return torch.gather(V.reshape(V.shape[0], P, n), 0, idx)[0] \
        .reshape(V.shape[1:])


def _set_rows(V, j, x):
    """Row j[p] of shard p of the stacked basis V set to x[p], in place."""
    if isinstance(j, int):
        V[j].copy_(x)
        return
    P = V.shape[1]
    n = V.shape[2:].numel()
    V.view(V.shape[0], P, n).scatter_(
        0, j.view(1, P, 1).expand(1, P, n), x.reshape(1, P, n).to(V.dtype))


def _at(a, j):
    """a[j[p], p] of a (k, P) table: (P,), a copy."""
    if isinstance(j, int):
        return a[j].clone()
    return torch.gather(a, 0, j.view(1, -1))[0]


def _set_at(a, j, v):
    """a[j[p], p] = v[p], in place."""
    if isinstance(j, int):
        a[j] = v
        return
    a.scatter_(0, j.view(1, -1), v.view(1, -1).to(a.dtype))


def _set_col(A, j, col):
    """Column j[p] of shard p of an (m + 1, m, P) table set to col[:, p]."""
    if isinstance(j, int):
        A[:, j] = col
        return
    k, _, P = A.shape
    A.scatter_(1, j.view(1, 1, P).expand(k, 1, P), col.view(k, 1, P))


def _back_substitute(H, gam, j):
    """y (m, P) solving each shard's triangular system over its columns
    0 .. j[p] - 1 (zero beyond), with the breakdown guard on H[k, k]."""
    m = H.shape[1]
    y = torch.zeros_like(gam[:m])
    for k in range(m - 1, -1, -1):
        contrib = (H[k, k + 1:] * y[k + 1:]).sum(0)
        yk = (gam[k] - contrib) / _safe(H[k, k])
        y[k] = torch.where(k < j, yk, torch.zeros_like(yk))
    return y


def _fgmres_batched(operator, precond, dssum_plain, dot, f, *,
                    max_iterations: int, num_vectors: int, op_dssum=None,
                    z_dtype=None):
    """``fgmres`` with every shard's own recurrence, as the JAX package's
    fgmres runs under ``shard_map`` with a rank-local dot: per shard, a
    cycle of Arnoldi steps ends when its basis is full or at a breakdown
    (alpha = 0, e.g. <q, QQt q> rounding to <= 0) or a NaN; the cycle's
    correction is added, and a shard with steps left restarts from its
    residual (a NaN ends its solve). Here the shards step in lockstep, one
    Arnoldi step each per iteration: the Hessenberg, the Givens pairs and
    the residual estimates carry a trailing shard axis, each shard its own
    column index j. Every iteration after the first ends and restarts the
    cycles that must, selected per shard: a masked back-substitution adds
    the correction Z y, and the new cycle starts from the residual the
    Arnoldi relation gives, operator(Z) = V Hraw (Hraw: the unrotated
    Hessenberg, with 1 below the diagonal where a breakdown left q
    unnormalized in V): r = c0 V[0] - V Hraw y, of norm |gam[j]|. The JAX
    package applies the operator to u there instead; the two agree to
    round-off, and this costs no operator apply and no dssum. Rows of V
    and Z beyond a shard's j are stale and masked out. The basis is one
    (m + 1, P, ...) tensor per field leaf. A fixed iteration count (no
    tolerance); each step reads the shards' cycle-end flags on the host
    and skips the masked end and restart when none ended (they would
    change nothing): a cycle ends at a full basis or a breakdown, rarely,
    and on a host-bound solve the read costs less than the launches it
    saves. While every live shard is at the same column (always at
    P = 1, and until the first shard's cycle ends alone) the column is a
    host int: rows are views, the Givens loop runs over the columns built,
    the same numbers as the masked selects."""
    m = num_vectors
    leaves = _leaves(f)
    dtype = leaves[0].dtype
    zdt = dtype if z_dtype is None else z_dtype
    P = leaves[0].shape[0]
    device = leaves[0].device
    as_field = (lambda parts: parts) if isinstance(f, (list, tuple)) \
        else (lambda parts: parts[0])
    one = torch.ones((), dtype=dtype, device=device)
    nan = torch.full((P,), float("nan"), dtype=dtype, device=device)

    u = [torch.zeros_like(x) for x in leaves]
    r0_norm = _res_norm(f, dssum_plain, dot)
    hist = torch.full((max_iterations + 1, P), float("nan"), dtype=dtype,
                      device=device)
    hist[0] = r0_norm
    V = [torch.zeros((m + 1,) + tuple(x.shape), dtype=dtype, device=device)
         for x in leaves]
    Z = [torch.zeros((m,) + tuple(x.shape), dtype=zdt, device=device)
         for x in leaves]
    H = torch.zeros((m + 1, m, P), dtype=dtype, device=device)
    Hraw = torch.zeros_like(H)
    gam = torch.zeros((m + 1, P), dtype=dtype, device=device)
    c = torch.zeros((m, P), dtype=dtype, device=device)
    s = torch.zeros((m, P), dtype=dtype, device=device)
    c0 = torch.zeros(P, dtype=dtype, device=device)  # cycle start: c0 V[0]
    j = torch.zeros(P, dtype=torch.long, device=device)
    ended = torch.zeros(P, dtype=torch.bool, device=device)  # cycle over
    dead = torch.zeros(P, dtype=torch.bool, device=device)   # solve over
    rnorm = r0_norm
    iota = torch.arange(m + 1, device=device).view(-1, 1)

    def start(rs, r, g0):
        """Shards in rs begin a cycle from the residual r of norm g0."""
        g0_safe = torch.where(g0 > 0, g0, one)
        for Vl, rl in zip(V, r):
            Vl[0] = torch.where(_bc(rs, rl), rl * _bc(1.0 / g0_safe, rl),
                                Vl[0])
        for a in (H, Hraw, c, s):
            a.copy_(torch.where(rs, 0.0, a))
        gam.copy_(torch.where(rs, torch.where(iota == 0, g0, 0.0), gam))
        c0.copy_(torch.where(rs, g0_safe, c0))
        j.copy_(torch.where(rs, 0, j))

    def finish(fin):
        """Shards in fin add their cycle's correction Z y to u; returns y."""
        y = _back_substitute(H, gam, j)
        for ul, Zl in zip(u, Z):
            upd = _rows_combine(y, Zl if zdt == dtype else Zl.to(dtype))
            ul.copy_(torch.where(_bc(fin, ul), ul + upd, ul))
        return y

    start(torch.ones(P, dtype=torch.bool, device=device), leaves, r0_norm)
    ju = 0          # the shards' common column on the host, or None
    for it in range(max_iterations):
        if it > 0:
            fin = (ended | (j == m)) & ~dead
            flags = fin.tolist()
            if any(flags):
                y = finish(fin)
                dead = dead | (fin & torch.isnan(rnorm))
                rs = fin & ~dead
                w = torch.where(iota == 0, c0, 0.0) \
                    - torch.einsum("ikp,kp->ip", Hraw, y)
                start(rs, [_rows_combine(w, Vl) for Vl in V],
                      torch.abs(_at(gam, j)))
                ju = 0 if all(flags) else None
            j.copy_(torch.where(dead, 0, j))   # an ended solve steps on idle
        jj = j if ju is None else ju
        z = precond(as_field([_rows_at(Vl, jj) for Vl in V]))
        if z_dtype is not None:
            zq = _tmap(lambda zl: zl.to(z_dtype), z)
            z = _tmap(lambda zl: zl.to(dtype), zq)
        else:
            zq = z
        for Zl, zl in zip(Z, _leaves(zq)):
            _set_rows(Zl, jj, zl)
        if op_dssum is None:
            q = operator(z)
            qq = dssum_plain(q)
        else:
            q, qq = op_dssum(z)
        # H[i] = <q, QQt V[i]>_masked for i <= j, per shard
        h = dot(as_field(V), qq).to(dtype)
        h = torch.where(iota <= jj, h, 0.0)
        q = as_field([ql - _rows_combine(h, Vl)
                      for ql, Vl in zip(_leaves(q), V)])
        alpha = torch.sqrt(torch.clamp(dot(q, dssum_plain(q)), min=0.0))
        alpha_safe = torch.where(alpha > 0, alpha, one)
        _set_col(Hraw, jj, torch.where(iota == jj + 1, alpha_safe, h))

        hcol = h.clone()
        # accumulated Givens rotations over each shard's columns built
        for i in range(m if ju is None else ju):
            hi, hi1 = hcol[i].clone(), hcol[i + 1].clone()
            new_i, new_i1 = c[i] * hi + s[i] * hi1, -s[i] * hi + c[i] * hi1
            if ju is None:
                act = i < j
                new_i = torch.where(act, new_i, hi)
                new_i1 = torch.where(act, new_i1, hi1)
            hcol[i], hcol[i + 1] = new_i, new_i1
        hj = _at(hcol, jj)
        beta = torch.sqrt(hj ** 2 + alpha ** 2)
        beta_safe = torch.where(beta > 0, beta, one)
        cj = hj / beta_safe
        sj = alpha / beta_safe
        _set_at(hcol, jj, beta)
        gj = _at(gam, jj)
        _set_at(gam, jj + 1, -sj * gj)
        _set_at(gam, jj, cj * gj)
        rnorm = torch.abs(-sj * gj)
        _set_col(H, jj, hcol)
        _set_at(c, jj, cj)
        _set_at(s, jj, sj)
        for Vl, ql in zip(V, _leaves(q)):
            _set_rows(Vl, jj + 1, ql * _bc(1.0 / alpha_safe, ql))
        hist[it + 1] = torch.where(dead, nan, rnorm)
        ended = torch.isnan(rnorm) | (alpha == 0)
        j = j + 1
        if ju is not None:
            ju += 1
    finish(~dead)

    # a fixed count has no tolerance to reach: not converged, as fgmres
    # reports a tolerance-0 solve
    return KrylovResult(u=as_field(u), iterations=max_iterations,
                        residual_history=hist, r0_norm=r0_norm,
                        converged=torch.zeros(P, dtype=torch.bool,
                                              device=device))
