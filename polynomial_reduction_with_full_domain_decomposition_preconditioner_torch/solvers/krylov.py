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
a 0-d tensor in the field dtype (bf16 for the bf16 inner solve). A solve
with ``tolerance == 0`` (the fixed inner solve) never reads a tensor on
the host; its breakdown guards are ``torch.where``. Otherwise each step
reads one pair of flags (converged-or-NaN, breakdown) with ``.tolist()``.
A Krylov basis is one contiguous (m+1, numel) tensor.

Residual norm = sqrt(<r, QQt r>_masked).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["KrylovResult", "fcg", "fgmres", "tree_dot"]


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


def _axpy(a, x, y):
    """a*x + y over fields (a a scalar tensor)."""
    return _tmap(lambda xl, yl: a * xl + yl, x, y)


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


def fcg(operator, precond, dssum_plain, dot, dot2, f, *,
        max_iterations: int, tolerance: float, use_relative: bool = True,
        op_dssum=None):
    """Flexible (Notay) preconditioned CG; the target is tolerance * ||r0||
    (``use_relative``) or the absolute tolerance.

    op_dssum: the fused p -> (A p, QQt A p) of a sharded Domain. With it
    the assembled residual is carried, QQt r' = QQt r - alpha QQt q, so a
    step takes one dssum instead of two, as in the JAX package; it drifts
    from the re-assembled norm by round-off only."""
    dtype = _leaves(f)[0].dtype
    u = _tmap(torch.zeros_like, f)
    r = f
    ra = dssum_plain(r)
    r0_norm = torch.sqrt(torch.clamp(dot(r, ra), min=0.0))
    z = precond(r)
    p = z
    hist = torch.full((max_iterations + 1,), float("nan"), dtype=dtype,
                      device=r0_norm.device)
    hist[0] = r0_norm
    target = _target(tolerance, use_relative, r0_norm)
    check = tolerance > 0
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
        u = _axpy(alpha, p, u)
        r_new = _axpy(-alpha, q, r)
        ra = dssum_plain(r_new) if op_dssum is None else _axpy(-alpha, qq, ra)
        rn = torch.sqrt(torch.clamp(dot(r_new, ra), min=0.0))
        hist[it + 1] = rn
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
           z_dtype=None):
    """Restarted flexible GMRES(m) with Givens rotations and a masked
    back-substitution over the columns actually built; the target is
    tolerance * ||r0|| (``use_relative``) or the absolute tolerance.

    op_dssum: the fused z -> (A z, QQt A z) of a sharded Domain, in place
    of operator then dssum_plain (the same numbers).

    z_dtype: storage dtype of the flexible Z basis; the preconditioner
    output is quantized to it BEFORE the operator sees it, so the Arnoldi
    relation stays consistent with the stored basis.
    """
    m = num_vectors
    dtype = _leaves(f)[0].dtype
    zdt = dtype if z_dtype is None else z_dtype
    u = _tmap(torch.zeros_like, f)
    r0_norm = _res_norm(f, dssum_plain, dot)
    device = r0_norm.device
    target = _target(tolerance, use_relative, r0_norm)
    check = tolerance > 0
    hist = torch.full((max_iterations + 1,), float("nan"), dtype=dtype,
                      device=device)
    hist[0] = r0_norm
    numel = _flat(f).numel()
    one = torch.ones((), dtype=dtype, device=device)

    it = 0
    done = check and bool(r0_norm < target)
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
            if check:
                tol_or_nan = (rnorm < target) | torch.isnan(rnorm)
                hit_tol, breakdown = torch.stack(
                    [tol_or_nan, alpha == 0]).tolist()
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
