"""Collectives over the shard axis: the port's stand-in for what
``jax.shard_map`` supplies to the JAX package's SPMD code.

A sharded field is one tensor whose leading axis holds the
``local_shards`` shards this process owns, stacked and padded alike
(solvers/domain.py). The SPMD code calls:
  ppermute(x, pairs)   -> shard dst receives shard src's x[src] for each
                          (src, dst) pair of one shift, zeros where no
                          pair sends (``jax.lax.ppermute`` on the chain)
  psum(x)              -> the sum over every shard of x's leading axis, one
                          copy of shape x.shape[1:] (``jax.lax.psum``)
  allreduce(*xs)       -> values this process has already summed over its
                          own shards, summed over the processes: the
                          psum of a dot's partials
  slab_exchange_add(U, top_plane)
                       -> each shard's bottom plane plus the top plane of
                          the shard below, and its top plane plus the
                          bottom plane of the shard above, in place (the
                          JAX package's ``slab_exchange_add``, two chain
                          ppermutes)
  all_gather(x)        -> every shard's x concatenated along its first
                          axis, one copy of shape (P * x.shape[1], ...)
                          (``jax.lax.all_gather(..., tiled=True)``: the
                          composite's far field)
  cyclic_shift(x, k)   -> shard i receives shard (i + k) mod P's x (the
                          cyclic ``jax.lax.ppermute`` of the composite's
                          ring blocks: k = 1 from the shard above, k = -1
                          from the shard below)
``LocalComm(P)`` is the single-process backend: this process owns all P
shards, so an allreduce has nothing left to sum, the slab exchange adds
shifted slices of the stack into itself, the all-gather is a view of the
stack and the cyclic shift one ``torch.roll``. The card runs P shards
this way in one process.
"""

from __future__ import annotations

import torch

__all__ = ["LocalComm", "chain_pairs"]


def chain_pairs(num_shards: int):
    """The slab chain's (up, down) ppermute pairs: shard i sends to i + 1,
    and shard i + 1 to i."""
    up = tuple((i, i + 1) for i in range(num_shards - 1))
    down = tuple((i + 1, i) for i in range(num_shards - 1))
    return up, down


class LocalComm:
    """All ``size`` shards in this process, stacked on axis 0."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a comm needs at least one shard, got {size}")
        self.size = size
        self.local_shards = size    # the leading axis of every field

    def _check(self, x, what):
        if x.shape[0] != self.size:
            raise ValueError(f"{what}: leading axis {x.shape[0]} is not "
                             f"the comm's {self.size} shards")

    def ppermute(self, x, pairs):
        """out[dst] = x[src] for each (src, dst) in ``pairs``, else 0: one
        sliced copy. The pairs must shift one run of shards by one offset,
        as the chain's do."""
        self._check(x, "ppermute")
        out = torch.zeros_like(x)
        if not pairs:
            return out
        src = [s for s, _ in pairs]
        lo, k = src[0], len(pairs)
        shift = pairs[0][1] - lo
        if src != list(range(lo, lo + k)) or any(d - s != shift
                                                 for s, d in pairs):
            raise NotImplementedError(
                f"ppermute: {pairs} is not one shift of a run of shards")
        out[lo + shift:lo + shift + k] = x[lo:lo + k]
        return out

    def psum(self, x):
        """Sum over the shard axis; one copy of shape x.shape[1:]."""
        self._check(x, "psum")
        return x.sum(0)

    def all_gather(self, x):
        """Every shard's x concatenated along x's first axis, the tiled
        all-gather: one copy of shape (P * x.shape[1], ...). The stack
        already holds every shard, so it is a view of x."""
        self._check(x, "all_gather")
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def cyclic_shift(self, x, offset: int):
        """out[i] = x[(i + offset) mod P]: the cyclic ppermute with the
        pairs ((i + offset) mod P, i), in one roll."""
        self._check(x, "cyclic_shift")
        return torch.roll(x, -offset, 0)

    def allreduce(self, *xs):
        """``xs``, each already summed over this process's shards, summed
        over the processes, as a tuple. One process holds every shard, so
        they are the totals."""
        return xs

    def slab_exchange_add(self, U, top_plane=None):
        """Add the neighbouring shards' boundary planes of the slab
        direction into a stacked (P, Mz, My, Mx) field, IN PLACE: the sum
        that two chain ppermutes and two plane adds give, in three
        launches.

        top_plane: (P,) int64 lattice index of each shard's real top plane
        on ragged slab partitions (None: the last plane). A shard's top and
        bottom planes are distinct (Mz >= 2): the first add reads planes it
        does not write, and the second reads the copy taken before both."""
        self._check(U, "slab_exchange_add")
        if self.size == 1:
            return U
        if top_plane is None:
            bottom = U[:, 0].clone()
            U[1:, 0] += U[:-1, -1]
            U[:-1, -1] += bottom[1:]
            return U
        # each shard's top plane as a (P, 1, My, Mx) gather / scatter index:
        # a view, and no host-side index checks (advanced indexing on the
        # card adds a reduction, a compare and an assert per index tensor)
        idx = top_plane.view(-1, 1, 1, 1).expand(-1, 1, *U.shape[2:])
        top = torch.gather(U, 1, idx)
        U[:-1].scatter_add_(1, idx[:-1], U[1:, :1])
        U[1:, :1] += top[:-1]
        return U
