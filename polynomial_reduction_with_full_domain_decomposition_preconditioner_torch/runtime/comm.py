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

``ProcessComm(P)`` is the ``torch.distributed`` backend
(runtime/distributed.py): each of n processes owns P / n consecutive
shards. Copies between shards of one process stay local; only what
crosses a process boundary travels, point to point for the shifts and
the slab planes, one ``all_reduce`` for the sums, one
``all_gather_into_tensor`` for the all-gather. Its slab exchange also
splits into ``slab_exchange_start`` / ``slab_exchange_finish``, so that
the Domain can overlap the planes' transfer with its interior apply.
"""

from __future__ import annotations

import time

import torch

__all__ = ["LocalComm", "ProcessComm", "chain_pairs"]


def chain_pairs(num_shards: int):
    """The slab chain's (up, down) ppermute pairs: shard i sends to i + 1,
    and shard i + 1 to i."""
    up = tuple((i, i + 1) for i in range(num_shards - 1))
    down = tuple((i + 1, i) for i in range(num_shards - 1))
    return up, down


class LocalComm:
    """All ``size`` shards in this process, stacked on axis 0."""

    processes = 1

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


class _Exchange:
    """The planes of one slab exchange in flight (``ProcessComm``)."""

    def __init__(self, lo, hi, works, bring):
        self.lo, self.hi = lo, hi        # each local shard's sent planes
        self.works = works               # the transfers in flight
        self.bring = bring               # {"below" / "above": receive buffer}


class ProcessComm:
    """``size`` shards over the processes of the default
    ``torch.distributed`` group, ``local_shards`` = size / processes of
    them in this one, stacked on axis 0 (process r owns shards
    [r local_shards, (r + 1) local_shards)).

    backend "gloo" takes host tensors only for point-to-point, so a CUDA
    tensor is copied to a host buffer before every send, all-reduce and
    all-gather and back after every receive, explicitly; ``stats`` counts
    those copies and their bytes, and the host seconds spent in the slab
    exchange. "nccl" moves device tensors directly (one card a process).
    """

    def __init__(self, size: int):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessComm needs an initialized process "
                               "group (runtime/distributed.py)")
        nproc, rank = dist.get_world_size(), dist.get_rank()
        if size < 1 or size % nproc:
            raise ValueError(f"{size} shards do not split evenly over "
                             f"{nproc} processes")
        self._dist = dist
        self.size = size
        self.processes = nproc
        self.rank = rank
        self.local_shards = size // nproc
        self.first = rank * self.local_shards      # first owned shard
        self.backend = dist.get_backend()
        self.stats = {"host_copies": 0, "host_bytes": 0,
                      "exchange_seconds": 0.0, "exchanges": 0}

    def _check(self, x, what):
        if x.shape[0] != self.local_shards:
            raise ValueError(f"{what}: leading axis {x.shape[0]} is not "
                             f"this process's {self.local_shards} shards")

    def owner(self, shard: int) -> int:
        return shard // self.local_shards

    # ---- staging: gloo moves host tensors only ----

    def _staged(self, t):
        return self.backend == "gloo" and t.device.type != "cpu"

    def _out(self, t):
        """A contiguous copy of ``t`` that the backend can send."""
        if self._staged(t):
            self.stats["host_copies"] += 1
            self.stats["host_bytes"] += t.numel() * t.element_size()
            return t.to("cpu", copy=True)
        return t.contiguous().clone()

    def _buffer(self, like):
        """A receive buffer shaped like ``like`` that the backend fills."""
        dev = "cpu" if self._staged(like) else like.device
        return torch.empty(like.shape, dtype=like.dtype, device=dev)

    def _back(self, buf, like):
        if buf.device != like.device:
            self.stats["host_copies"] += 1
            self.stats["host_bytes"] += buf.numel() * buf.element_size()
            return buf.to(like.device)
        return buf

    def _post(self, sends, recvs):
        """Start point-to-point transfers: ``sends`` and ``recvs`` are
        (peer, tensor, tag) in one order on both sides."""
        dist = self._dist
        ops = ([dist.P2POp(dist.isend, t, peer, tag=tag)
                for peer, t, tag in sends]
               + [dist.P2POp(dist.irecv, t, peer, tag=tag)
                  for peer, t, tag in recvs])
        return dist.batch_isend_irecv(ops) if ops else []

    def _route(self, x, pairs):
        """out[dst] = x[src] for each global (src, dst) pair, zeros where
        no pair sends: local copies, and a point-to-point transfer for
        each pair that crosses processes (tagged by the source shard)."""
        lo, k = self.first, self.local_shards
        mine = lambda s: lo <= s < lo + k
        out = torch.zeros_like(x)
        sends, recvs, landing = [], [], []
        for s, d in sorted(pairs):
            if mine(s) and mine(d):
                out[d - lo] = x[s - lo]
            elif mine(s):
                sends.append((self.owner(d), self._out(x[s - lo]), s))
            elif mine(d):
                buf = self._buffer(x[0])
                recvs.append((self.owner(s), buf, s))
                landing.append((d - lo, buf))
        for w in self._post(sends, recvs):
            w.wait()
        for i, buf in landing:
            out[i] = self._back(buf, out[i])
        return out

    def ppermute(self, x, pairs):
        """out[dst] = x[src] for each global (src, dst) in ``pairs``,
        else 0."""
        self._check(x, "ppermute")
        return self._route(x, pairs)

    def cyclic_shift(self, x, offset: int):
        """out[i] = x[(i + offset) mod P] over the global shards."""
        self._check(x, "cyclic_shift")
        P = self.size
        if self.processes == 1:
            return torch.roll(x, -offset, 0)
        return self._route(x, [((i + offset) % P, i) for i in range(P)])

    def _all_reduce(self, t):
        buf = self._out(t) if self._staged(t) else t.contiguous()
        self._dist.all_reduce(buf)
        return self._back(buf, t)

    def psum(self, x):
        """Sum over every shard: this process's shards summed, then one
        all_reduce over the processes."""
        self._check(x, "psum")
        return self._all_reduce(x.sum(0))

    def allreduce(self, *xs):
        """``xs``, each already summed over this process's shards, summed
        over the processes in one all_reduce, as a tuple."""
        if not xs:
            return xs
        total = self._all_reduce(torch.stack([torch.as_tensor(x) for x in
                                              xs]))
        return tuple(total.unbind(0))

    def sum_host(self, a):
        """A host numpy array summed over the processes (one all_reduce;
        NCCL's through the current card)."""
        t = torch.from_numpy(a.copy())
        if self.backend == "nccl":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        self._dist.all_reduce(t)
        return t.cpu().numpy()

    def all_gather(self, x):
        """Every shard's x concatenated along x's first axis in global
        shard order: (P * x.shape[1], ...)."""
        self._check(x, "all_gather")
        src = self._out(x) if self._staged(x) else x.contiguous()
        out = src.new_empty((self.size,) + tuple(x.shape[1:]))
        # all_gather_into_tensor, under the name newer torch gives it
        gather = getattr(self._dist, "all_gather_single", None) \
            or self._dist.all_gather_into_tensor
        gather(out, src)
        return self._back(out, x).reshape((-1,) + tuple(x.shape[2:]))

    # ---- the slab exchange ----

    def slab_exchange_start(self, lo, hi):
        """Start the slab chain's transfers: ``lo`` / ``hi`` are (local
        shards, My, Mx) stacks of each local shard's bottom and top plane
        values. The last local shard's top plane goes to the next process
        and the first one's bottom plane to the previous one."""
        t0 = time.perf_counter()
        r, n = self.rank, self.processes
        sends, recvs, bring = [], [], {}
        if r + 1 < n:
            sends.append((r + 1, self._out(hi[-1]), 0))
            bring["above"] = self._buffer(lo[0])
            recvs.append((r + 1, bring["above"], 1))
        if r > 0:
            sends.append((r - 1, self._out(lo[0]), 1))
            bring["below"] = self._buffer(hi[-1])
            recvs.append((r - 1, bring["below"], 0))
        works = self._post(sends, recvs)
        self.stats["exchange_seconds"] += time.perf_counter() - t0
        return _Exchange(lo, hi, works, bring)

    def slab_exchange_finish(self, U, ex, top_plane=None):
        """Add the exchanged planes into the stacked (local shards, Mz, My,
        Mx) field U, IN PLACE: each shard's bottom plane gets the top
        plane of the shard below, its top plane the bottom plane of the
        shard above; the same single add a plane that ``LocalComm`` makes."""
        self._check(U, "slab_exchange_finish")
        t0 = time.perf_counter()
        for w in ex.works:
            w.wait()
        self.stats["exchange_seconds"] += time.perf_counter() - t0
        self.stats["exchanges"] += 1
        below = ex.hi[:-1]
        above = ex.lo[1:]
        if "below" in ex.bring:
            below = torch.cat([self._back(ex.bring["below"], U[0, 0])[None],
                               below])
        if "above" in ex.bring:
            above = torch.cat([above, self._back(ex.bring["above"],
                                                 U[0, 0])[None]])
        first = 0 if "below" in ex.bring else 1
        last = U.shape[0] if "above" in ex.bring else U.shape[0] - 1
        if below.shape[0]:
            U[first:, 0] += below
        if above.shape[0]:
            if top_plane is None:
                U[:last, -1] += above
            else:
                idx = top_plane[:last].view(-1, 1, 1, 1).expand(
                    -1, 1, *U.shape[2:])
                U[:last].scatter_add_(1, idx, above[:, None])
        return U

    def _top_planes(self, U, top_plane=None):
        """Each local shard's top plane: the last, or ``top_plane``'s."""
        if top_plane is None:
            return U[:, -1]
        idx = top_plane.view(-1, 1, 1, 1).expand(-1, 1, *U.shape[2:])
        return torch.gather(U, 1, idx)[:, 0]

    def slab_exchange_add(self, U, top_plane=None):
        """``LocalComm.slab_exchange_add`` over the processes: each plane
        gets its one add, so the result is the one process's bitwise."""
        self._check(U, "slab_exchange_add")
        lo = U[:, 0].clone()
        hi = self._top_planes(U, top_plane).clone()
        return self.slab_exchange_finish(
            U, self.slab_exchange_start(lo, hi), top_plane)
