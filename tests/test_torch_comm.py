"""The port's single-process collectives (runtime/comm.LocalComm) against
``jax.lax.ppermute``, ``jax.lax.psum`` and ``jax.lax.all_gather`` under
``jax.shard_map`` on the 8-device CPU mesh of tests/conftest.py, on the
slab chain's pairs and the composite's cyclic ones, and its slab exchange
against the JAX package's: the values must be equal exactly (a
permutation or a gather moves values; a psum of integer-valued f64
partials is exact in any order)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P


from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.comm import LocalComm, chain_pairs

from composite_twins import one_torch_thread  # noqa: F401 (autouse)


def _jax_collective(fn, x, nshards):
    mesh = jax.make_mesh((nshards,), ("shard",))
    f = jax.shard_map(lambda a: fn(a[0])[None], mesh=mesh,
                      in_specs=P("shard"), out_specs=P("shard"))
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def _field(nshards, seed=0, shape=(3, 4, 5)):
    return np.random.default_rng(seed).standard_normal((nshards,) + shape)


@pytest.mark.parametrize("nshards", [2, 3, 5, 8])
def test_chain_ppermute_matches_jax(nshards):
    x = _field(nshards)
    comm = LocalComm(nshards)
    for pairs in chain_pairs(nshards):
        want = _jax_collective(
            lambda a: jax.lax.ppermute(a, "shard", list(pairs)), x, nshards)
        got = comm.ppermute(torch.as_tensor(x), pairs).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("pairs", [((0, 2), (2, 0)), ((1, 7), (5, 4)),
                                   ((0, 1), (2, 3))])
def test_ppermute_takes_only_one_shift(pairs):
    # the chain's pairs shift one run of shards by one offset; any other
    # pair list has no caller and raises
    with pytest.raises(NotImplementedError):
        LocalComm(8).ppermute(torch.zeros(8, 2), pairs)


@pytest.mark.parametrize("nshards", [1, 4, 5, 8])
def test_psum_matches_jax(nshards):
    # integer-valued f64: every order of summation gives the same value
    x = np.round(_field(nshards, seed=2) * 1000)
    want = _jax_collective(lambda a: jax.lax.psum(a, "shard"), x, nshards)
    got = LocalComm(nshards).psum(torch.as_tensor(x)).numpy()
    for p in range(nshards):       # jax's psum is replicated on every shard
        assert np.array_equal(got, want[p])


def test_comm_checks_its_shard_axis():
    comm = LocalComm(4)
    assert comm.local_shards == 4
    with pytest.raises(ValueError):
        comm.psum(torch.zeros(3, 2))
    with pytest.raises(ValueError):
        comm.ppermute(torch.zeros(5, 2), ((0, 1),))
    with pytest.raises(ValueError):
        comm.slab_exchange_add(torch.zeros(3, 2, 2, 2))
    x, y = torch.ones(()), torch.zeros(3)
    got = comm.allreduce(x, y)     # one process: the local sums are totals
    assert len(got) == 2 and got[0] is x and got[1] is y
    with pytest.raises(ValueError):
        LocalComm(0)
    assert chain_pairs(1) == ((), ())
    assert np.array_equal(comm.ppermute(torch.ones(4, 2), ()).numpy(),
                          np.zeros((4, 2)))


@pytest.mark.parametrize("layers", [(2, 2, 2, 2), (2, 2, 1, 1, 1),
                                    (1, 1, 0, 0)])
def test_slab_exchange_matches_jax(layers):
    # LocalComm's in-place exchange against the JAX package's
    # ops/gather_scatter.slab_exchange_add (two chain ppermutes) under
    # shard_map: uniform slabs (the static top plane)
    # and ragged ones (each shard's real top plane, a shard with no
    # layers at the last plane as JAX's dynamic index reads its -1),
    # bitwise
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_tpu.ops import gather_scatter as jgs
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import top_planes
    n, nshards = 3, len(layers)
    ragged = len(set(layers)) > 1
    x = _field(nshards, seed=4, shape=(max(layers) * n, 4, 6))
    mesh = jax.make_mesh((nshards,), ("shard",))
    lay = np.asarray(layers, dtype=np.int32)
    f = jax.shard_map(
        lambda a, l: jgs.slab_exchange_add(
            a[0], "shard", top_plane=(l[0] * n - 1) if ragged else None)[None],
        mesh=mesh, in_specs=(P("shard"), P("shard")),
        out_specs=P("shard"))
    want = np.asarray(jax.jit(f)(jnp.asarray(x), jnp.asarray(lay)))
    top = (top_planes(torch.as_tensor(lay, dtype=torch.int64), n, x.shape[1])
           if ragged else None)
    got = LocalComm(nshards).slab_exchange_add(torch.as_tensor(x).clone(),
                                               top).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nshards", [1, 3, 5, 8])
def test_all_gather_matches_jax(nshards):
    # the composite's far field: every shard's coarsest level, tiled along
    # its first axis (shard-major), on every shard
    x = _field(nshards, seed=6)
    want = _jax_collective(
        lambda a: jax.lax.all_gather(a, "shard", axis=0, tiled=True), x,
        nshards)
    got = LocalComm(nshards).all_gather(torch.as_tensor(x)).numpy()
    assert got.shape == (nshards * x.shape[1],) + x.shape[2:]
    # jax's tiled all-gather is replicated on every shard: one copy here
    for p in range(nshards):
        assert np.array_equal(got, want.reshape((nshards,) + got.shape)[p])


@pytest.mark.parametrize("nshards", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("offset", [1, -1])
def test_cyclic_shift_matches_jax(nshards, offset):
    # the composite's ring blocks: shard i receives shard (i + offset) mod
    # P's block, the cyclic ppermute of subdomain.py's _rings_above
    # (offset 1) and _rings_below (offset -1)
    x = _field(nshards, seed=7)
    pairs = [((i + offset) % nshards, i) for i in range(nshards)]
    want = _jax_collective(lambda a: jax.lax.ppermute(a, "shard", pairs),
                           x, nshards)
    got = LocalComm(nshards).cyclic_shift(torch.as_tensor(x), offset)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        LocalComm(nshards + 1).cyclic_shift(torch.as_tensor(x), offset)
