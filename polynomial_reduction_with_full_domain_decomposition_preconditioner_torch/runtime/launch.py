"""One process of a P-shard solve across processes.

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.launch \\
        RANK PROCESSES COORDINATOR BACKEND CONFIG.json OUT.json

Every process of the run is started with the same arguments but its own
RANK (0 .. PROCESSES-1). COORDINATOR is ``host:port`` or a
``file:///path`` store, BACKEND "gloo" or "nccl". CONFIG holds
``{"device": "cpu" | null, "threads": int | null, "runs": [...]}``; each
run is a dict:

  name        label of the run
  mesh        {"kind": "kershaw" | "box", "shape", "order", "epsilon",
              "extent", "scramble": {"seed", "permute"} | null}
  shards      P, a multiple of PROCESSES
  dtype       "float32" | "float64"
  precond     {"kind": "composite" | "pmultigrid", **its keywords}
              (a "ptype" keyword is a dtype name)
  method, max_iterations, tolerance      the outer solve
  u_star      {"function_id", "seed"} of the manufactured solution
  setup_cache a directory: the composite is built twice, the second time
              from the per-process setup cache the first build wrote
  exchange_reps  time this many slab exchanges alone after the solve
  phase_chains   {"kinds": [...], "iters": n}: after the solve, the
              value of ``Domain.phase_chain(precond, kind, n)(f)`` for
              each kind (the max over every shard of every process)

Each process initializes the group, takes its shards
(``runtime/distributed.owned_shards``), partitions the mesh for them
alone, builds its Domain over a ``ProcessComm``, the preconditioner and
the solve. Rank 0 writes OUT: per run the iteration count, the residual
history and the largest |u - u*| over every shard, and per process its
seconds, launches and launch signatures, comm counters and cache hit.
It imports torch, numpy and scipy only.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import numpy as np
import torch

from ..mesh import generator as mg
from ..mesh.partition import partition_mesh
from ..ops import kernels
from ..solvers.domain import Domain
from ..solvers.preconditioners import pmultigrid
from ..solvers.subdomain import composite_dd
from .comm import LocalComm, ProcessComm
from .distributed import initialize_multihost, owned_shards

__all__ = ["main", "run_one", "mesh_builder"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def mesh_builder(spec: dict, device):
    """order -> GlobalMesh for a run's mesh spec."""
    kind = spec.get("kind", "kershaw")
    shape = tuple(spec["shape"])
    extent = tuple(spec["extent"]) if spec.get("extent") else None
    if kind == "kershaw":
        base = partial(mg.kershaw_mesh, shape,
                       epsilon=spec.get("epsilon", 0.3), extent=extent,
                       device=device)
    elif kind == "box":
        base = partial(mg.box_mesh, shape, extent=extent, device=device)
    else:
        raise ValueError(f"unknown mesh kind {kind!r}")
    scr = spec.get("scramble")
    if scr is None:
        return base
    return lambda o: mg.scramble_mesh(base(o), seed=scr["seed"],
                                      permute=scr.get("permute", True),
                                      device=device)


def _precond(dom, mk, mesh, spec: dict, cache_path=None):
    kw = dict(spec)
    kind = kw.pop("kind")
    if "ptype" in kw:
        kw["ptype"] = _DTYPES[kw["ptype"]]
    if kind == "composite":
        if cache_path is not None:
            kw["chain_cache"] = cache_path   # the setup cache on unstructured meshes
        return composite_dd(dom, mk, fine_mesh=mesh, **kw)
    if kind == "pmultigrid":
        return pmultigrid(dom, mk, **kw)
    raise ValueError(f"unknown preconditioner {kind!r}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_one(run: dict, device, local: bool = False) -> dict:
    """One run of the config in this process, with collectives across
    the group's processes; ``local``: the same run with every shard in
    this one process (``LocalComm``), the reference a multi-process run
    is held to. Returns this process's record."""
    P = run["shards"]
    mk = mesh_builder(run["mesh"], device)
    mesh = mk(run["mesh"]["order"])
    owned = tuple(range(P)) if local else owned_shards(P)
    comm = LocalComm(P) if local else ProcessComm(P)
    dom = Domain(partition_mesh(mesh, P, owned=owned),
                 dtype=_DTYPES[run.get("dtype", "float64")], device=device,
                 comm=comm)
    us = run.get("u_star", {"function_id": 4, "seed": 1})
    u_star = dom.initial_function(us["function_id"], seed=us["seed"])
    f = dom.manufacture_rhs(u_star)
    cache_hit = None
    if not local:
        kernels.take_signatures()
    t0 = time.perf_counter()
    if run.get("setup_cache"):
        path = f"{run['setup_cache']}/setup_{run['name']}.npz"
        _precond(dom, mk, mesh, run["precond"], path)
        pre = _precond(dom, mk, mesh, run["precond"], path)
        cache_hit = "load" in pre.extra.get("setup_seconds", {})
    else:
        pre = _precond(dom, mk, mesh, run["precond"])
    _sync(device)
    setup_s = time.perf_counter() - t0
    solve = dom.solver(method=run.get("method", "fgmres"),
                       max_iterations=run.get("max_iterations", 100),
                       tolerance=run.get("tolerance", 1e-8), precond=pre)
    stats0 = dict(getattr(comm, "stats", {}))
    kernels.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    res = solve(f)
    _sync(device)
    solve_s = time.perf_counter() - t0
    launches = kernels.counts()
    stats = {k: v - stats0[k] for k, v in getattr(comm, "stats", {}).items()}
    hist = res.residual_history.double().cpu().numpy()
    err = float((res.u.double() - u_star.double()).abs().max())
    rec = {"name": run["name"], "owned": list(owned),
           "iterations": int(res.iterations),
           "converged": bool(res.converged),
           "history": hist[np.isfinite(hist)].tolist(),
           "err_local": err, "setup_seconds": setup_s,
           "solve_seconds": solve_s, "cache_hit": cache_hit,
           "launches": launches, "comm": stats}
    chains = run.get("phase_chains")
    if chains:
        rec["phase_chains"] = {
            k: dom.phase_chain(pre, k, chains["iters"])(f)
            for k in chains["kinds"]}
    if not local:
        # the launch signatures of the setup, the solve and the chains, so
        # that the caller can hold each kernel to its twin at them
        rec["signatures"] = kernels.take_signatures()
    reps = run.get("exchange_reps", 0)
    if reps and dom.lattice_shape is not None and not local:
        U = torch.zeros((dom.num_owned,) + dom.lattice_shape,
                        dtype=dom.dtype, device=device)
        top = dom._top
        comm.slab_exchange_add(U, top)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            comm.slab_exchange_add(U, top)
        _sync(device)
        rec["exchange_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rank, nproc, coordinator, backend, config, out = argv[:6]
    rank, nproc = int(rank), int(nproc)
    with open(config) as fh:
        cfg = json.load(fh)
    if cfg.get("threads"):
        torch.set_num_threads(int(cfg["threads"]))
    device = torch.device("cuda" if cfg.get("device") is None
                          else cfg["device"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this process")
        torch.cuda.set_device(device.index or 0)
        device = torch.device("cuda", torch.cuda.current_device())
    initialize_multihost(coordinator, nproc, rank, backend,
                         timeout_seconds=cfg.get("timeout_seconds", 600))
    import torch.distributed as dist
    records = []
    for run in cfg["runs"]:
        mine = run_one(run, device)
        every = [None] * nproc
        dist.all_gather_object(every, mine)
        records.append({
            "name": run["name"],
            "iterations": mine["iterations"],
            "converged": mine["converged"],
            "history": mine["history"],
            "err": max(r["err_local"] for r in every),
            "same_history": all(r["history"] == mine["history"]
                                for r in every),
            "processes": [{k: r[k] for k in r if k != "history"}
                          for r in every]})
    if rank == 0:
        with open(out, "w") as fh:
            json.dump({"processes": nproc, "backend": backend,
                       "device": str(device), "runs": records}, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
