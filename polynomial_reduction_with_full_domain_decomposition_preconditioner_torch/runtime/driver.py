"""Solver driver: the reference's poisson.cpp flow on PyTorch.

Port of the JAX package's ``runtime/driver.py``: build the mesh and the
level hierarchy, construct the preconditioner, manufacture the
right-hand side f = A u* from a random u*, run FCG or FGMRES, and print
the run-info block, the convergence history and the timing report.

Where the JAX package builds a device mesh for ``num_shards > 1``, the
port's Domain holds the shards itself: all of them in this process
(``runtime/comm.LocalComm``), or, in a run across processes
(``runtime/distributed.py``), this process's own over a ``ProcessComm``.
The JAX driver's persistent XLA compile cache has no counterpart: the
port's kernels are built once into the package's ``_build/`` directory.
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

import numpy as np
import torch

from .. import resolve_device
from .config import Config
from .timer import Timer

__all__ = ["run_simulation"]


def _setup_tag(cfg: Config) -> str:
    tag = (f"{cfg.mesh}_{'x'.join(map(str, cfg.shape))}"
           f"_e{cfg.epsilon}_s{cfg.scramble}")
    if cfg.mesh == "pebble":
        tag += (f"_p{cfg.num_pebbles}_sf{cfg.solid_fraction}"
                f"_ms{cfg.mesh_seed}")
    return tag


def _mesh_builder(cfg: Config, device):
    """order -> GlobalMesh for the configured mesh family, behind the
    checkpoint directory's mesh cache when there is one (the JAX
    package's file names, so either package finds the other's)."""
    from ..mesh import generator as mg

    if cfg.mesh == "nek":
        from ..mesh.nek import nek_mesh_builder
        if not cfg.nek_dir:
            raise ValueError("--mesh nek requires --nek-dir")
        builder = nek_mesh_builder(cfg.nek_dir, device=device)
    elif cfg.mesh == "kershaw":
        builder = partial(mg.kershaw_mesh, cfg.shape, epsilon=cfg.epsilon,
                          device=device)
    elif cfg.mesh == "pebble":
        from ..mesh.pebble import pebble_mesh
        builder = partial(pebble_mesh, cfg.shape,
                          num_pebbles=cfg.num_pebbles, seed=cfg.mesh_seed,
                          solid_fraction=cfg.solid_fraction, device=device)
    else:
        builder = partial(mg.box_mesh, cfg.shape, device=device)
    if cfg.scramble is not None:
        base = builder
        builder = lambda o: mg.scramble_mesh(base(o), seed=cfg.scramble,
                                             device=device)
    if cfg.checkpoint:
        from .checkpoint import cached_mesh_builder
        builder = cached_mesh_builder(builder, cfg.checkpoint,
                                      _setup_tag(cfg))
    return builder


def _build_domain(cfg: Config, device):
    from ..mesh.partition import partition_mesh
    from ..solvers.domain import Domain
    from . import distributed

    builder = _mesh_builder(cfg, device)
    mesh = builder(cfg.poly_degree)
    owned, comm = None, None
    if distributed.process_count() > 1:
        from .comm import ProcessComm
        owned = distributed.owned_shards(cfg.num_shards)
        comm = ProcessComm(cfg.num_shards)
    sd = partition_mesh(mesh, cfg.num_shards, owned=owned)
    dom = Domain(sd, dtype=cfg.stype_dtype(), device=device, comm=comm)
    return dom, builder, mesh


def _chain_cache(cfg: Config):
    """The composite's setup checkpoint path (None: build afresh): the
    vertex chain on structured meshes (inner "amg"), the whole host setup
    on unstructured ones (a file of its own for fem-amg)."""
    if not cfg.checkpoint or cfg.inner not in ("amg", "fem-amg"):
        return None
    if cfg.scramble is None and cfg.mesh != "pebble":
        if cfg.inner != "amg":
            return None
        return os.path.join(
            cfg.checkpoint,
            f"chain_{cfg.mesh}_{'x'.join(map(str, cfg.shape))}"
            f"_e{cfg.epsilon}_mc{cfg.max_coarse}.npz")
    tag = (_setup_tag(cfg)
           + f"_N{cfg.poly_degree}_r{cfg.poly_reduction}"
           f"_v{cfg.subdomain_overlap}_w{cfg.superdomain_overlap}"
           f"_P{cfg.num_shards}_mc{cfg.max_coarse}_{cfg.ptype}")
    if cfg.inner != "amg":
        tag += f"_{cfg.inner}"
    return os.path.join(cfg.checkpoint, f"usetup_{tag}.npz")


def _build_preconditioner(cfg: Config, dom, mesh_builder, fine_mesh=None):
    from ..solvers import preconditioners as pc
    from ..solvers import subdomain as sub

    if cfg.preconditioner == "composite":
        return sub.composite_dd(
            dom, mesh_builder, poly_reduction=cfg.poly_reduction,
            subdomain_overlap=cfg.subdomain_overlap,
            superdomain_overlap=cfg.superdomain_overlap,
            num_iterations=cfg.inner_iterations, inner=cfg.inner,
            inner_solver=cfg.inner_solver,
            num_vcycles=cfg.num_vcycles, cheby_order=cfg.cheby_order,
            ptype=cfg.ptype_dtype(), max_coarse=cfg.max_coarse,
            far_coarsen=cfg.far_coarsen, fine_mesh=fine_mesh,
            chain_cache=_chain_cache(cfg))
    if cfg.preconditioner == "pmultigrid":
        return pc.pmultigrid(dom, mesh_builder,
                             poly_reduction=cfg.poly_reduction)
    if cfg.preconditioner == "jacobi":
        return pc.jacobi(dom)
    return None


def run_simulation(cfg: Config, out=None, device=None) -> dict:
    """Run one configured solve on ``device`` (None: the card, raising
    without one) and return a structured result record; the text goes to
    ``out`` (None: standard output)."""
    out = sys.stdout if out is None else out
    # checked before any work (the JAX driver checks it after the solve)
    if cfg.output_composite and cfg.preconditioner != "composite":
        raise ValueError("--output-composite needs the composite "
                         "preconditioner")
    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    timer = Timer(device=device)
    timer.initialize()

    with timer("setup.domain"):
        dom, mesh_builder, fine_mesh = _build_domain(cfg, device)
    with timer("setup.preconditioner"):
        pre = _build_preconditioner(cfg, dom, mesh_builder, fine_mesh)

    # run-info block
    sd = dom.sharded
    print(f"dimensions:           {dom.dim}", file=out)
    print(f"elements:             {sd.num_total_elements}", file=out)
    print(f"polynomial degree:    {cfg.poly_degree}", file=out)
    print(f"polynomial reduction: {cfg.poly_reduction}", file=out)
    print(f"shards:               {cfg.num_shards}", file=out)
    print(f"outer solver:         {cfg.solver} "
          f"(stype={cfg.stype})", file=out)
    print(f"preconditioner:       {cfg.preconditioner} "
          f"(inner={cfg.inner}, ptype={cfg.ptype})", file=out)

    with timer("setup.rhs"):
        u_star = dom.initial_function(cfg.manufactured_solution,
                                      seed=cfg.seed)
        f = dom.manufacture_rhs(u_star)
    # u* is needed again only for the error: keep the host copy and free
    # the device field unless the field dump writes it
    u_star_host = dom.from_device_field(u_star)
    if cfg.output is None and not dom.multiprocess:
        u_star = None

    ztype = None
    if cfg.ztype is not None:
        ztype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}[cfg.ztype]
    solve = dom.solver(method=cfg.solver, precond=pre,
                       max_iterations=cfg.max_iterations,
                       num_vectors=cfg.num_vectors,
                       tolerance=cfg.tolerance, z_dtype=ztype)

    def run_once():
        res = solve(f)
        sync()
        return res

    with timer("solve.compile"):
        res = run_once()
    # best of 3, each around a synchronized device, less the cost of one
    # more synchronization (what the interval holds besides the solve)
    best = float("inf")
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        res = run_once()
        total = time.perf_counter() - t0
        t0 = time.perf_counter()
        sync()
        overhead = time.perf_counter() - t0
        best = min(best, max(total - overhead, 0.0))
    timer.record("solve.run", best)

    hist = res.residual_history.double().cpu().numpy()
    iters = int(res.iterations)
    for k in range(min(iters + 1, hist.shape[0])):
        if np.isfinite(hist[k]):
            print(f"iteration: {k:4d}  residual: {hist[k]:.6e}", file=out)
    err = float(np.abs(dom.from_device_field(res.u) - u_star_host).max())
    print(f"converged: {bool(res.converged)}  iterations: {iters}  "
          f"max|u - u*|: {err:.3e}", file=out)

    if cfg.inner_history and cfg.preconditioner == "composite":
        # one preconditioner application's inner FGMRES residuals (the
        # max over the shards: the inner solves are rank-local)
        _, ih = dom.precond_probe(pre)(f)
        ih = ih.double().cpu().numpy()
        for k, v in enumerate(ih[np.isfinite(ih)]):
            print(f"  inner iteration: {k:3d}  residual: {v:.6e}",
                  file=out)

    refined = {}
    if cfg.refine_tolerance is not None and cfg.refine_mode == "host":
        # the f64 side on the host (solvers/host_oracle.py), for sizes
        # where f64 geometry does not fit beside the f32 solver
        from ..solvers.host_oracle import (HostOperator, host_refine_solve,
                                           owned_to_global)
        with timer("solve.refine"):
            host = HostOperator(fine_mesh)
            u_star64 = owned_to_global(dom, u_star_host)
            f64h = host.apply(u_star64)
            rr = host_refine_solve(
                host, dom, solve, f64h, tolerance=cfg.refine_tolerance,
                verbose=lambda c, rel: print(
                    f"refinement cycle: {c:2d}  rel residual: {rel:.6e}",
                    file=out))
        err64 = float(np.abs(rr.u - u_star64).max())
        print(f"f64 refinement (host): rel_res={rr.rel_residual:.3e}  "
              f"cycles={rr.cycles}  inner_iterations="
              f"{rr.inner_iterations}  max|u - u*|: {err64:.3e}  "
              f"converged: {rr.converged}", file=out)
        refined = {"refined_rel_residual": rr.rel_residual,
                   "refined_cycles": rr.cycles,
                   "refined_max_error": err64,
                   "refined_converged": rr.converged}
    elif cfg.refine_tolerance is not None:
        # f64 iterative refinement on the device around the stype solver
        from ..solvers.domain import Domain
        from ..solvers.refine import refine_solve
        with timer("solve.refine"):
            dom64 = Domain(dom.sharded, dtype=torch.float64, comm=dom.comm,
                           device=device)
            u_star64 = dom64.to_device_field(u_star_host)
            f64 = dom64.manufacture_rhs(u_star64)
            rr = refine_solve(dom64, solve, f64,
                              tolerance=cfg.refine_tolerance)
        err64 = float(np.abs(dom64.from_device_field(rr.u)
                             - dom64.from_device_field(u_star64)).max())
        print(f"f64 refinement: rel_res={rr.rel_residual:.3e}  cycles="
              f"{rr.cycles}  inner_iterations={rr.inner_iterations}  "
              f"max|u - u*|: {err64:.3e}  converged: {rr.converged}",
              file=out)
        refined = {"refined_rel_residual": rr.rel_residual,
                   "refined_cycles": rr.cycles,
                   "refined_max_error": err64,
                   "refined_converged": rr.converged}

    print(timer.report(num_shards=cfg.num_shards if cfg.num_shards > 1
                       else None), file=out)

    if cfg.output:
        from ..io.fields import save_fields
        save_fields(cfg.output, dom, u=res.u, u_star=u_star, f=f)
        print(f"fields written to {cfg.output}", file=out)

    if cfg.output_composite:
        from ..io.fields import save_composite_fields
        save_composite_fields(cfg.output_composite, dom, pre,
                              mesh_builder, f)
        print(f"composite-region fields written to {cfg.output_composite}",
              file=out)

    if cfg.phase_report and cfg.preconditioner == "composite":
        from .phases import phase_report
        phase_report(dom, mesh_builder, cfg=cfg,
                     iterations=min(10, max(iters, 2)), out=out)

    return {
        "config": cfg.to_json(),
        "converged": bool(res.converged),
        "iterations": iters,
        "residual_history": hist[np.isfinite(hist)].tolist(),
        "max_error": err,
        "solve_seconds": timer.total("solve.run"),
        "timers": timer.as_dict(),
        **refined,
    }
