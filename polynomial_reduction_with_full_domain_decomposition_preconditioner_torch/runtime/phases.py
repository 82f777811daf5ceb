"""Phase-timing report: the reference's timed-region taxonomy.

Port of the JAX package's ``runtime/phases.py``. The reference wraps
every solver phase in synchronized timers (domain.{operator_application,
inner_products, ...}, subdomain.{tree_*, preconditioner.*}). Here two
measurements stand in for those brackets, as in the JAX package:

1. **Differential solve marginals**: the same problem solved with
   components successively enabled at a fixed iteration count; per-phase
   costs are the marginals.
2. **Region chains** (``Domain.phase_chain``): each region closure (outer
   operator / dssum, the composite tree cascade and exchange, the
   composite operator, the composite assembly, the inner V-cycle and its
   legs) applied in a chain with a loop-carried dependency and
   difference-timed, (t(2N) - t(N)) / N, which cancels the fixed costs.
   A normalize-only chain is the baseline and is subtracted, so each row
   is the marginal cost of that region per application.

The port launches every operation of a chain from the host, one after
the other: on the card a row holds its launches' host time as well as
the kernels', which is what the port's solve pays for that region. Times
are wall clock, with the device synchronized before each start and stop
on the card (runtime/timer.Timer's rule) and nothing to synchronize on
the CPU.
"""

from __future__ import annotations

import sys
import time

import torch

__all__ = ["phase_report"]


def _sync(dom):
    if dom.device.type == "cuda":
        torch.cuda.synchronize(dom.device)


def _timed_solve(dom, f, repeats=3, **solver_kw):
    solve = dom.solver(**solver_kw)
    res = solve(f)
    _sync(dom)
    best = float("inf")
    for _ in range(repeats):
        _sync(dom)
        t = time.perf_counter()
        res = solve(f)
        _sync(dom)
        best = min(best, time.perf_counter() - t)
    return best, int(res.iterations)


def _timed(dom, fn, f):
    _sync(dom)
    t = time.perf_counter()
    fn(f)
    _sync(dom)
    return time.perf_counter() - t


def _chain_time(dom, pre, kind, f, iters=12, repeats=3):
    """Per-application seconds of one region, difference-timed."""
    f1 = dom.phase_chain(pre, kind, iters)
    f2 = dom.phase_chain(pre, kind, 2 * iters)
    f1(f)
    f2(f)
    b1 = b2 = float("inf")
    for _ in range(repeats):
        b1 = min(b1, _timed(dom, f1, f))
        b2 = min(b2, _timed(dom, f2, f))
    return max(b2 - b1, 0.0) / iters


def phase_report(dom, mesh_builder, cfg=None, iterations: int = 10,
                 out=sys.stdout, chain_iters: int = 12) -> dict:
    """Print and return the per-phase tables (the reference's schema) for
    the composite-preconditioned solve."""
    from ..solvers import subdomain as sub
    from .config import Config

    cfg = cfg or Config()
    u_star = dom.initial_function(4, seed=0)
    f = dom.manufacture_rhs(u_star)
    kw = dict(max_iterations=iterations, tolerance=1e-30)

    def pre(inner):
        return sub.composite_dd(
            dom, mesh_builder, poly_reduction=cfg.poly_reduction,
            subdomain_overlap=cfg.subdomain_overlap,
            superdomain_overlap=cfg.superdomain_overlap,
            num_iterations=cfg.inner_iterations, inner=inner,
            num_vcycles=cfg.num_vcycles, cheby_order=cfg.cheby_order,
            ptype=cfg.ptype_dtype(), max_coarse=cfg.max_coarse,
            far_coarsen=cfg.far_coarsen)

    # each composite is dropped before the next is built
    t_fcg, _ = _timed_solve(dom, f, method="fcg", **kw)
    t_skel, _ = _timed_solve(dom, f, method=cfg.solver, **kw)
    t_qqt, _ = _timed_solve(dom, f, method=cfg.solver, precond=pre("none"),
                            **kw)
    t_jac, _ = _timed_solve(dom, f, method=cfg.solver,
                            precond=pre("jacobi"), **kw)
    pre_full = pre("amg")
    t_full, _ = _timed_solve(dom, f, method=cfg.solver, precond=pre_full,
                             **kw)

    it = iterations
    marginals = {
        # the reference's names, per outer iteration
        "domain.operator+vector_operations (FCG floor)": t_fcg / it,
        "domain.krylov_basis (GMRES - FCG)": (t_skel - t_fcg) / it,
        "subdomain.tree+inner_solver (QQt inner)": (t_qqt - t_skel) / it,
        "subdomain.inner_preconditioner.jacobi": (t_jac - t_qqt) / it,
        "subdomain.preconditioner.vcycle (amg - jacobi)":
            (t_full - t_jac) / it,
        "total per iteration": t_full / it,
    }

    # region chains (per application of each region); the optional kinds
    # depend on which composite is active: a kind its parts do not expose
    # reads None
    kinds = ["nrm", "op", "dssum", "cnrm", "comp_op", "comp_dssum",
             "inner_precond", "tree_cascade", "tree_rhs",
             "inner_smooth", "inner_transfer", "inner_coarse",
             # structured exposes tree_rings / tree_coarse; unstructured
             # exposes tree_levels; comp_assemble needs the face-block
             # (or structured) dssum
             "comp_assemble", "tree_rings", "tree_coarse", "tree_levels"]
    ct = {}
    for k in kinds:
        try:
            ct[k] = _chain_time(dom, pre_full, k, f, iters=chain_iters)
        except (ValueError, KeyError):
            ct[k] = None
    ki = cfg.inner_iterations
    regions = {
        # outer solve. The 'op' chain is nrm(dssum(operator(x))), so the
        # dssum chain, reported as its own stitching row, is subtracted
        "domain.operator_application": ct["op"] - ct["dssum"],
        "domain.inner_products+vector_operations (1 dot + 1 scale)":
            ct["nrm"],
        "subdomain.stitching (outer dssum)": ct["dssum"] - ct["nrm"],
        # the preconditioner's tree
        "subdomain.tree_construction (restriction cascade)":
            ct["tree_cascade"],
        "subdomain.tree_exchange (rings+coarse gather+far)":
            ct["tree_rhs"] - ct["tree_cascade"],
        # the composite inner solve, per inner application (x{ki} an
        # outer iteration)
        f"subdomain.operator_application (x{ki})":
            ct["comp_op"] - ct["cnrm"],
        f"subdomain.preconditioner.assemble+unassemble (x{ki})":
            ct["comp_dssum"] - ct["cnrm"],
        f"subdomain.preconditioner.vcycle legs+coarse (x{ki})":
            ct["inner_precond"] - ct["cnrm"],
        # the V-cycle's legs: down / coarse grid / up
        f"subdomain.preconditioner.smooth_leg (x{ki}, 1 Chebyshev)":
            ct["inner_smooth"] - ct["cnrm"],
        f"subdomain.preconditioner.transfer_legs (x{ki}, R+P)":
            ct["inner_transfer"] - ct["cnrm"],
        f"subdomain.preconditioner.coarse_grid_solver (x{ki})":
            ct["inner_coarse"] - ct["inner_transfer"],
        "subdomain.inner_products+vector_operations (1 dot + 1 scale)":
            ct["cnrm"],
    }
    if ct["tree_rings"] is not None:      # structured composite
        rings = ct["tree_rings"] - ct["tree_cascade"]
        coarse = ct["tree_coarse"] - ct["tree_cascade"]
        regions["subdomain.tree_exchange.rings (ppermute legs)"] = rings
        regions["subdomain.tree_exchange.coarse (all_gather)"] = coarse
        regions["subdomain.tree_exchange.superdomain (far restrict)"] = (
            ct["tree_rhs"] - ct["tree_cascade"] - rings - coarse)
    if ct["tree_levels"] is not None:     # unstructured composite
        lev = ct["tree_levels"] - ct["tree_cascade"]
        regions["subdomain.tree_exchange.levels (all_gather+takes)"] = lev
        regions["subdomain.tree_exchange.superdomain (project P^T)"] = (
            ct["tree_rhs"] - ct["tree_cascade"] - lev)
    if ct["comp_assemble"] is not None:
        asm = ct["comp_assemble"] - ct["cnrm"]
        regions[f"subdomain.preconditioner.assemble (x{ki}, gather)"] = asm
        regions[f"subdomain.preconditioner.unassemble (x{ki}, "
                "scatter+stitch)"] = ct["comp_dssum"] - ct["cnrm"] - asm
    # a subtracted marginal below the timing noise reads negative; it is
    # reported as 0 (the region costs less than the measurement's noise)
    regions = {k: max(v, 0.0) for k, v in regions.items()}

    print("phase report — differential solve marginals "
          "(per outer iteration):", file=out)
    for k, v in marginals.items():
        print(f"  {k}: {v * 1e3:.2f} ms", file=out)
    print("phase report — device-measured regions "
          "(chained, per application):", file=out)
    for k, v in regions.items():
        print(f"  {k}: {v * 1e3:.3f} ms", file=out)
    return {**marginals, **{f"region.{k}": v for k, v in regions.items()}}
