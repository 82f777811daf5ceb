"""The reference's headline mesh on one card: Kershaw 64^3 N=7 (134,217,728
points). Port of the JAX package's ``artifacts/run_64cubed.py``.

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.scaleup \\
        [m] [inner_iters] [method] [nv] [epsilon] [cheby_order] \\
        [num_vcycles] [inner_solver] [ptype] [refine] [--device DEV] \\
        [--out PATH]

The positional arguments are the script's, in its order and with its
defaults: m 64, inner_iters 3, method ``fcg`` | ``fgmres`` |
``fgmres-z16`` (a bf16 Z basis), nv 8 (the FGMRES restart), epsilon 0.3,
cheby_order 2, num_vcycles 1, inner_solver ``fgmres`` | ``fcg``, ptype
``bf16`` | ``f32``. The tenth is the f64 refinement to the reference's
1e-7 criterion: ``host`` (the script's ``host_refine_solve``, the
default), ``device`` (``solvers/refine.refine_solve`` on an f64 Domain)
or ``none`` (the script's ``norefine``). It runs on the card unless
``--device`` names another device. It prints the record as one JSON line
and writes it to ``--out`` when given; it writes nothing else (the JAX
package's records in ``artifacts/`` are that package's).

The run is the driver's (``runtime/driver.simulate``) on the script's
configuration (``config``): the same steps as the CLI with
``--mesh kershaw --shape m,m,m --max-iterations 100`` and the script's
solver options, its progress text on standard error. This module maps
the script's arguments to that configuration and the driver's outcome to
the script's record: its keys, solver string and file name, and beside
them the seconds, the card's peak and held allocation and the host's peak
resident memory of each stage and, refined on the host, the seconds of
each host f64 residual. ``build_setup`` builds the mesh, partition
and Domain once, so that several ``run`` calls can share them.
"""

from __future__ import annotations

import json
import sys

import torch

from ..runtime.config import Config
from ..runtime.driver import Problem, build_problem, simulate

__all__ = ["build_setup", "config", "main", "record_file", "run",
           "solver_name"]

ORDER = 7
POLY_REDUCTION = 6
MAX_ITERATIONS = 100
REFINE_TOLERANCE = 1e-7          # the reference's criterion, domain.hpp:118
REFINE_MODES = ("host", "device", "none")
PTYPES = {"bf16": "bfloat16", "f32": "float32"}
SETUP_STAGES = ("mesh", "partition", "domain")


def config(m: int = 64, inner_iters: int = 3, method: str = "fcg",
           nv: int = 8, epsilon: float = 0.3, cheby_order: int = 2,
           num_vcycles: int = 1, inner_solver: str = "fgmres",
           ptype: str = "bf16", refine_mode: str = "host") -> Config:
    """The script's run as the driver's configuration: an f32 outer solve
    to 1e-4 of r0 in at most 100 iterations, the composite r = 6 with
    inner "amg", u* the manufactured solution 4 of seed 0."""
    if method not in ("fcg", "fgmres", "fgmres-z16"):
        raise ValueError(f"method {method!r}: fcg, fgmres or fgmres-z16")
    if inner_solver not in ("fgmres", "fcg"):
        raise ValueError(f"inner_solver {inner_solver!r}: fgmres or fcg")
    if ptype not in PTYPES:
        raise ValueError(f"ptype {ptype!r}: bf16 or f32")
    if refine_mode not in REFINE_MODES:
        raise ValueError(f"refine_mode {refine_mode!r}: one of "
                         f"{REFINE_MODES}")
    refine = refine_mode != "none"
    return Config(
        mesh="kershaw", shape=(m, m, m), epsilon=epsilon, poly_degree=ORDER,
        poly_reduction=POLY_REDUCTION, ptype=PTYPES[ptype],
        solver="fcg" if method == "fcg" else "fgmres", num_vectors=nv,
        ztype="bfloat16" if method == "fgmres-z16" else None,
        max_iterations=MAX_ITERATIONS,
        refine_tolerance=REFINE_TOLERANCE if refine else None,
        refine_mode=refine_mode if refine else "device", inner="amg",
        inner_iterations=inner_iters, inner_solver=inner_solver,
        num_vcycles=num_vcycles, cheby_order=cheby_order,
        manufactured_solution=4, seed=0)


def build_setup(m: int = 64, epsilon: float = 0.3, device=None,
                mesh_builder=None) -> Problem:
    """The script's mesh stage: ``kershaw_mesh((m, m, m), 7)``,
    ``partition_mesh(mesh, 1)`` and an f32 Domain on ``device`` (None:
    the card). ``mesh_builder`` (order -> GlobalMesh) stands in for the
    Kershaw generator."""
    return build_problem(config(m, epsilon=epsilon), device, mesh_builder)


def solver_name(method, nv, inner_iters, inner_solver, ptype, cheby_order,
                num_vcycles) -> str:
    """The record's ``solver`` string, as the script forms it."""
    return (f"{method}" + (f"({nv})" if method != "fcg" else "")
            + f" + composite({ptype}, inner "
            f"{'FCG' if inner_solver == 'fcg' else 'GMRES'}"
            f"({inner_iters}), cheby {cheby_order}, {num_vcycles} vcycle)")


def record_file(m, inner_iters, method, nv, epsilon, cheby_order,
                num_vcycles, inner_solver, ptype) -> str:
    """The name the script gives the record: scaleup_{m}cubed{tag}.json."""
    tag = "" if method == "fcg" else f"_{method}{nv}i{inner_iters}"
    if inner_solver != "fgmres":
        tag += f"_is{inner_solver}"
    if ptype != "bf16":
        tag += f"_pt{ptype}"
    if epsilon != 0.3:
        tag += f"_e{epsilon}"
    if (cheby_order, num_vcycles) != (2, 1):
        tag += f"_c{cheby_order}v{num_vcycles}"
    return f"scaleup_{m}cubed{tag}.json"


def run(m: int = 64, inner_iters: int = 3, method: str = "fcg", nv: int = 8,
        epsilon: float = 0.3, cheby_order: int = 2, num_vcycles: int = 1,
        inner_solver: str = "fgmres", ptype: str = "bf16",
        refine_mode: str = "host", *, device=None, setup: Problem | None = None,
        after_solve=None) -> dict:
    """The script's run; returns its record with the port's additions.

    setup: a ``build_setup(m, epsilon, device)`` to reuse; built here when
      None.
    after_solve: the driver's hook, ``after_solve(domain, solve, f,
      precond)`` after the timed solves (e.g. to profile one more solve).
    The driver's text goes to standard error.
    """
    cfg = config(m, inner_iters, method, nv, epsilon, cheby_order,
                 num_vcycles, inner_solver, ptype, refine_mode)
    res = simulate(cfg, out=sys.stderr, device=device, problem=setup,
                   after_solve=after_solve)
    r, stages, rr = res.record, dict(res.stages), res.refinement
    timers = r["timers"]
    seconds = stages.pop("seconds")
    dom = res.problem.dom
    rec = {
        "mesh": f"kershaw eps={epsilon} {m}^3 N={ORDER} r={POLY_REDUCTION}",
        "points": res.problem.mesh.num_points,
        "solver": solver_name(method, nv, inner_iters, inner_solver, ptype,
                              cheby_order, num_vcycles),
        "iterations": r["iterations"],
        "converged": r["converged"],
        "residual_history": r["residual_history"],
        "max_error": r["max_error"],
        "solve_seconds": r["solve_seconds"],
        "first_solve_seconds": timers["solve.compile"]["total_s"],
        "setup_mesh_seconds": sum(seconds[k] for k in SETUP_STAGES),
        "setup_preconditioner_seconds": seconds["preconditioner"],
    }
    if rr is not None:
        rec.update(
            refined_rel_residual=r["refined_rel_residual"],
            refined_cycles=r["refined_cycles"],
            refined_inner_iterations=rr.inner_iterations,
            refined_max_error=r["refined_max_error"],
            refined_converged=r["refined_converged"],
            refine_seconds=timers["solve.refine"]["total_s"],
            refined_history=list(rr.history))
        if refine_mode == "host":
            rec["refined_residual_seconds"] = list(rr.residual_seconds)
    # the port's additions
    rec.update(
        file=record_file(m, inner_iters, method, nv, epsilon, cheby_order,
                         num_vcycles, inner_solver, ptype),
        device=(torch.cuda.get_device_name(dom.device)
                if dom.device.type == "cuda" else str(dom.device)),
        refine_mode=refine_mode, stage_seconds=seconds, memory=stages)
    return rec


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--device": None, "--out": None}
    pos = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it, None)
            if opts[a] is None:
                raise SystemExit(f"{a} needs a value")
        else:
            pos.append(a)
    if len(pos) > 10:
        raise SystemExit(f"at most 10 positional arguments, got {pos}")
    kinds = [int, int, str, int, float, int, int, str, str, str]
    names = ["m", "inner_iters", "method", "nv", "epsilon", "cheby_order",
             "num_vcycles", "inner_solver", "ptype", "refine_mode"]
    kw = {k: t(v) for k, t, v in zip(names, kinds, pos)}
    if kw.get("refine_mode") == "norefine":
        kw["refine_mode"] = "none"
    rec = run(**kw, device=opts["--device"])
    line = json.dumps(rec)
    print(line, flush=True)
    if opts["--out"]:
        with open(opts["--out"], "w") as fh:
            fh.write(line + "\n")
    return 0 if rec["converged"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
