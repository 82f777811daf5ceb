"""The fem-amg V-cycle ablation at the reference's default inner(4). Port
of the JAX package's ``artifacts/run_femamg_i4_ablate.py``.

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.femamg_i4_ablate \\
        [--device DEV] [--out PATH]

Kershaw eps=0.3 16^3 N=7, the composite r = 6 with inner "fem-amg" and 4
inner steps under f32 FGMRES(20), at most 200 iterations (the script's
``Config``, ``config``), for each knob set of ``ABLATIONS`` (the
script's: the V-cycles an inner application and the Chebyshev order of
its smoother). "base" is the reference's defaults, the configuration of
the JAX package's ``artifacts/femamg_production_16cubed.json``. Each run
is the driver's (``runtime/driver.simulate``), on one mesh, partition
and Domain built once; its progress text goes to standard error.

The record has the script's keys for each tag (``knobs``,
``iterations``, ``converged``, ``solve_seconds``) and the port's
additions: the residual history, max|u - u*|, the host setup seconds by
stage and the card's name and power limit. It runs on the card unless
``--device`` names another device, prints the record as one JSON line,
then the counts as the script prints them, and writes the record to
``--out`` when given; it writes nothing else (the JAX package's records
in ``artifacts/`` are that package's).
"""

from __future__ import annotations

import argparse
import json
import sys
from functools import partial

from ..runtime.config import Config
from ..runtime.driver import build_problem, simulate
from ..utils.timing import card

__all__ = ["ABLATIONS", "config", "main", "run"]

ABLATIONS = {
    "base":  dict(num_vcycles=1, cheby_order=2),
    "cheb4": dict(num_vcycles=1, cheby_order=4),
    "v22":   dict(num_vcycles=2, cheby_order=2),
    "c4v2":  dict(num_vcycles=2, cheby_order=4),
}
SHAPE = (16, 16, 16)


def config(tag: str = "base", **fields) -> Config:
    """The script's run of ``tag`` as the driver's configuration, with
    ``fields`` replacing the script's (e.g. a smaller mesh, or a
    ``checkpoint`` directory: the script's is a path of its own machine,
    this one has none)."""
    if tag not in ABLATIONS:
        raise ValueError(f"tag {tag!r}: one of {list(ABLATIONS)}")
    return Config(mesh="kershaw", shape=SHAPE, epsilon=0.3, poly_degree=7,
                  poly_reduction=6, inner="fem-amg", inner_iterations=4,
                  max_iterations=200, **ABLATIONS[tag]).replace(**fields)


def run(tags=None, *, device=None, fields: dict | None = None,
        after_solve=None) -> dict:
    """The ablation over ``tags`` (None: every tag of ``ABLATIONS``) on
    ``device`` (None: the card), every tag on one mesh, partition and
    Domain; returns {tag: record}.

    fields: Config fields that replace the script's in every run.
    after_solve: the driver's hook with the tag first,
      ``after_solve(tag, domain, solve, f, precond)`` after each tag's
      timed solves (e.g. to profile one more solve).
    """
    fields = dict(fields or {})
    tags = list(ABLATIONS) if tags is None else list(tags)
    setup = build_problem(config(**fields), device)
    out = {}
    for tag in tags:
        cfg = config(tag, **fields)
        res = simulate(cfg, out=sys.stderr, problem=setup,
                       after_solve=None if after_solve is None
                       else partial(after_solve, tag))
        r, stages = res.record, dict(res.stages)
        out[tag] = {
            "knobs": ABLATIONS[tag], "iterations": r["iterations"],
            "converged": r["converged"], "solve_seconds": r["solve_seconds"],
            # the port's additions
            "residual_history": r["residual_history"],
            "max_error": r["max_error"], "config": r["config"],
            "stage_seconds": stages.pop("seconds"), "memory": stages,
            "card": card(setup.dom.device)}
        print(f"{tag}: {r['iterations']} iterations "
              f"({r['solve_seconds']:.2f}s)", file=sys.stderr)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m polynomial_reduction_with_full_domain_decomposition_"
             "preconditioner_torch.studies.femamg_i4_ablate",
        description="The fem-amg V-cycle ablation at inner(4).")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    rec = run(device=a.device)
    line = json.dumps(rec)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    print(json.dumps({t: v["iterations"] for t, v in rec.items()}))
    return 0 if all(v["converged"] for v in rec.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
