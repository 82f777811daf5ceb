"""The reference's pebble-bed family on one card: PB_146 (32^3 lattice,
13,421,568 points) and PB_1568 (48^3 lattice, 48,123,392 points) at N=7.
Port of the JAX package's ``artifacts/run_pebble_production.py``.

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.pebble_production \\
        [146|1568] [--refine host|device|none] [--device DEV] \\
        [--out PATH] [--checkpoint DIR] [--as-recorded]

The family's mesh is the voxel-carved pebble generator's
(``mesh/pebble.py``) at the script's lattice, pebble count, solid
fraction and seed (``FAMILIES``). The run is the driver's
(``runtime/driver.simulate``) on the script's configuration (``config``):
the same steps as the CLI with ``--mesh pebble`` and the script's solver
options, its progress text on standard error. ``--refine`` picks where
the f64 refinement to the reference's 1e-7 runs: ``host`` (the script's
``refine_mode``, the default), ``device`` or ``none``. ``--as-recorded``
runs the configuration the JAX package's record of the family holds
(``record_config``: the PB_146 record's FGMRES restart is 8, the script's
now 6). ``--checkpoint`` names the driver's setup cache directory (the
script's is a path of its own machine; the default is none). It runs on
the card unless ``--device`` names another device. It prints the record
as one JSON line and writes it to ``--out`` when given; it writes nothing
else (the JAX package's records in ``artifacts/`` are that package's).

``build_setup`` builds the mesh, partition and Domain once, so that
several ``run`` calls can share them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..runtime.config import Config
from ..runtime.driver import Problem, build_problem, simulate

__all__ = ["FAMILIES", "build_setup", "config", "main", "record_config",
           "record_path", "run"]

FAMILIES = {
    146: dict(shape=(32, 32, 32), solid_fraction=0.2, mesh_seed=5),
    1568: dict(shape=(48, 48, 48), solid_fraction=0.15, mesh_seed=5),
}
ORDER = 7
POLY_REDUCTION = 6
REFINE_TOLERANCE = 1e-7          # the reference's criterion, domain.hpp:118
REFINE_MODES = ("host", "device", "none")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _family(k: int) -> dict:
    if k not in FAMILIES:
        raise ValueError(f"pebble family {k!r}: one of {sorted(FAMILIES)}")
    return FAMILIES[k]


def _refined(cfg: Config, refine_mode: str) -> Config:
    if refine_mode not in REFINE_MODES:
        raise ValueError(f"refine_mode {refine_mode!r}: one of "
                         f"{REFINE_MODES}")
    if refine_mode == "none":
        return cfg.replace(refine_tolerance=None, refine_mode="device")
    return cfg.replace(refine_tolerance=REFINE_TOLERANCE,
                       refine_mode=refine_mode)


def config(k: int = 146, refine_mode: str = "host",
           checkpoint: str | None = None) -> Config:
    """The script's run as the driver's configuration: f32 FGMRES(6) with
    a bf16 Z basis to 1e-4 of r0 in at most 200 iterations, the bf16
    composite r = 6 with inner "amg" and 4 inner steps, u* the
    manufactured solution 4 of seed 0, refined in f64 to 1e-7."""
    fam = _family(k)
    cfg = Config(
        poly_degree=ORDER, poly_reduction=POLY_REDUCTION,
        subdomain_overlap=1, superdomain_overlap=1,
        mesh="pebble", shape=fam["shape"], num_pebbles=k,
        solid_fraction=fam["solid_fraction"], mesh_seed=fam["mesh_seed"],
        solver="fgmres", stype="float32", ptype="bfloat16",
        num_vectors=6, ztype="bfloat16",
        inner="amg", inner_iterations=4, max_iterations=200,
        checkpoint=checkpoint)
    return _refined(cfg, refine_mode)


_script_config = config


def record_path(k: int) -> str:
    """The JAX package's record of the family (read only)."""
    _family(k)
    return os.path.join(_ROOT, "artifacts", f"pebble_production_pb{k}.json")


def record_config(k: int, checkpoint: str | None = None) -> Config:
    """The configuration the family's record holds (its ``config``), with
    the record's checkpoint directory replaced by ``checkpoint``."""
    with open(record_path(k)) as fh:
        rec = json.load(fh)
    return Config.from_json(rec["config"]).replace(checkpoint=checkpoint)


def build_setup(k: int = 146, device=None, mesh_builder=None) -> Problem:
    """The family's mesh stage: ``pebble_mesh(shape, 7, ...)``,
    ``partition_mesh(mesh, 1)`` and an f32 Domain on ``device`` (None:
    the card). ``mesh_builder`` (order -> GlobalMesh) stands in for the
    pebble generator."""
    return build_problem(config(k), device, mesh_builder)


def run(k: int = 146, *, config: Config | None = None, device=None,
        setup: Problem | None = None, after_solve=None) -> dict:
    """The script's run of family ``k``; returns its record with the
    port's additions.

    config: the configuration to run (None: the script's, ``config(k)``);
      it must be family ``k``'s mesh.
    setup: a ``build_setup(k, device)`` to reuse; built here when None.
    after_solve: the driver's hook, ``after_solve(domain, solve, f,
      precond)`` after the timed solves (e.g. to profile one more solve).
    The driver's text goes to standard error.
    """
    fam = _family(k)
    cfg = _script_config(k) if config is None else config
    if (cfg.mesh, cfg.num_pebbles, tuple(cfg.shape), cfg.solid_fraction,
            cfg.mesh_seed) != ("pebble", k, fam["shape"],
                               fam["solid_fraction"], fam["mesh_seed"]):
        raise ValueError(f"the configuration is not PB_{k}'s mesh: "
                         f"{cfg.to_json()}")
    t0 = time.time()
    res = simulate(cfg, out=sys.stderr, device=device, problem=setup,
                   after_solve=after_solve)
    rec = dict(res.record)
    rec["wall_seconds"] = time.time() - t0
    rec["family"] = f"PB_{k}"
    # the port's additions
    stages, rr = dict(res.stages), res.refinement
    dom, mesh = res.problem.dom, res.problem.mesh
    rec.update(
        device=(torch.cuda.get_device_name(dom.device)
                if dom.device.type == "cuda" else str(dom.device)),
        elements=mesh.num_elements, points=mesh.num_points,
        refine_mode=cfg.refine_mode if cfg.refine_tolerance else "none",
        stage_seconds=stages.pop("seconds"), memory=stages,
        composite_setup_seconds=getattr(res.precond, "extra", {}).get(
            "setup_seconds"))
    if rr is not None:
        rec.update(refined_inner_iterations=rr.inner_iterations,
                   refined_history=list(rr.history))
    return rec


def main(argv=None, mesh_builder=None) -> int:
    """The command line; ``mesh_builder`` (order -> GlobalMesh) stands in
    for the pebble generator."""
    p = argparse.ArgumentParser(
        prog="python -m polynomial_reduction_with_full_domain_decomposition_"
             "preconditioner_torch.studies.pebble_production",
        description="The reference's pebble-bed family on one device.")
    p.add_argument("family", type=int, nargs="?", default=146,
                   choices=sorted(FAMILIES))
    p.add_argument("--refine", choices=REFINE_MODES, default=None,
                   help="where the f64 refinement runs (default: host, or "
                        "the record's with --as-recorded)")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--as-recorded", action="store_true",
                   help="run the configuration of the JAX package's record")
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    if a.as_recorded:
        cfg = record_config(a.family, checkpoint=a.checkpoint)
        if a.refine is not None:
            cfg = _refined(cfg, a.refine)
    else:
        cfg = config(a.family, a.refine or "host", a.checkpoint)
    setup = (None if mesh_builder is None else
             build_problem(cfg, a.device, mesh_builder))
    rec = run(a.family, config=cfg, device=a.device, setup=setup)
    line = json.dumps(rec)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0 if rec["converged"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
