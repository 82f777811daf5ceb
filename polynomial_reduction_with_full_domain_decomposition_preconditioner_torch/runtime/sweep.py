"""Experiment sweep runner.

Port of the JAX package's ``runtime/sweep.py`` (the reference's run.py):
sweeps preconditioner type, precision, V-cycles, Chebyshev order or
reduction over the benchmark meshes, every point one Config. A point
whose result file exists is skipped, so a sweep resumes where it
stopped.
"""

from __future__ import annotations

import itertools
import json
import os

from .config import Config
from .driver import run_simulation

__all__ = ["sweep", "kershaw_sweep"]


def sweep(base: Config, grid: dict, outdir: str, quiet: bool = True,
          device=None):
    """Run the cartesian product of ``grid`` overrides on ``base`` on
    ``device`` (None: the card).

    Each point writes <outdir>/<name>.json with the structured result
    record; existing files are loaded instead of run again. Returns the
    list of result dicts.
    """
    os.makedirs(outdir, exist_ok=True)
    keys = sorted(grid)
    results = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        cfg = base.replace(**overrides)
        name = "_".join(f"{k}-{overrides[k]}" for k in keys)
        path = os.path.join(outdir, f"{name}.json")
        if os.path.exists(path):
            with open(path) as fh:
                results.append(json.load(fh))
            continue
        if quiet:
            with open(os.devnull, "w") as out:
                rec = run_simulation(cfg, out=out, device=device)
        else:
            rec = run_simulation(cfg, device=device)
        rec["name"] = name
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1)
        results.append(rec)
    return results


def kershaw_sweep(outdir: str, shape=(8, 8, 8), poly_degree=7,
                  num_shards=1, device=None) -> list:
    """The reference's Kershaw experiment family: epsilon in {1.0, 0.3},
    the default production solver configuration."""
    base = Config(mesh="kershaw", shape=shape, poly_degree=poly_degree,
                  poly_reduction=poly_degree - 1, num_shards=num_shards)
    return sweep(base, {"epsilon": [1.0, 0.3]}, outdir, device=device)
