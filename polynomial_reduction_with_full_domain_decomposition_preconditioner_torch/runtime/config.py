"""Unified runtime configuration.

Port of the JAX package's ``runtime/config.py``: one dataclass that the
driver, the sweep runner and the tests share, with the same fields,
defaults, JSON record and command line. The reference scatters its
configuration over compile-time macros, header constants patched per
experiment and CLI arguments; this module holds all of them.

The device is not a field: it is a keyword of ``run_simulation`` and
``sweep`` and the CLI's ``--device`` option (``__main__.py``), so the
JSON record is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

__all__ = ["Config"]


def _torch_dtype(name: str):
    import torch
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}[name]


@dataclass
class Config:
    # ---- problem (the reference CLI) ----
    mesh: str = "kershaw"              # kershaw | box | pebble | nek
    nek_dir: str | None = None         # mesh="nek": directory of Nek5000
    #   per-rank exports (lx1_<n>/*.dat; mesh/nek.py reads it)
    shape: tuple = (8, 8, 8)           # element grid (mx, my[, mz])
    epsilon: float = 0.3               # Kershaw distortion
    num_pebbles: int = 16              # pebble mesh: sphere count; shape
    #   is the carving lattice, mesh_seed the packing seed
    solid_fraction: float = 0.25       # pebble mesh: target sphere volume
    mesh_seed: int = 0                 # pebble packing seed
    scramble: int | None = None        # unstructured connectivity: random
    #   element permutation + local-frame rotations with this seed;
    #   engages the generic-partition composite path
    poly_degree: int = 7               # N
    poly_reduction: int = 6            # reduction
    subdomain_overlap: int = 1
    superdomain_overlap: int = 1       # fine-overlap width (in merged-
    #   layer units) around the compressed far field; active whenever
    #   far_coarsen > 1 (solvers/subdomain.py)

    # ---- precision ----
    stype: str = "float32"             # outer solver dtype
    ptype: str = "float32"             # preconditioner dtype

    # ---- outer solver ----
    solver: str = "fgmres"             # fgmres | fcg
    num_vectors: int = 20              # GMRES restart length
    ztype: str | None = None           # FGMRES Z-basis storage dtype
    #   ("bfloat16" halves the flexible-basis memory; None = store Z in
    #   stype)
    max_iterations: int = 500
    tolerance: float | None = None     # None -> 1e-7 f64 / 1e-4 f32
    refine_tolerance: float | None = None  # f64 iterative-refinement
    #   target: wraps the stype solver in float64 refinement cycles
    #   (solvers/refine.py)
    refine_mode: str = "device"        # device | host — where the f64
    #   residual side runs. "host" keeps all f64 arrays on the host
    #   (solvers/host_oracle.py), for sizes where f64 geometry does not
    #   fit in device memory next to the resident f32 solver.

    # ---- preconditioner ----
    preconditioner: str = "composite"  # composite | pmultigrid | jacobi |
    #   none
    inner_iterations: int = 4          # fixed inner Krylov steps
    inner: str = "amg"                 # composite inner: amg|fem-amg|
    #   jacobi|none
    inner_solver: str = "fgmres"       # fgmres | fcg — the composite
    #   solve's Krylov method
    num_vcycles: int = 1
    cheby_order: int = 2
    max_coarse: int = 600              # dense coarse-solve threshold
    far_coarsen: str | int = "auto"    # far-field z-merge factor

    # ---- execution ----
    num_shards: int = 1
    manufactured_solution: int = 4     # ids 0-4
    seed: int = 0
    output: str | None = None          # npz/vtk field dump path
    output_composite: str | None = None  # composite-region field dump
    #   (ROADMAP item 15b: refused by the driver)
    phase_report: bool = False         # the differential phase table
    #   (ROADMAP item 15b: refused by the driver)
    inner_history: bool = False        # print one preconditioner
    #   application's inner FGMRES residuals
    checkpoint: str | None = None      # directory for setup checkpoints
    #   (meshes + the vertex chain or the unstructured setup); a second
    #   run with the same config skips the host setup

    def stype_dtype(self):
        return _torch_dtype(self.stype)

    def ptype_dtype(self):
        return _torch_dtype(self.ptype)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        d["shape"] = tuple(d["shape"])
        return cls(**d)

    @classmethod
    def from_args(cls, argv) -> "Config":
        """Parse CLI arguments (a superset of the reference's positional
        '<dir> <N> <reduction> <sub_overlap> <sup_overlap>')."""
        import argparse

        p = argparse.ArgumentParser(
            prog="polynomial_reduction_with_full_domain_decomposition_"
                 "preconditioner_torch",
            description="SEM Poisson solver with the full-domain-"
                        "decomposition + polynomial-reduction preconditioner "
                        "(PyTorch/CUDA)")
        d = cls()
        p.add_argument("poly_degree", type=int, nargs="?",
                       default=d.poly_degree)
        p.add_argument("poly_reduction", type=int, nargs="?",
                       default=d.poly_reduction)
        p.add_argument("subdomain_overlap", type=int, nargs="?",
                       default=d.subdomain_overlap)
        p.add_argument("superdomain_overlap", type=int, nargs="?",
                       default=d.superdomain_overlap)
        p.add_argument("--mesh", default=d.mesh,
                       choices=["kershaw", "box", "pebble", "nek"])
        p.add_argument("--nek-dir", default=None,
                       help="mesh=nek: Nek5000 export directory "
                            "(lx1_<n>/*.dat per-rank dumps)")
        p.add_argument("--shape", default=",".join(map(str, d.shape)))
        p.add_argument("--epsilon", type=float, default=d.epsilon)
        p.add_argument("--num-pebbles", type=int, default=d.num_pebbles)
        p.add_argument("--solid-fraction", type=float,
                       default=d.solid_fraction)
        p.add_argument("--mesh-seed", type=int, default=d.mesh_seed)
        p.add_argument("--scramble", type=int, default=None,
                       help="unstructured connectivity: scramble seed")
        p.add_argument("--stype", default=d.stype)
        p.add_argument("--ptype", default=d.ptype)
        p.add_argument("--solver", default=d.solver,
                       choices=["fgmres", "fcg"])
        p.add_argument("--num-vectors", type=int, default=d.num_vectors)
        p.add_argument("--ztype", default=d.ztype,
                       choices=["bfloat16", "float32"],
                       help="FGMRES Z-basis storage dtype (bfloat16 "
                            "halves the flexible-basis memory)")
        p.add_argument("--max-iterations", type=int, default=d.max_iterations)
        p.add_argument("--tolerance", type=float, default=None)
        p.add_argument("--refine-tolerance", type=float, default=None,
                       help="f64 iterative-refinement target (e.g. 1e-7)")
        p.add_argument("--refine-mode", default=d.refine_mode,
                       choices=["device", "host"],
                       help="f64 residual side: device Domain or the "
                            "host oracle (for memory-limited sizes)")
        p.add_argument("--preconditioner", default=d.preconditioner,
                       choices=["composite", "pmultigrid", "jacobi", "none"])
        p.add_argument("--inner", default=d.inner,
                       choices=["amg", "fem-amg", "jacobi", "none"])
        p.add_argument("--inner-iterations", type=int,
                       default=d.inner_iterations)
        p.add_argument("--inner-solver", default=d.inner_solver,
                       choices=["fgmres", "fcg"],
                       help="composite-solve Krylov method")
        p.add_argument("--num-vcycles", type=int, default=d.num_vcycles)
        p.add_argument("--cheby-order", type=int, default=d.cheby_order)
        p.add_argument("--max-coarse", type=int, default=d.max_coarse)
        p.add_argument("--far-coarsen", default="auto",
                       help="far-field z-merge factor (int) or 'auto'")
        p.add_argument("--num-shards", type=int, default=d.num_shards)
        p.add_argument("--solution-id", type=int,
                       default=d.manufactured_solution)
        p.add_argument("--seed", type=int, default=d.seed)
        p.add_argument("--output", default=None)
        p.add_argument("--output-composite", default=None,
                       help="composite-region field dump path (npz)")
        p.add_argument("--phase-report", action="store_true")
        p.add_argument("--inner-history", action="store_true")
        p.add_argument("--checkpoint", default=None,
                       help="directory for setup checkpoints (mesh + "
                            "preconditioner hierarchy)")
        a = p.parse_args(argv)
        return cls(
            mesh=a.mesh, nek_dir=a.nek_dir,
            shape=tuple(int(x) for x in a.shape.split(",")),
            epsilon=a.epsilon, scramble=a.scramble,
            num_pebbles=a.num_pebbles, solid_fraction=a.solid_fraction,
            mesh_seed=a.mesh_seed,
            poly_degree=a.poly_degree,
            poly_reduction=a.poly_reduction,
            subdomain_overlap=a.subdomain_overlap,
            superdomain_overlap=a.superdomain_overlap,
            stype=a.stype, ptype=a.ptype, solver=a.solver, ztype=a.ztype,
            num_vectors=a.num_vectors, max_iterations=a.max_iterations,
            tolerance=a.tolerance, refine_tolerance=a.refine_tolerance,
            refine_mode=a.refine_mode,
            preconditioner=a.preconditioner,
            inner=a.inner, inner_iterations=a.inner_iterations,
            inner_solver=a.inner_solver,
            num_vcycles=a.num_vcycles, cheby_order=a.cheby_order,
            max_coarse=a.max_coarse,
            far_coarsen=(a.far_coarsen if a.far_coarsen == "auto"
                         else int(a.far_coarsen)),
            num_shards=a.num_shards, manufactured_solution=a.solution_id,
            seed=a.seed, output=a.output,
            output_composite=a.output_composite,
            phase_report=a.phase_report,
            inner_history=a.inner_history, checkpoint=a.checkpoint)
