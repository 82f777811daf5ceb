"""The reference's region profiles beyond the one-shard main path: the
multi-group composite over P = 8 slab shards at Kershaw 32^3, the
scrambled (unstructured) 16^3 mesh, and the 64^3 headline mesh. Port of
the JAX package's ``artifacts/phase_p8_32cubed.py``,
``artifacts/phase_unstructured.py`` and ``artifacts/phase_64cubed.py``.

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.phase_profiles \\
        p8 [m] [P] [chain_iters] | unstructured | cube [m] \\
        [--device DEV] [--out PATH] [--checkpoint DIR]

Each profile times the region chains of ``Domain.phase_chain`` (the
reference's timed regions, difference-timed by
``runtime/phases._chain_time``) on the script's configuration, with the
script's kinds, chain length and repeats:

- ``p8``: Kershaw eps=0.3 m^3 N=7 (m 32) over P slab shards (P 8), an f32
  Domain and the bf16 composite r = 6, inner "amg", 4 inner steps; 15
  kinds, chains of ``chain_iters`` (4), best of 2; its 17 regions
  clipped at 0. Record: mesh, shards, backend, chain_iters, raw_ms,
  regions_ms.
- ``unstructured``: the 16^3 mesh scrambled with seed 7 on one generic
  shard, f32 Domain and composite (r = 6, inner "amg", 4 inner steps);
  9 kinds, chains of 12, best of 3; its 9 regions not clipped (the
  JAX package's record reads one negative). Record: chains_ms,
  regions_ms.
- ``cube``: Kershaw eps=0.3 m^3 N=7 (m 64), one shard, f32 Domain, bf16
  composite as ``p8``'s; 12 kinds, chains of 8, best of 3. Record: kind
  -> seconds an application.

Every record also carries the device's name (``backend``), the card's
name and power limit as ``nvidia-smi`` prints them (``card``), and the
seconds and the card's and the host's peak memory of each setup stage
(``stages``, ``utils/memory.StageLog``). ``--checkpoint`` names a
directory for the mesh cache (and, for ``p8`` and ``cube``, the vertex
chain's), as the scripts keep theirs; without it nothing is cached. It
runs on the card unless ``--device`` names another device, prints the
record as one JSON line and writes it to ``--out`` when given (the JAX
package's records in ``artifacts/`` are that package's).

``run(..., setup=Setup(...))`` starts from a mesh, a Domain, a
composite or a right-hand side already built (e.g. the scale-up phases'
meshes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from functools import partial

import torch

from .. import resolve_device
from ..utils.memory import StageLog
from ..utils.timing import card

__all__ = ["KINDS", "PROFILES", "Setup", "build_setup", "main",
           "p8_regions", "run", "unstructured_regions"]

PROFILES = ("p8", "unstructured", "cube")
ORDER = 7
POLY_REDUCTION = 6
INNER_ITERATIONS = 4
EPSILON = 0.3
SCRAMBLE_SEED = 7          # phase_unstructured.py's mesh
KINDS = {
    "p8": ("nrm", "op", "dssum", "cnrm", "comp_op", "comp_dssum",
           "inner_precond", "tree_cascade", "tree_rhs",
           "inner_smooth", "inner_transfer", "inner_coarse",
           "tree_rings", "tree_coarse", "comp_assemble"),
    "unstructured": ("nrm", "op", "dssum", "cnrm", "comp_op", "comp_dssum",
                     "inner_precond", "tree_cascade", "tree_rhs"),
    "cube": ("nrm", "op", "dssum", "cnrm", "comp_op", "comp_dssum",
             "inner_precond", "tree_cascade", "tree_rhs",
             "tree_rings", "tree_coarse", "comp_assemble"),
}
# each script's defaults: elements a side, shards, chain length, repeats,
# the composite's precision
DEFAULTS = {
    "p8": dict(m=32, shards=8, chain_iters=4, repeats=2, ptype="bfloat16"),
    "unstructured": dict(m=16, shards=1, chain_iters=12, repeats=3,
                         ptype="float32"),
    "cube": dict(m=64, shards=1, chain_iters=8, repeats=3,
                 ptype="bfloat16"),
}


def p8_regions(ct: dict) -> dict:
    """phase_p8_32cubed.py's 17 regions from its chains (any one unit),
    each clipped at 0 as the script clips them."""
    regions = {
        "domain.operator_application": ct["op"] - ct["dssum"],
        "domain.inner_products+vector_operations": ct["nrm"],
        "subdomain.stitching (outer dssum)": ct["dssum"] - ct["nrm"],
        "subdomain.tree_construction (restriction cascade)":
            ct["tree_cascade"],
        "subdomain.tree_exchange (rings ppermute + coarse all_gather + "
        "far)": ct["tree_rhs"] - ct["tree_cascade"],
        "subdomain.operator_application (per inner app)":
            ct["comp_op"] - ct["cnrm"],
        "subdomain.preconditioner.assemble+unassemble":
            ct["comp_dssum"] - ct["cnrm"],
        "subdomain.preconditioner.vcycle (total)":
            ct["inner_precond"] - ct["cnrm"],
        "subdomain.preconditioner.smooth_leg (1 Chebyshev)":
            ct["inner_smooth"] - ct["cnrm"],
        "subdomain.preconditioner.transfer_legs (R+P)":
            ct["inner_transfer"] - ct["cnrm"],
        "subdomain.preconditioner.coarse_grid_solver":
            ct["inner_coarse"] - ct["inner_transfer"],
        "subdomain.inner_products+vector_operations": ct["cnrm"],
        "subdomain.tree_exchange.rings (ppermute legs)":
            ct["tree_rings"] - ct["tree_cascade"],
        "subdomain.tree_exchange.coarse (all_gather)":
            ct["tree_coarse"] - ct["tree_cascade"],
        "subdomain.tree_exchange.superdomain (far restrict)":
            (ct["tree_rhs"] - ct["tree_rings"]
             - ct["tree_coarse"] + ct["tree_cascade"]),
        "subdomain.preconditioner.assemble (gather half)":
            ct["comp_assemble"] - ct["cnrm"],
        "subdomain.preconditioner.unassemble (scatter+stitch half)":
            ct["comp_dssum"] - ct["comp_assemble"],
    }
    return {k: max(v, 0.0) for k, v in regions.items()}


def unstructured_regions(ct: dict, ki: int = INNER_ITERATIONS) -> dict:
    """phase_unstructured.py's 9 regions from its chains (any one unit),
    not clipped: a marginal below the timing noise stays negative, as in
    the script."""
    return {
        "domain.operator_application": ct["op"] - ct["dssum"],
        "domain.inner_products+vector_ops": ct["nrm"],
        "subdomain.stitching (outer dssum)": ct["dssum"] - ct["nrm"],
        "subdomain.tree_construction": ct["tree_cascade"],
        "subdomain.tree_exchange": ct["tree_rhs"] - ct["tree_cascade"],
        f"subdomain.operator_application (x{ki})":
            ct["comp_op"] - ct["cnrm"],
        f"subdomain.assembly comp_dssum (x{ki}+)":
            ct["comp_dssum"] - ct["cnrm"],
        f"subdomain.preconditioner vcycle (x{ki})":
            ct["inner_precond"] - ct["cnrm"],
        "subdomain.vector_ops (cnrm)": ct["cnrm"],
    }


@dataclass
class Setup:
    """What a profile runs on. Each field left None is built by
    ``build_setup``: the order-``order`` mesh by ``mesh_builder``, the
    Domain on its partition, the composite on the Domain and f = A u* with
    u* = initial_function(4, seed 0). A given Domain must be the
    profile's partition of the mesh, and a given composite the profile's
    configuration on it."""
    mesh_builder: object = None
    mesh: object = None
    dom: object = None
    precond: object = None
    f: object = None


def _check(profile):
    if profile not in PROFILES:
        raise ValueError(f"profile {profile!r}: one of {PROFILES}")


def _tag(shape, seed) -> str:
    # the scripts' cached_mesh_builder tags (the driver's _setup_tag)
    return f"kershaw_{'x'.join(map(str, shape))}_e{EPSILON}_s{seed}"


def _mesh_builder(profile, shape, device, checkpoint):
    from ..mesh import generator as mg
    builder = partial(mg.kershaw_mesh, shape, epsilon=EPSILON, device=device)
    seed = None
    if profile == "unstructured":
        seed, base = SCRAMBLE_SEED, builder
        builder = lambda o: mg.scramble_mesh(base(o), seed=SCRAMBLE_SEED,
                                             device=device)
    if checkpoint:
        from ..runtime.checkpoint import cached_mesh_builder
        builder = cached_mesh_builder(builder, checkpoint, _tag(shape, seed))
    return builder


def build_setup(profile: str, m: int | None = None,
                shards: int | None = None, *, device=None,
                checkpoint: str | None = None, setup: Setup | None = None,
                shape=None, order: int = ORDER,
                poly_reduction: int = POLY_REDUCTION,
                dtype=torch.float32, ptype=None,
                stages: StageLog | None = None) -> Setup:
    """The profile's mesh, Domain, composite and right-hand side on
    ``device`` (None: the card), each taken from ``setup`` where given.

    shape: the element grid (default (m, m, m)); order, poly_reduction,
      dtype (the Domain's) and ptype (the composite's; default the
      script's) stand in for the script's constants, e.g. for a small
      problem on the CPU.
    stages: a StageLog that marks each stage built here (mesh, partition,
      domain, preconditioner, rhs).
    """
    from ..mesh.partition import partition_mesh
    from ..solvers.domain import Domain
    from ..solvers.subdomain import composite_dd

    _check(profile)
    d = DEFAULTS[profile]
    m = d["m"] if m is None else m
    shards = d["shards"] if shards is None else shards
    shape = (m, m, m) if shape is None else tuple(shape)
    ptype = getattr(torch, d["ptype"]) if ptype is None else ptype
    s = Setup(**vars(setup)) if setup is not None else Setup()
    device = s.dom.device if s.dom is not None else resolve_device(device)
    log = stages.mark if stages is not None else (lambda name: None)
    if s.mesh_builder is None:
        s.mesh_builder = _mesh_builder(profile, shape, device, checkpoint)
    if s.dom is None:
        if s.mesh is None:
            s.mesh = s.mesh_builder(order)
            log("mesh")
        sd = partition_mesh(s.mesh, shards, structured=(
            False if profile == "unstructured" else "auto"))
        log("partition")
        s.dom = Domain(sd, dtype=dtype, device=device)
        log("domain")
    if s.precond is None:
        chain_cache = None
        if checkpoint and profile != "unstructured":
            chain_cache = os.path.join(checkpoint,
                                       f"chain_kershaw_{shape[0]}cubed.npz")
        s.precond = composite_dd(
            s.dom, s.mesh_builder, poly_reduction=poly_reduction,
            inner="amg", ptype=ptype, num_iterations=INNER_ITERATIONS,
            fine_mesh=s.mesh, chain_cache=chain_cache)
        log("preconditioner")
    if s.f is None:
        s.f = s.dom.manufacture_rhs(s.dom.initial_function(4, seed=0))
        log("rhs")
    return s


def run(profile: str, m: int | None = None, shards: int | None = None,
        chain_iters: int | None = None, *, repeats: int | None = None,
        device=None, checkpoint: str | None = None,
        setup: Setup | None = None, out=sys.stderr, **build) -> dict:
    """Run one profile; returns its record with the port's additions.

    m, shards, chain_iters, repeats: the script's arguments and timing
      (None: its defaults).
    setup: what is already built (``Setup``); the rest is built here.
    build: ``build_setup``'s keywords (shape, order, poly_reduction,
      dtype, ptype).
    Progress goes to ``out``.
    """
    from ..runtime.phases import _chain_time

    _check(profile)
    d = DEFAULTS[profile]
    m = d["m"] if m is None else m
    shards = d["shards"] if shards is None else shards
    iters = d["chain_iters"] if chain_iters is None else chain_iters
    repeats = d["repeats"] if repeats is None else repeats
    dev = (resolve_device(device) if setup is None or setup.dom is None
           else setup.dom.device)
    stages = StageLog(dev)
    s = build_setup(profile, m, shards, device=dev, checkpoint=checkpoint,
                    setup=setup, stages=stages, **build)
    print(f"setup {sum(stages.seconds.values()):.1f}s  shards={shards}",
          file=out)
    ct = {}
    for k in KINDS[profile]:
        t0 = time.time()
        ct[k] = _chain_time(s.dom, s.precond, k, s.f, iters=iters,
                            repeats=repeats)
        print(f"  {k}: {ct[k] * 1e3:.3f} ms/app  "
              f"(measured in {time.time() - t0:.1f}s)", file=out)
    stages.mark("chains")
    shape = build.get("shape") or (m, m, m)
    order = build.get("order", ORDER)
    r = build.get("poly_reduction", POLY_REDUCTION)
    dims = f"{shape[0]}^3" if len(set(shape)) == 1 else str(tuple(shape))
    backend = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else str(dev))
    extra = {"card": card(dev), "stages": stages.as_dict()}
    if profile == "p8":
        reg = p8_regions(ct)
        return {"mesh": f"kershaw eps={EPSILON} {dims} N={order} r={r}",
                "shards": shards, "backend": backend, "chain_iters": iters,
                "raw_ms": {k: v * 1e3 for k, v in ct.items()},
                "regions_ms": {k: v * 1e3 for k, v in reg.items()},
                "repeats": repeats, **extra}
    if profile == "unstructured":
        reg = unstructured_regions(ct)
        return {"chains_ms": {k: v * 1e3 for k, v in ct.items()},
                "regions_ms": {k: v * 1e3 for k, v in reg.items()},
                "mesh": f"kershaw eps={EPSILON} {dims} N={order} r={r} "
                        f"scrambled seed {SCRAMBLE_SEED}",
                "backend": backend, "chain_iters": iters,
                "repeats": repeats, **extra}
    return {**ct, "mesh": f"kershaw eps={EPSILON} {dims} N={order} r={r}",
            "backend": backend, "chain_iters": iters, "repeats": repeats,
            **extra}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m polynomial_reduction_with_full_domain_decomposition_"
             "preconditioner_torch.studies.phase_profiles",
        description="The reference's region profiles: p8 [m] [P] "
                    "[chain_iters], unstructured, cube [m].")
    p.add_argument("profile", choices=PROFILES)
    p.add_argument("args", type=int, nargs="*")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--checkpoint", default=None)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    names = {"p8": ("m", "shards", "chain_iters"), "unstructured": (),
             "cube": ("m",)}[a.profile]
    if len(a.args) > len(names):
        p.error(f"{a.profile} takes at most {len(names)} numbers: "
                f"{' '.join(names)}")
    rec = run(a.profile, **dict(zip(names, a.args)), device=a.device,
              checkpoint=a.checkpoint)
    line = json.dumps(rec)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
