"""CLI entry point (the reference's ./poisson binary).

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch \\
        7 6 1 1 --mesh kershaw --shape 16,16,16 --epsilon 0.3 [--device cpu]

The arguments are the JAX package's CLI (``runtime/config.Config.
from_args``) plus ``--device``: the torch device to run on, the CUDA card
when it is not given (raising where there is none). Across processes
(``runtime/distributed.initialize_multihost``: PRFDD_COORDINATOR,
PRFDD_NUM_PROCESSES, PRFDD_PROCESS_ID, PRFDD_BACKEND) every process runs
this command with the same arguments. Exit code 0 when the solve
converged, 1 otherwise.

For scripts that drive the CLI: with PRFDD_RECORD set, each process
writes the run's record (what ``run_simulation`` returns), its kernel
launches (``ops/kernels.counts`` and the launch signatures) and the
seconds and peak memory of each stage (``runtime/driver.Outcome.stages``)
as JSON to ``$PRFDD_RECORD.rank<r>.json``.
"""

import json
import os
import sys

from .runtime.config import Config
from .runtime.distributed import initialize_multihost, process_index
from .runtime.driver import simulate


def take_device(argv):
    """(device or None, argv without ``--device DEV`` / ``--device=DEV``)."""
    device, rest, it = None, [], iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def main(argv=None):
    # join the process group (a no-op without PRFDD_COORDINATOR) before
    # anything else, as the reference calls MPI_Init first
    initialize_multihost()
    device, rest = take_device(sys.argv[1:] if argv is None else argv)
    cfg = Config.from_args(rest)
    outcome = simulate(cfg, device=device)
    result = outcome.record
    path = os.environ.get("PRFDD_RECORD")
    if path:
        from .ops import kernels
        with open(f"{path}.rank{process_index()}.json", "w") as fh:
            json.dump({"record": result, "counts": kernels.counts(),
                       "signatures": kernels.take_signatures(),
                       "stages": outcome.stages}, fh)
    return 0 if result["converged"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
