"""The SpMV kernel's lanes a row swept on the fem-amg hierarchy of the
`femamg` path (Kershaw eps=0.3, 16^3 elements, N=7, composite r=6, f32):
each sparse operator (A0, A1, Q, Qt, P0, R0) run with every lane count
1, 2, ..., 32 forced, each result held bitwise to the plain twin at that
count, timed warm (``utils/timing.cuda_ms``) beside ``torch.mv`` on a
``sparse_csr`` tensor of the same arrays (cuSPARSE) and marked with the
count the packing rule (``ops/kernels.spmv_lanes``) chose. Prints one
JSON line a matrix, the card's name and power limit on the first.

    python -m polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.studies.spmv_lanes [SHAPE] [ORDER]

(SHAPE an element count a side, default 16; ORDER default 7.) It needs a
card.
"""

from __future__ import annotations

import json
import sys
import warnings
from functools import partial

import torch

from ..mesh.generator import kershaw_mesh
from ..mesh.partition import partition_mesh
from ..ops import kernels
from ..ops.csr import CsrMatrix, sparse_spmv
from ..solvers.domain import Domain
from ..solvers.subdomain import composite_dd
from ..utils.timing import card, cuda_ms

LANES = (1, 2, 4, 8, 16, 32)


def run(side: int = 16, order: int = 7):
    """Yield one record a matrix: rows, entries, the chosen lanes, the
    library's ms and {lanes: (ms, bitwise equal to the twin)}."""
    if not torch.cuda.is_available():
        raise RuntimeError("spmv_lanes times a kernel: it needs a card")
    dev = torch.device("cuda")
    mk = partial(kershaw_mesh, (side,) * 3, epsilon=0.3, device=dev)
    mesh = mk(order)
    dom = Domain(partition_mesh(mesh, 1), dtype=torch.float32, device=dev)
    tree = composite_dd(dom, mk, poly_reduction=6, inner="fem-amg",
                        ptype=torch.float32, fine_mesh=mesh).extra["amg"]
    mats = {"A0": tree["levels"][0]["A"], "A1": tree["levels"][1]["A"],
            "Q": tree["Q"], "Qt": tree["Qt"], "P0": tree["prolongs"][0],
            "R0": tree["restricts"][0]}
    for label, m in mats.items():
        x = torch.linspace(-1.0, 1.0, m.shape[1], device=dev)
        with warnings.catch_warnings():
            # torch flags its sparse CSR layout as beta on construction
            warnings.simplefilter("ignore", UserWarning)
            S = torch.sparse_csr_tensor(m.crow, m.cols, m.vals, size=m.shape)
        rec = {"matrix": label, "rows": m.shape[0], "nnz": m.nnz,
               "chosen_lanes": m.lanes,
               "library_ms": cuda_ms(lambda: torch.mv(S, x), 20), "ms": {}}
        for lanes in LANES:
            forced = CsrMatrix(crow=m.crow, cols=m.cols, vals=m.vals,
                               shape=m.shape, route=m.route, lanes=lanes)
            same = torch.equal(sparse_spmv(forced, x),
                               kernels.csr_spmv_plain(forced, x))
            rec["ms"][lanes] = [cuda_ms(lambda: sparse_spmv(forced, x), 20),
                                bool(same)]
        yield rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    side = int(argv[0]) if argv else 16
    order = int(argv[1]) if len(argv) > 1 else 7
    name = card()
    ok = True
    for k, rec in enumerate(run(side, order)):
        if k == 0:
            rec["card"] = name
        print(json.dumps(rec), flush=True)
        ok = ok and all(same for _, same in rec["ms"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
