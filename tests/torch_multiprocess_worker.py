"""Per-process worker of the port's multi-process CPU checks
(tests/test_torch_multiprocess.py, tests/test_torch_host_oracle.py).

    python tests/torch_multiprocess_worker.py RANK PROCESSES COORDINATOR OUT CHECK...

Joins a gloo group, runs each named check on this process's shards
against ``LocalComm`` on the whole stack (which every process can build
from the same seed) and writes [[check, ok, detail], ...] to
OUT.rank{RANK}.json. Checks: "collectives" (ProcessComm's ppermute,
cyclic_shift, all_gather, slab_exchange_add uniform and ragged, psum and
allreduce), "split" (the boundary-first op_dssum against operator then
dssum, and against one process's Domain, 3-D and 2-D), "host_oracle" (owned_to_global
and global_to_owned across the processes against the one-process maps),
"timer" (a Timer region that sleeps 50 ms on rank 0 and 100 ms on rank 1,
the per-process totals gathered and the 4-shard report; its detail is
{"vec", "report"}).
"""

import json
import sys

import numpy as np
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh import generator as tg
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.mesh.partition import partition_mesh
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.comm import LocalComm, ProcessComm, chain_pairs
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.distributed import initialize_multihost, owned_shards
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.domain import Domain
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.solvers.host_oracle import global_to_owned, owned_to_global


def check_collectives(out):
    for P in (4, 2):
        pc, lc = ProcessComm(P), LocalComm(P)
        own = slice(pc.first, pc.first + pc.local_shards)
        rng = np.random.default_rng(P)
        full = torch.as_tensor(rng.standard_normal((P, 6, 3, 5)))
        mine = full[own].clone()
        up, down = chain_pairs(P)
        for name, got, want in (
                ("ppermute up", pc.ppermute(mine, up), lc.ppermute(full, up)),
                ("ppermute down", pc.ppermute(mine, down),
                 lc.ppermute(full, down))):
            out.append([f"P{P} {name}", torch.equal(got, want[own]), ""])
        for k in (1, -1, 2):
            out.append([f"P{P} cyclic_shift {k}",
                        torch.equal(pc.cyclic_shift(mine, k),
                                    lc.cyclic_shift(full, k)[own]), ""])
        out.append([f"P{P} all_gather",
                    torch.equal(pc.all_gather(mine), lc.all_gather(full)), ""])
        got = pc.slab_exchange_add(mine.clone())
        want = lc.slab_exchange_add(full.clone())
        out.append([f"P{P} slab_exchange_add", torch.equal(got, want[own]),
                    ""])
        # ragged: each shard's real top plane, one shard with none (it
        # reads its last plane)
        top = torch.tensor([5, 3, 1, 5][:P], dtype=torch.int64)
        if P == 2:
            top = torch.tensor([3, 5], dtype=torch.int64)
        got = pc.slab_exchange_add(mine.clone(), top[own])
        want = lc.slab_exchange_add(full.clone(), top)
        out.append([f"P{P} slab_exchange_add ragged",
                    torch.equal(got, want[own]), ""])
        # sums: another order than the one process's, so within an ulp of
        # the magnitudes summed
        s_got, s_want = pc.psum(mine), lc.psum(full)
        bound = 2 * torch.finfo(torch.float64).eps * full.abs().sum(0)
        out.append([f"P{P} psum", bool(((s_got - s_want).abs() <= bound)
                                       .all()), ""])
        d_got = pc.allreduce((mine * mine).sum(), mine.sum())
        d_want = ((full * full).sum(), full.sum())
        ok = all(abs(float(a - b)) <= 2 * 2.2e-16 * float(w)
                 for a, b, w in zip(d_got, d_want, ((full * full).sum(),
                                                    full.abs().sum())))
        out.append([f"P{P} allreduce", ok,
                    [float(a - b) for a, b in zip(d_got, d_want)]])


def _domains(shape, P, dtype):
    mesh = tg.kershaw_mesh(shape, 3, epsilon=0.3, device="cpu")
    dp = Domain(partition_mesh(mesh, P, owned=owned_shards(P)), dtype=dtype,
                device="cpu", comm=ProcessComm(P))
    dl = Domain(partition_mesh(mesh, P), dtype=dtype, device="cpu")
    return dp, dl


def check_split(out):
    # uniform slabs of 3 layers, and ragged ones of 4, 4, 3, 3; in 3-D and
    # in 2-D (the slabs are element rows)
    for shape in ((2, 2, 12), (2, 2, 14), (2, 12), (2, 14)):
        for dtype in (torch.float64, torch.float32):
            dp, dl = _domains(shape, 4, dtype)
            own = slice(dp.comm.first, dp.comm.first + dp.num_owned)
            z_full = dl.initial_function(4, seed=7)
            z = z_full[own].contiguous()
            op, ds, _, _ = dp._ops()
            fused = op.fused_dssum
            if fused is None:
                out.append([f"split {shape} {dtype}", False, "no split"])
                continue
            q, U = fused(z)
            q2 = op(z)
            U2 = ds(q2, apply_mask=True, apply_weight=False)
            opl, dsl, _, _ = dl._ops()
            ql = opl(z_full)
            Ul = dsl(ql, apply_mask=True, apply_weight=False)
            ok = (torch.equal(q, q2) and torch.equal(U, U2)
                  and torch.equal(U, Ul[own]) and torch.equal(q, ql[own]))
            out.append([f"split {shape} {dtype}", ok,
                        float((U - Ul[own]).abs().max())])


def check_host_oracle(out):
    for shape, P, structured in (((2, 2, 8), 4, True), ((2, 2, 7), 2, True),
                                 ((2, 2, 8), 4, False), ((3, 8), 4, True),
                                 ((3, 8), 4, False)):
        mesh = tg.kershaw_mesh(shape, 3, epsilon=0.3, device="cpu")
        sdp = partition_mesh(mesh, P, structured=structured,
                             owned=owned_shards(P))
        dp = Domain(sdp, dtype=torch.float64, device="cpu",
                    comm=ProcessComm(P))
        dl = Domain(partition_mesh(mesh, P, structured=structured),
                    dtype=torch.float64, device="cpu")
        ul = dl.initial_function(4, seed=3)
        own = slice(dp.comm.first, dp.comm.first + dp.num_owned)
        want = owned_to_global(dl, dl.from_device_field(ul))
        got = owned_to_global(dp, dp.from_device_field(ul[own]))
        back = global_to_owned(dp, got)
        ok = (np.array_equal(got, want)
              and np.array_equal(back, global_to_owned(dl, want)[own]))
        out.append([f"host_oracle {shape} P{P} structured={structured}", ok,
                    float(np.abs(got - want).max())])


def check_timer(out, rank):
    import time
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.timer import Timer
    tmr = Timer(sync=False)
    tmr.start("probe")
    time.sleep(0.05 * (rank + 1))
    tmr.stop("probe")
    names, mat = tmr.gather_process_totals()
    out.append(["timer", list(names) == ["probe"],
                {"vec": mat[:, names.index("probe")].tolist(),
                 "report": tmr.report(num_shards=4)}])


def main():
    rank, nproc, coordinator, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                          sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    initialize_multihost(coordinator, nproc, rank, "gloo",
                         timeout_seconds=120)
    checks = {"collectives": check_collectives, "split": check_split,
              "host_oracle": check_host_oracle,
              "timer": lambda out: check_timer(out, rank)}
    out = []
    for name in sys.argv[5:]:
        checks[name](out)
    with open(f"{out_path}.rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
