"""The port's twin of tests/test_multihost.py: a P = 4 solve over two
processes with gloo on the CPU (runtime/distributed.py, runtime/comm.
ProcessComm), each process materializing only its own two shards, held
to the port's one-process ``LocalComm`` run of the same problem. The
existing f64 twins hold that one-process run to the JAX package, so this
file needs no JAX side.

Kershaw eps=0.3 (2, 2, 8), extent (1, 1, 4), N=3, composite r=2, f64
FGMRES to 1e-8, in four modes run by one launch of the two workers
(runtime/launch.py): structured, structured fem-amg, unstructured
(scrambled, seed 3, element order kept, the per-process setup cache
written and then hit) and unstructured fem-amg; and two 2-D modes on
Kershaw (4, 12), extent (1, 3), N=3: structured (slabs of 3 rows, the
boundary-first split) and unstructured (scrambled, seed 3, element order
kept, its per-process setup cache written and then hit). Counts equal,
histories at rtol 1e-9 / atol 1e-14 (the processes sum the dots in
another order), max error as tests/test_multihost.py bounds it. Then
ProcessComm's collectives against LocalComm's, and the boundary-first
op_dssum against operator then dssum, bitwise, in 3-D and 2-D."""

import json
import os

import numpy as np
import pytest
import torch

from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime import distributed
from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.launch import run_one

import multiprocess_twins as mt

MESH = {"kind": "kershaw", "shape": [2, 2, 8], "order": 3, "epsilon": 0.3,
        "extent": [1.0, 1.0, 4.0]}
MESH_2D = {"kind": "kershaw", "shape": [4, 12], "order": 3, "epsilon": 0.3,
           "extent": [1.0, 3.0]}
MODES = {   # name -> (inner, scrambled, max error, mesh)
    "structured": ("amg", False, 1e-7, MESH),
    "structured-femamg": ("fem-amg", False, 5e-7, MESH),
    "unstructured": ("amg", True, 1e-7, MESH),
    "unstructured-femamg": ("fem-amg", True, 5e-7, MESH),
    "structured-2d": ("amg", False, 1e-7, MESH_2D),
    "unstructured-2d": ("amg", True, 1e-7, MESH_2D),
}


CHAIN_KINDS = ("op", "tree_rhs", "comp_op")


def _run(name, cache_dir=None):
    inner, scrambled, _, mesh = MODES[name]
    run = {"name": name,
           "mesh": dict(mesh, scramble={"seed": 3, "permute": False}
                        if scrambled else None),
           "shards": 4, "dtype": "float64",
           "precond": {"kind": "composite", "poly_reduction": 2,
                       "inner": inner},
           "method": "fgmres", "max_iterations": 100, "tolerance": 1e-8,
           "u_star": {"function_id": 4, "seed": 1}}
    if cache_dir is not None:
        run["setup_cache"] = str(cache_dir)
    if name == "structured":
        # region chains whose scalar is the max over the processes
        run["phase_chains"] = {"kinds": list(CHAIN_KINDS), "iters": 3}
    return run


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """Both workers run the four modes while this process runs the same
    four with every shard in it; returns (rank 0's record, the
    LocalComm records)."""
    tmp = tmp_path_factory.mktemp("mp_solves")
    # the unstructured modes write their per-process setup caches, each
    # into a directory of its own, and rebuild from them
    caches = {n: tmp / n for n in ("unstructured", "unstructured-2d")}
    for d in caches.values():
        d.mkdir()
    runs = [_run(n, caches.get(n)) for n in MODES]
    cfg, out = tmp / "config.json", tmp / "out.json"
    cfg.write_text(json.dumps({"device": "cpu", "threads": 1,
                               "timeout_seconds": 120, "runs": runs}))
    init = mt.store(tmp)
    procs = mt.start(lambda r: ["-m", mt.LAUNCH, str(r), "2", init, "gloo",
                                str(cfg), str(out)], 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        local = {n: run_one(_run(n), torch.device("cpu"), local=True)
                 for n in MODES}
    finally:
        torch.set_num_threads(threads)
    mt.finish(procs, timeout=240)
    rec = json.loads(out.read_text())
    return {r["name"]: r for r in rec["runs"]}, local, {
        n: sorted(p.name for p in d.iterdir()) for n, d in caches.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_two_process_run_matches_local_comm(solves, mode):
    two, local, cached = solves
    rec, ref = two[mode], local[mode]
    assert rec["converged"] and ref["converged"]
    assert rec["iterations"] == ref["iterations"], (rec["iterations"],
                                                    ref["iterations"])
    # every process read the same (all-reduced) history
    assert rec["same_history"]
    np.testing.assert_allclose(rec["history"], ref["history"], rtol=1e-9,
                               atol=1e-14)
    assert rec["err"] < MODES[mode][2]
    procs = rec["processes"]
    assert [p["owned"] for p in procs] == [[0, 1], [2, 3]]
    # gloo on CPU tensors moves them as they are: no staging copies
    assert all(p["comm"]["host_copies"] == 0 for p in procs)
    if mode in cached:
        # each process wrote its own payload and the rebuild loaded it
        assert [p["cache_hit"] for p in procs] == [True, True]
        assert cached[mode] == [f"setup_{mode}_pp0of2_o0-1.npz",
                                f"setup_{mode}_pp1of2_o2-3.npz"]
    if mode == "structured":
        # Domain.phase_chain: each process's scalar is the max over all
        # four shards, the one process's value
        for proc in procs:
            assert set(proc["phase_chains"]) == set(CHAIN_KINDS)
            for kind in CHAIN_KINDS:
                np.testing.assert_allclose(proc["phase_chains"][kind],
                                           ref["phase_chains"][kind],
                                           rtol=1e-12, err_msg=kind)
    if MODES[mode][3] is MESH_2D:
        # a 2-D solve reaches no 3-D kernel (K1, K2, their twins), in any
        # process
        for launches in [p["launches"] for p in procs] + [ref["launches"]]:
            assert not any(v for k, v in launches.items()
                           if "stiffness" in k or "face_sum" in k)
    elif not MODES[mode][1]:
        # the structured modes' outer operator ran the boundary-first
        # split: K1 launches (plain twins here) per outer iteration
        # include the two boundary layers of every apply
        k1 = procs[0]["launches"]["stiffness_lattice_3d_plain"]["float64"]
        k1_ref = ref["launches"]["stiffness_lattice_3d_plain"]["float64"]
        assert k1 >= k1_ref


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_checks")
    init = mt.store(tmp)
    out = tmp / "checks"
    worker = os.path.join(mt.ROOT, "tests", "torch_multiprocess_worker.py")
    procs = mt.start(lambda r: [worker, str(r), "2", init, str(out),
                                "collectives", "split", "timer"], 2)
    mt.finish(procs, timeout=180)
    return [json.loads((tmp / f"checks.rank{r}.json").read_text())
            for r in range(2)]


def test_collectives_match_local_comm(checks):
    for rank, results in enumerate(checks):
        got = [r for r in results
               if not r[0].startswith(("split", "timer"))]
        assert len(got) == 2 * 10         # P = 4 and P = 2 (one shard each)
        bad = [r for r in got if not r[1]]
        assert not bad, (rank, bad)


def test_boundary_first_split_is_bitwise(checks):
    for rank, results in enumerate(checks):
        got = [r for r in results if r[0].startswith("split")]
        assert len(got) == 8
        bad = [r for r in got if not r[1]]
        assert not bad, (rank, bad)


def test_timer_vectors_are_measured_per_process(checks):
    # tests/test_multihost.py:80-88: the probe sleeps 50 ms on process 0
    # and 100 ms on process 1; the all-gather surfaces both values, not
    # one replicated, and the report expands them to the 4-shard vector
    for rank, results in enumerate(checks):
        (_, ok, got), = [r for r in results if r[0] == "timer"]
        assert ok
        tv = got["vec"]
        assert len(tv) == 2 and tv[1] > tv[0] + 0.02, tv
        assert tv[0] >= 0.045 and tv[1] >= 0.095, tv
        assert (f"{tv[0]:.6f} {tv[0]:.6f} {tv[1]:.6f} {tv[1]:.6f}"
                in got["report"]), got["report"]
    assert checks[0][-1][2]["vec"] == checks[1][-1][2]["vec"]


# the CLI as a user runs it across two processes: a small f64 composite
CLI_ARGV = ["3", "2", "1", "1", "--mesh", "kershaw", "--shape", "2,2,8",
            "--num-shards", "4", "--stype", "float64", "--ptype", "float64",
            "--tolerance", "1e-8", "--max-iterations", "100"]


def test_cli_across_two_processes_matches_one(tmp_path):
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.config import Config
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.driver import run_simulation
    import io
    import subprocess
    import sys
    record = tmp_path / "record"
    init = mt.store(tmp_path)
    env = dict(os.environ, PYTHONPATH=mt.ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               PRFDD_COORDINATOR=init, PRFDD_NUM_PROCESSES="2",
               PRFDD_BACKEND="gloo", PRFDD_RECORD=str(record))
    # the region dump too: each process writes its own shards' files
    dump = lambda name: ["--output-composite", str(tmp_path / name)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", mt.LAUNCH.rsplit(".", 2)[0]] + CLI_ARGV
        + dump("two.npz") + ["--device", "cpu"],
        env=dict(env, PRFDD_PROCESS_ID=str(r)),
        cwd=mt.ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = run_simulation(Config.from_args(CLI_ARGV + dump("one.npz")),
                             out=io.StringIO(), device="cpu")
    finally:
        torch.set_num_threads(threads)
    outs = mt.finish(procs, timeout=240)
    recs = [json.loads((tmp_path / f"record.rank{r}.json").read_text())
            for r in range(2)]
    assert one["converged"]
    for out, rec in zip(outs, recs):
        two = rec["record"]
        assert two["converged"] and "converged: True" in out
        assert two["iterations"] == one["iterations"]
        np.testing.assert_allclose(two["residual_history"],
                                   one["residual_history"], rtol=1e-9,
                                   atol=1e-14)
        # the timer report's per-shard vectors: 4 entries from the two
        # processes' own values
        line = next(l for l in out.splitlines()
                    if l.strip().startswith("mean:"))
        assert len(line.split("[")[1].split("]")[0].split()) == 4
        assert sum(rec["counts"]["stiffness_lattice_3d_plain"].values()) > 0
    assert recs[0]["record"]["residual_history"] == \
        recs[1]["record"]["residual_history"]
    # each process reports max|u - u*| over its own shards, as the JAX
    # driver does: together they are the one-process run's
    err = max(rec["record"]["max_error"] for rec in recs)
    assert err == pytest.approx(one["max_error"], rel=1e-6)
    # the two processes' region files (shards 0, 1 and 2, 3) against the
    # one process's
    for p in range(4):
        a = np.load(tmp_path / f"one_s{p}.npz")
        b = np.load(tmp_path / f"two_s{p}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if a[k].dtype.kind in "fc":
                assert np.abs(a[k] - b[k]).max(initial=0.0) <= \
                    1e-12 * np.abs(a[k]).max(initial=0.0), (p, k)
            else:
                assert np.array_equal(a[k], b[k]), (p, k)


def test_owned_shards_and_backend_are_explicit(monkeypatch):
    # one process owns everything; no group, no collective
    assert distributed.owned_shards(5) == (0, 1, 2, 3, 4)
    assert distributed.process_count() == 1
    assert distributed.init_method("localhost:1234") == "tcp://localhost:1234"
    assert distributed.init_method("file:///x/y") == "file:///x/y"
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert distributed.owned_shards(4) == (2, 3)
    with pytest.raises(ValueError):
        distributed.owned_shards(5)
    # no coordinator: a single process, nothing initialized
    monkeypatch.delenv("PRFDD_COORDINATOR", raising=False)
    distributed.initialize_multihost()
    # the backend is never guessed
    with pytest.raises(ValueError):
        distributed.initialize_multihost("localhost:1", 2, 0, backend=None)
    from polynomial_reduction_with_full_domain_decomposition_preconditioner_torch.runtime.comm import ProcessComm
    with pytest.raises(RuntimeError):
        ProcessComm(4)                 # no process group here
