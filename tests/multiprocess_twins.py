"""Helpers of the port's multi-process CPU tests: start the processes of
one gloo group with a file store in a test's temporary directory (no
port to pick, so parallel test workers never collide), each with one
torch and one OpenMP thread, and fail on the first that errs or
outlasts the deadline."""

import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = ("polynomial_reduction_with_full_domain_decomposition_"
          "preconditioner_torch.runtime.launch")


def start(argv_of_rank, nproc):
    """Start ``nproc`` processes, rank r running ``argv_of_rank(r)``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen([sys.executable] + argv_of_rank(r), env=env,
                             cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(nproc)]


def finish(procs, timeout):
    """Wait for every process, killing all of them at the deadline;
    pytest.fail on a timeout or a non-zero exit, with the output."""
    deadline = time.monotonic() + timeout
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            pytest.fail(f"a worker outlasted its {timeout} s")
        outputs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outputs):
        if p.returncode != 0:
            pytest.fail(f"worker failed (rc={p.returncode}):\n{out[-4000:]}")
    return outputs


def store(tmp_path):
    """A file-store init method in ``tmp_path`` (the file must not exist
    yet)."""
    path = tmp_path / "store"
    if path.exists():
        path.unlink()
    return f"file://{path}"
