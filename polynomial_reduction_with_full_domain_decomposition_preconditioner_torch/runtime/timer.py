"""Named accumulating timers with device synchronization.

Port of the JAX package's ``runtime/timer.py`` (the reference's Timer):
named regions where every start and stop synchronizes the device, the
synchronization's own cost calibrated (median of 24 samples) and
subtracted, and a report that aggregates per-shard totals as mean / max
with the per-shard vector. On the card a sync is
``torch.cuda.synchronize(device)``; on the CPU there is nothing to wait
for. Within one region the timer sees whole solves; a solve's inside is
the profiler's (``profile_trace``).
"""

from __future__ import annotations

import json
import os
import statistics
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from .. import resolve_device
from . import distributed

__all__ = ["Timer", "profile_trace"]


@dataclass
class Timer:
    """Named accumulating timers.

    Usage:
        timer = Timer(device=dev); timer.initialize()
        with timer("domain.operator_application"):
            ...
        print(timer.report())

    ``device`` is the device whose work a region waits for (None: the
    card, raising without one); ``sync=False`` never waits.
    """
    sync: bool = True
    device: object = None
    _totals: dict = field(default_factory=dict)
    _counts: dict = field(default_factory=dict)
    _starts: dict = field(default_factory=dict)
    _sync_cost: float = 0.0

    def __post_init__(self):
        if self.sync:
            self.device = resolve_device(self.device)

    def _device_sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def initialize(self, samples: int = 24):
        """Calibrate the device-sync overhead and subtract it from every
        measured interval (median of ``samples``)."""
        if not self.sync:
            return
        costs = []
        for _ in range(samples):
            t0 = time.perf_counter()
            self._device_sync()
            costs.append(time.perf_counter() - t0)
        self._sync_cost = statistics.median(costs)

    def start(self, name: str):
        if self.sync:
            self._device_sync()
        self._starts[name] = time.perf_counter()

    def stop(self, name: str):
        if self.sync:
            self._device_sync()
        dt = time.perf_counter() - self._starts.pop(name)
        # subtract the calibrated sync overhead only where it is a small
        # correction: below 10x the sync cost the subtraction would swamp
        # the measurement, so the raw reading is kept there
        if dt >= 10.0 * self._sync_cost:
            dt -= self._sync_cost
        self._totals[name] = self._totals.get(name, 0.0) + max(dt, 0.0)
        self._counts[name] = self._counts.get(name, 0) + 1

    def record(self, name: str, seconds: float):
        """Inject an externally measured interval (e.g. best-of-N repeats
        of a short region, where a single start/stop is noise-bound)."""
        self._totals[name] = self._totals.get(name, 0.0) + max(seconds, 0.0)
        self._counts[name] = self._counts.get(name, 0) + 1

    @contextmanager
    def __call__(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def total(self, name: str) -> float:
        return self._totals.get(name, 0.0)

    def gather_process_totals(self):
        """Measured per-process region totals: one all-gather over the
        processes of the ``torch.distributed`` group at report time.
        Returns (names, (nproc, R) array). Collective: every process must
        call it. Processes whose region-name sets differ keep their own
        values; a failed transfer raises."""
        import hashlib

        import numpy as np
        names = sorted(self._totals)
        vals = np.asarray([self._totals[n] for n in names])
        nproc = distributed.process_count()
        if nproc == 1:
            return names, vals[None]
        import torch.distributed as dist
        # agree on the region-name set first: a fixed-size hash gathers
        # the same shape everywhere, so diverged sets are detected instead
        # of misaligning columns
        h = hashlib.sha256("\x00".join(names).encode()).hexdigest()[:16]
        hashes = [None] * nproc
        dist.all_gather_object(hashes, h)
        if any(x != hashes[0] for x in hashes):
            return names, vals[None]
        every = [None] * nproc
        dist.all_gather_object(every, vals.tolist())
        return names, np.asarray(every, dtype=np.float64)

    def report(self, num_shards: int | None = None) -> str:
        """Hierarchical text table in the reference's output style
        ('<name>: <total> s  (xN)').

        With num_shards, each region also prints the mean / max over the
        shards and the per-shard vector '[ t_0 t_1 ... t_{P-1} ]'. Across
        processes the vectors are measured per process
        (``gather_process_totals``) and expanded to shards by the
        contiguous ownership map; within one process the shards run
        lockstep on one stacked tensor, so their entries are equal by
        construction.
        """
        gathered = None
        per_process = False
        if num_shards:
            names_g, mat = self.gather_process_totals()
            nproc = mat.shape[0]
            if num_shards % max(nproc, 1) == 0:
                per = num_shards // nproc
                # shard s belongs to process s // per (owned_shards map)
                gathered = {n: mat[:, i].repeat(per)
                            for i, n in enumerate(names_g)}
            else:
                # ragged ownership: the measured values are real, only
                # the shard expansion is ambiguous, so the per-process
                # vector is printed, labelled as such
                gathered = {n: mat[:, i] for i, n in enumerate(names_g)}
                per_process = True
        lines = []
        for name in sorted(self._totals):
            depth = name.count(".")
            t = self._totals[name]
            line = (f"{'  ' * depth}{name}: {t:.6f} s  "
                    f"(x{self._counts[name]})")
            if num_shards:
                v = gathered[name]
                vec = " ".join(f"{x:.6f}" for x in v)
                label = "per-process [" if per_process else "["
                line += (f"\n{'  ' * depth}  mean: {v.mean():.6f}  "
                         f"max: {v.max():.6f}  {label} {vec} ]")
            lines.append(line)
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"total_s": self._totals[k], "count": self._counts[k]}
                for k in self._totals}

    def dump_json(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=1, sort_keys=True)


@contextmanager
def profile_trace(logdir: str):
    """torch.profiler over the block (the card's activity too where there
    is a card), written as a Chrome trace ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
