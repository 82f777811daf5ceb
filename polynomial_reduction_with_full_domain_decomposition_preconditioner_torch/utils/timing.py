"""Timing of device work with CUDA events, and the card a time is
taken on."""

from __future__ import annotations

import subprocess
import time

import torch

__all__ = ["card", "cuda_ms", "cuda_cold_ms"]

_HOLD_CYCLES = 40_000_000   # ~20 ms at the H100's clocks
_CYCLES_PER_S = 2.0e9        # no less than the spin takes: the H100 boosts to 1.98 GHz
_FLUSH_BYTES = 256 << 20     # five times the H100's 50 MB L2


def card(device=None) -> str:
    """The name and power limit of the card ``device`` names (None: the
    current card) as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them, the line a time is kept beside;
    ``str(device)`` for a device off the card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return str(device)
    # nvidia-smi numbers the cards its own way: find this one by its UUID
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for row in rows:
        smi_uuid, name_limit = row.split(", ", 1)
        if smi_uuid.endswith(uuid):
            return name_limit
    raise RuntimeError(f"nvidia-smi lists no card with UUID {uuid}: "
                       f"{rows}")


def _hold_stream(enqueue) -> None:
    """Run ``enqueue()`` (which launches the timed work) while a spin
    kernel holds the stream, so that what it enqueues runs back to back on
    the device. If the host took longer than the hold lasts (a first call
    that loads a module, a slow host), the timed work ran at the host's
    pace: hold twice as long and try again."""
    cycles = _HOLD_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        enqueue()
        held = time.perf_counter() - t0 < 0.6 * cycles / _CYCLES_PER_S
        torch.cuda.synchronize()
        if held:
            return
        cycles *= 2
    raise RuntimeError("the host cannot enqueue the timed launches while "
                       "the stream is held; time fewer launches")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, by CUDA events, after a warm-up.

    A launch through Python costs tens of microseconds, as much as a small
    kernel runs, so a plain event pair around the loop would time the
    host. The stream is therefore first held busy by a spin kernel: the
    host enqueues every call meanwhile, and the events bracket device
    work only. An ``fn`` that waits on the stream itself (a host-to-device
    copy, a host read) cannot be timed so: the hold is then found broken
    and the call raises."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def enqueue():
        start.record()
        for _ in range(iters):
            fn()
        stop.record()

    _hold_stream(enqueue)
    return start.elapsed_time(stop) / iters


def cuda_cold_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` when its operands come from
    device memory and not from the L2 cache: before every timed call a
    256 MB scratch buffer is overwritten, which evicts what the last call
    left in the 50 MB L2, and each call has an event pair of its own, so
    the overwrites are not timed. The stream is held as in ``cuda_ms``.
    A pair of events adds about a microsecond to what it brackets."""
    scratch = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        scratch.fill_(1)
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]

    def enqueue():
        for k, (start, stop) in enumerate(pairs):
            scratch.fill_(k & 1)
            start.record()
            fn()
            stop.record()

    _hold_stream(enqueue)
    return sum(a.elapsed_time(b) for a, b in pairs) / iters
