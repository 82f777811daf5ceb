"""Timing of device work with CUDA events."""

from __future__ import annotations

import torch

__all__ = ["cuda_ms"]

_HOLD_CYCLES = 40_000_000   # ~20 ms at the H100's clocks


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, by CUDA events, after a warm-up.

    A launch through Python costs tens of microseconds, as much as a small
    kernel runs, so a plain event pair around the loop would time the
    host. The stream is therefore first held busy by a spin kernel: the
    host enqueues every call meanwhile, and the events bracket device
    work only. ``iters`` calls must enqueue within the hold (~20 ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters
