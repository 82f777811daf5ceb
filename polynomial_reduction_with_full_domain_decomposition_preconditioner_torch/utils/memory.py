"""Seconds and peak memory by stage: the card's allocation and the host's
resident set."""

from __future__ import annotations

import copy
import resource
import time

import torch

__all__ = ["StageLog", "host_peak_rss_gb"]


def host_peak_rss_gb() -> float:
    """The process's peak resident host memory so far, GB (``ru_maxrss``
    is in KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


class StageLog:
    """The seconds, the card's peak and held allocation (None off the
    card) and the host's peak resident memory of each stage of a run.
    ``mark(stage)`` closes the stage that began at the last ``mark`` or
    ``start``; on the card both wait for the device first."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds, self.card_peak_gb = {}, {}
        self.card_allocated_gb, self.host_peak_rss_gb = {}, {}
        self.start()

    def _on_card(self) -> bool:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return True
        return False

    def start(self):
        if self._on_card():
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t0 = time.perf_counter()

    def mark(self, stage: str):
        on_card = self._on_card()
        self.seconds[stage] = time.perf_counter() - self._t0
        self.card_peak_gb[stage] = (
            torch.cuda.max_memory_allocated(self.device) / 1e9
            if on_card else None)
        self.card_allocated_gb[stage] = (
            torch.cuda.memory_allocated(self.device) / 1e9
            if on_card else None)
        self.host_peak_rss_gb[stage] = host_peak_rss_gb()
        self.start()

    def fork(self) -> "StageLog":
        """A log that holds this one's stages and starts anew."""
        other = copy.copy(self)
        for name in ("seconds", "card_peak_gb", "card_allocated_gb",
                     "host_peak_rss_gb"):
            setattr(other, name, dict(getattr(self, name)))
        other.start()
        return other

    def as_dict(self) -> dict:
        return {"seconds": dict(self.seconds),
                "card_peak_gb": dict(self.card_peak_gb),
                "card_allocated_gb": dict(self.card_allocated_gb),
                "host_peak_rss_gb": dict(self.host_peak_rss_gb)}
