"""Deterministic discrete-event scheduler for protocol simulation.

Every protocol in ``repro_torch.core`` (the port's copy of
``repro.core``) runs on this scheduler: a binary heap of
``(time, seq, fn)`` events where ``seq`` is a monotonically increasing
tiebreaker, which makes runs bit-reproducible for a fixed RNG seed
regardless of heap internals.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class Cancellable:
    """Handle returned by ``Scheduler.at``/``after`` — supports cancel()."""

    __slots__ = ("_ev",)

    def __init__(self, ev: _Event):
        self._ev = ev

    def cancel(self) -> None:
        self._ev.cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._ev.cancelled


class Scheduler:
    def __init__(self) -> None:
        self._heap: list[_Event] = []
        self._seq = 0
        self.now = 0.0
        self.events_run = 0

    def at(self, t: float, fn: Callable[[], None]) -> Cancellable:
        if t < self.now:
            t = self.now
        ev = _Event(t, self._seq, fn)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return Cancellable(ev)

    def after(self, delay: float, fn: Callable[[], None]) -> Cancellable:
        return self.at(self.now + delay, fn)

    def run(self, until: Optional[float] = None,
            max_events: int = 10_000_000) -> int:
        """Run events until the heap is drained, ``until`` is reached, or
        ``max_events`` processed. Returns number of events executed."""
        ran = 0
        while self._heap and ran < max_events:
            ev = self._heap[0]
            if until is not None and ev.time > until:
                break
            heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = max(self.now, ev.time)
            ev.fn()
            ran += 1
            self.events_run += 1
        if until is not None and not self._heap:
            self.now = max(self.now, until)
        elif until is not None:
            self.now = max(self.now, until)
        return ran

    def empty(self) -> bool:
        return not any(not e.cancelled for e in self._heap)
