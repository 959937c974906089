"""Vectorized client workload model (the pipeline's traffic source).

``n_clients`` clients each submit requests to a statically assigned
disseminator (client ``c`` → disseminator ``c mod n_diss``, as the
simulator's ``random_client_target=False`` rule). A :class:`Workload` is
the whole run's traffic, pre-drawn as dense per-tick tensors:

* ``arrived[t, c]`` — did client ``c`` submit a request at tick ``t``;
* ``sizes[t, c]`` — its payload bytes (0 where nothing arrived).

Pre-drawing lets the same arrays drive the pipeline
(``pipeline.closed``) and the discrete-event simulator (through
:meth:`Workload.schedule`). :meth:`Workload.from_schedule` builds exact
traffic from ``(tick, client, size)`` triples; :class:`WorkloadModel`
draws random traffic from a ``torch.Generator``. The reference draws
from a JAX PRNG key, which torch cannot reproduce; the same generator
state gives the same workload here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class Workload(NamedTuple):
    """One run's client traffic as dense tensors (ticks × clients)."""
    arrived: torch.Tensor   # bool[T, C]
    sizes: torch.Tensor     # int32[T, C]; 0 where not arrived

    @property
    def n_ticks(self) -> int:
        return self.arrived.shape[0]

    @property
    def n_clients(self) -> int:
        return self.arrived.shape[1]

    @property
    def n_requests(self) -> int:
        return int(self.arrived.sum())

    @property
    def total_bytes(self) -> int:
        return int(self.sizes.sum(dtype=torch.int64))

    @classmethod
    def from_schedule(cls, events, *, ticks: int, n_clients: int,
                      device=None) -> "Workload":
        """Exact workload from ``(tick, client, size)`` triples, on
        ``device`` (default ``cuda``). At most one request per (tick,
        client) cell — duplicates raise."""
        arrived = np.zeros((ticks, n_clients), bool)
        sizes = np.zeros((ticks, n_clients), np.int32)
        for (t, c, size) in events:
            if not 0 <= t < ticks:
                raise ValueError(f"tick {t} outside [0, {ticks})")
            if not 0 <= c < n_clients:
                raise ValueError(f"client {c} outside [0, {n_clients})")
            if arrived[t, c]:
                raise ValueError(f"duplicate arrival at tick={t} "
                                 f"client={c}")
            if size < 0:
                raise ValueError(f"negative request size {size}")
            arrived[t, c] = True
            sizes[t, c] = size
        dev = resolve_device(device)
        return cls(torch.from_numpy(arrived).to(dev),
                   torch.from_numpy(sizes).to(dev))

    def schedule(self) -> list[tuple[int, int, int]]:
        """The workload as ``(tick, client, size)`` triples in (tick,
        client) order: the exact inverse of :meth:`from_schedule`."""
        arrived = self.arrived.cpu().numpy()
        sizes = self.sizes.cpu().numpy()
        return [(int(t), int(c), int(sizes[t, c]))
                for t, c in zip(*np.nonzero(arrived))]


@dataclass(frozen=True)
class WorkloadModel:
    """Random-workload generator.

    ``arrival_rate`` is the per-client per-tick Bernoulli probability;
    sizes are drawn from ``size_choices`` with ``size_probs`` weights
    (``None`` → uniform over the choices)."""
    n_clients: int
    arrival_rate: float
    size_choices: tuple[int, ...] = (1024,)
    size_probs: tuple[float, ...] | None = None

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        if not 0.0 <= self.arrival_rate <= 1.0:
            raise ValueError(f"arrival_rate={self.arrival_rate} outside "
                             "[0, 1]")
        if not self.size_choices:
            raise ValueError("size_choices must be non-empty")
        if any(s < 0 for s in self.size_choices):
            raise ValueError(f"negative size in {self.size_choices}")
        if self.size_probs is not None:
            if len(self.size_probs) != len(self.size_choices):
                raise ValueError(
                    f"size_probs has {len(self.size_probs)} entries for "
                    f"{len(self.size_choices)} choices")
            if abs(sum(self.size_probs) - 1.0) > 1e-6:
                raise ValueError(f"size_probs sum to "
                                 f"{sum(self.size_probs)}, not 1")

    def draw(self, generator: torch.Generator, ticks: int) -> Workload:
        """Draw ``ticks`` of traffic from ``generator``, on its device:
        arrivals from one uniform draw, then each size by inverting the
        cumulative ``size_probs`` at a second uniform draw."""
        dev = generator.device
        shape = (ticks, self.n_clients)
        arrived = torch.rand(shape, generator=generator, device=dev) \
            < self.arrival_rate
        n = len(self.size_choices)
        probs = torch.tensor(self.size_probs or (1.0 / n,) * n,
                             dtype=torch.float64, device=dev)
        u = torch.rand(shape, generator=generator, device=dev,
                       dtype=torch.float64)
        idx = torch.searchsorted(torch.cumsum(probs, 0), u, right=True)
        choices = torch.tensor(self.size_choices, dtype=torch.int32,
                               device=dev)
        sizes = torch.where(arrived, choices[idx.clamp(max=n - 1)], 0)
        return Workload(arrived, sizes.to(torch.int32))
