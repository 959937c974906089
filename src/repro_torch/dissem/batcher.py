"""Request → batch accumulation under a wire-byte budget (§4.1 step 13).

The port's copy of the reference's batcher. A batch of requests with
payload sizes ``q_i`` costs ``OVERHEAD + ID_BYTES + Σ (ID_BYTES + q_i)``
on the wire (``core.network.batch_bytes``); a batch is flushed when
admitting the next request would push it past ``budget_bytes`` or past
``max_requests``. Two equivalent forms, as in the reference:

* :func:`plan_batches` — one-shot greedy plan over a numpy size array
  (order-preserving: request i never jumps ahead of request j < i), with
  :func:`batch_wire_sizes` the plan's per-batch wire bytes;
* :class:`BatchAccumulator` — the streaming mirror (one ``add`` per
  request arrival, flush on overflow or count).

Host-side: the closed pipeline's numpy twin
(``pipeline.closed.plan_admissions``) replays a workload through one
accumulator per disseminator lane.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.network import ID_BYTES, OVERHEAD

EMPTY_BATCH_BYTES = OVERHEAD + ID_BYTES     # header: overhead + batch_id


def request_wire_bytes(size: int) -> int:
    """Wire cost of adding one request of payload ``size`` to a batch."""
    return ID_BYTES + int(size)


def _check_budget(budget_bytes: int) -> None:
    if budget_bytes <= EMPTY_BATCH_BYTES:
        raise ValueError(
            f"budget_bytes={budget_bytes} cannot fit the batch header "
            f"({EMPTY_BATCH_BYTES} B) plus any request")


def plan_batches(request_sizes, *, budget_bytes: int,
                 max_requests: int | None = None) -> np.ndarray:
    """Greedy order-preserving batch assignment.

    request_sizes: int array [N] of payload bytes. Returns int32[N] batch
    index per request (consecutive from 0). A batch closes when admitting
    the next request would exceed ``budget_bytes`` on the wire or reach
    ``max_requests``; a single oversized request still gets a batch of
    its own (requests are atomic: the budget bounds batching, it is not
    an admission filter)."""
    _check_budget(budget_bytes)
    sizes = np.asarray(request_sizes, dtype=np.int64)
    out = np.empty(len(sizes), np.int32)
    batch, used, count = 0, EMPTY_BATCH_BYTES, 0
    for i, s in enumerate(sizes):
        cost = request_wire_bytes(int(s))
        if count > 0 and (
                used + cost > budget_bytes
                or (max_requests is not None and count >= max_requests)):
            batch += 1
            used, count = EMPTY_BATCH_BYTES, 0
        out[i] = batch
        used += cost
        count += 1
    return out


def batch_wire_sizes(request_sizes, assignment) -> np.ndarray:
    """Per-batch wire bytes of a :func:`plan_batches` assignment:
    int64[n_batches], entry b = header + Σ assigned request costs."""
    sizes = np.asarray(request_sizes, dtype=np.int64)
    assignment = np.asarray(assignment, dtype=np.int64)
    n = int(assignment.max()) + 1 if len(assignment) else 0
    out = np.full(n, EMPTY_BATCH_BYTES, np.int64)
    np.add.at(out, assignment, ID_BYTES + sizes)
    return out


@dataclass
class BatchAccumulator:
    """Streaming batch accumulator.

    ``add(size)`` returns the flushed batch (list of request payload
    sizes) when the new request *closed* the previous batch, else None;
    ``flush()`` drains the in-progress tail. A single oversized request
    still gets a batch of its own (requests are atomic)."""
    budget_bytes: int
    max_requests: int | None = None
    _sizes: list = field(default_factory=list)
    _used: int = EMPTY_BATCH_BYTES
    n_flushed: int = 0
    bytes_flushed: int = 0

    def __post_init__(self) -> None:
        _check_budget(self.budget_bytes)

    def add(self, size: int):
        cost = request_wire_bytes(size)
        flushed = None
        if self._sizes and (
                self._used + cost > self.budget_bytes
                or (self.max_requests is not None
                    and len(self._sizes) >= self.max_requests)):
            flushed = self.flush()
        self._sizes.append(int(size))
        self._used += cost
        return flushed

    def flush(self):
        if not self._sizes:
            return None
        out, self._sizes = self._sizes, []
        self.n_flushed += 1
        self.bytes_flushed += self._used
        self._used = EMPTY_BATCH_BYTES
        return out
