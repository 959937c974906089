"""Request → batch accumulation under a wire-byte budget (§4.1 step 13).

The port's copy of the reference's streaming ``BatchAccumulator``. A
batch of requests with payload sizes ``q_i`` costs ``OVERHEAD + ID_BYTES
+ Σ (ID_BYTES + q_i)`` on the wire (``core.network.batch_bytes``); a
batch is flushed when admitting the next request would push it past
``budget_bytes`` or past ``max_requests``. Host-side: the closed
pipeline's numpy twin (``pipeline.closed.plan_admissions``) replays a
workload through one accumulator per disseminator lane.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.network import ID_BYTES, OVERHEAD

EMPTY_BATCH_BYTES = OVERHEAD + ID_BYTES     # header: overhead + batch_id


def request_wire_bytes(size: int) -> int:
    """Wire cost of adding one request of payload ``size`` to a batch."""
    return ID_BYTES + int(size)


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
        if self.budget_bytes <= EMPTY_BATCH_BYTES:
            raise ValueError(
                f"budget_bytes={self.budget_bytes} cannot fit the batch "
                f"header ({EMPTY_BATCH_BYTES} B) plus any request")

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
