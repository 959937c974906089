"""Vectorized byte-budget batch accumulation (§4.1 step 13) in PyTorch.

The tensor twin of ``dissem.batcher.BatchAccumulator`` that the closed
pipeline runs every tick: one :func:`batch_step` per request slot,
vectorized across the D disseminator lanes, with the accumulator
registers (``used`` wire bytes, ``count`` requests, ``seq`` next batch
number) carried as a :class:`BatchState` from tick to tick. The
reference scans the K request slots of a lane with ``lax.scan``; here
they are a Python loop over K, each step one set of elementwise ops on
``[D]`` tensors.

Semantics of ``BatchAccumulator.add``: a request of payload ``s`` costs
``ID_BYTES + s`` on the wire; it closes the open batch first iff the
batch is non-empty and either the cost would push past ``budget_bytes``
or the batch already holds ``max_requests``. :func:`tick_flushes` adds
the per-tick tail flush (linger 0), emitting at most ``K + 1`` batches
per lane per tick: overflow closures at their stream positions, the
tail last.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.network import ID_BYTES
from ..device import resolve_device
from ..dissem.batcher import EMPTY_BATCH_BYTES

_NO_CAP = 1 << 30       # max_requests=None sentinel (count never reaches it)
_I32 = torch.int32


class BatchState(NamedTuple):
    """Per-disseminator-lane accumulator registers (all int32[D])."""
    used: torch.Tensor     # wire bytes of the open batch, incl. header
    count: torch.Tensor    # requests in the open batch
    seq: torch.Tensor      # next batch sequence number to assign


def init_batch_state(n_lanes: int, device=None) -> BatchState:
    """Empty accumulators on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return BatchState(
        used=torch.full((n_lanes,), EMPTY_BATCH_BYTES, dtype=_I32,
                        device=dev),
        count=torch.zeros((n_lanes,), dtype=_I32, device=dev),
        seq=torch.zeros((n_lanes,), dtype=_I32, device=dev))


def batch_step(carry, size, valid, *, budget_bytes: int,
               max_requests: int | None):
    """One ``BatchAccumulator.add`` on every lane at once.

    carry: ``(used, count, seq)`` int32[D]; ``size`` int32[D], ``valid``
    bool[D]. Returns the new carry and ``(closed, closed_seq,
    closed_count, closed_bytes)``: the batch each lane flushed because of
    this request (meaningful only where ``closed``). The request itself
    joins the (possibly fresh) open batch."""
    used, count, seq = carry
    cap = _NO_CAP if max_requests is None else int(max_requests)
    cost = size + ID_BYTES
    closed = valid & (count > 0) & (
        (used + cost > budget_bytes) | (count >= cap))
    closed_seq, closed_count, closed_bytes = seq, count, used
    seq = torch.where(closed, seq + 1, seq)
    used = torch.where(closed, EMPTY_BATCH_BYTES, used)
    count = torch.where(closed, 0, count)
    used = torch.where(valid, used + cost, used)
    count = torch.where(valid, count + 1, count)
    return (used, count, seq), (closed, closed_seq, closed_count,
                                closed_bytes)


class TickFlushes(NamedTuple):
    """Batches flushed by one tick of every lane, in flush order.

    Position ``i < K`` is the batch closed by request slot ``i``
    (overflow closure); position ``K`` is the end-of-tick tail flush.
    ``req_seq[:, i]`` is the batch each request was assigned to."""
    valid: torch.Tensor    # bool[D, K+1]
    seq: torch.Tensor      # int32[D, K+1]
    count: torch.Tensor    # int32[D, K+1]
    bytes: torch.Tensor    # int32[D, K+1] wire bytes incl. header
    req_seq: torch.Tensor  # int32[D, K]


def tick_flushes(state: BatchState, sizes: torch.Tensor, valid: torch.Tensor,
                 *, budget_bytes: int, max_requests: int | None = None,
                 flush_tail: bool = True)\
        -> tuple[BatchState, TickFlushes]:
    """One tick of request intake across all lanes.

    ``sizes``/``valid``: int32/bool[D, K] — lane-major request slots in
    client order. ``flush_tail=True`` is the linger-0 contract (every
    open batch flushes at the end of the tick); ``False`` carries the
    open batch into the next tick, and :class:`TickFlushes` then reports
    only overflow closures."""
    if budget_bytes <= EMPTY_BATCH_BYTES:
        raise ValueError(
            f"budget_bytes={budget_bytes} cannot fit the batch header "
            f"({EMPTY_BATCH_BYTES} B) plus any request")
    carry = (state.used, state.count, state.seq)
    steps = []
    for i in range(sizes.shape[1]):
        carry, out = batch_step(carry, sizes[:, i], valid[:, i],
                                budget_bytes=budget_bytes,
                                max_requests=max_requests)
        steps.append(out)
    used, count, seq = carry
    closed, cseq, ccount, cbytes = (torch.stack(x, dim=1)
                                    for x in zip(*steps))
    # request i joined the batch open after its closure check: the seq of
    # the tick's first batch plus the closures at positions <= i
    req_seq = state.seq[:, None] + torch.cumsum(closed.to(_I32), dim=1,
                                                dtype=_I32)
    if flush_tail:
        tail = count > 0
        last = (tail, seq, count, used)
        seq = torch.where(tail, seq + 1, seq)
        used = torch.where(tail, EMPTY_BATCH_BYTES, used)
        count = torch.where(tail, 0, count)
    else:
        zero = torch.zeros_like(seq)
        last = (torch.zeros_like(closed[:, 0]), zero, zero, zero)
    out = TickFlushes(
        *(torch.cat([x, y[:, None]], dim=1)
          for x, y in zip((closed, cseq, ccount, cbytes), last)),
        req_seq=req_seq)
    return BatchState(used, count, seq), out
