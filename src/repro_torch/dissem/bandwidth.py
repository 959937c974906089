"""Per-node dissemination bandwidth accounting — partitioned vs global.

§5.2's bandwidth figures are dominated by the dissemination layer: batch
replication across the disseminator set plus the stability acks. This
module measures those bytes from engine traffic — the hold bitsets the
stability engine absorbed — per disseminator node, so the closed forms
become checkable against the engine, for both variants:

* **global** (the paper's base protocol): every batch is replicated to
  all m disseminators;
* **partitioned** (§5.5's second axis): the m disseminators are split
  into G per-group partitions of m/G, and a batch replicates only
  within its owning group's partition, so the per-node replication
  bandwidth drops by ~G while the stability rule (majority of the
  partition) keeps the same fault model per group.

Accounting model (a multicast puts one frame on the wire; every
delivered copy counts at the receiver):

  for each (slot s of group g, disseminator j) hold bit:
    in[g, j]        += batch_nbytes[g, s]          (j received the batch)
    out[g, j]       += OVERHEAD + ID_BYTES         (j acked to the owner)
    in[g, owner]    += OVERHEAD + ID_BYTES         (ack arrives back)
  for each slot s owned by j:
    out[g, j]       += batch_nbytes[g, s]          (one multicast frame)

Host numpy on int64, as in the reference: byte totals overflow int32 at
data-center scale, and accounting is an analysis pass, not a hot path.
The hold bitsets are read from a :class:`DissemState` on any device.
"""
from __future__ import annotations

import numpy as np

from ..core.network import ID_BYTES, OVERHEAD, batch_bytes
from .engine import DissemState, unpack_tile

ACK_BYTES = OVERHEAD + ID_BYTES


def partition_size(n_diss_total: int, groups: int) -> int:
    """Disseminators per partition (m/G); refuses ragged splits — a
    truncated partition would skew every per-node figure."""
    if n_diss_total % groups:
        raise ValueError(
            f"n_diss_total={n_diss_total} not divisible by groups={groups}:"
            " ragged disseminator partitions are not modeled")
    return n_diss_total // groups


def per_node_bytes(state: DissemState, owner: np.ndarray,
                   batch_nbytes: np.ndarray, n_diss: int)\
        -> tuple[np.ndarray, np.ndarray]:
    """Replication + ack bytes per disseminator node from final hold
    bitsets.

    owner: int32[G, W] — partition-local index of each slot's owning
    disseminator (the one that built and multicast the batch);
    batch_nbytes: int64[G, W] wire size of each slot's batch (0 for
    unused slots); n_diss: partition size. Returns (in_bytes, out_bytes)
    int64[G, n_diss]."""
    held = unpack_tile(state.hold_bits.cpu(), n_diss).numpy()  # [G, W, D]
    owner = np.asarray(owner)
    nbytes = np.asarray(batch_nbytes, dtype=np.int64)
    G, W, D = held.shape
    in_b = np.zeros((G, D), np.int64)
    out_b = np.zeros((G, D), np.int64)
    n_holders = held.sum(axis=2, dtype=np.int64)              # [G, W]
    used = nbytes > 0
    # deliveries: each holder received the slot's batch
    in_b += (held * nbytes[:, :, None]).sum(axis=1)
    # acks: one per delivery, sent by the holder ...
    out_b += ACK_BYTES * held.sum(axis=1, dtype=np.int64)
    for g in range(G):
        o = owner[g][used[g]]
        # ... arriving back at the slot's owner
        np.add.at(in_b[g], o, ACK_BYTES * n_holders[g][used[g]])
        # one multicast frame per owned batch
        np.add.at(out_b[g], o, nbytes[g][used[g]])
    return in_b, out_b


def replication_bytes_per_node(k: float, q: int, mp: int) -> dict:
    """Closed-form steady-state dissemination bytes per disseminator and
    unit time: each disseminator owns one batch of k requests per unit
    time, replicated to its partition of ``mp`` nodes (self-delivery
    included, the paper's counting).

      in  = mp · batch_bytes(k, q)  +  mp · ack     (batches + own-batch acks)
      out = batch_bytes(k, q)  +  mp · ack          (own multicast + acks sent)
    """
    b = batch_bytes(int(k), q) if float(k).is_integer() else \
        OVERHEAD + ID_BYTES + k * (ID_BYTES + q)
    inc = mp * b + mp * ACK_BYTES
    out = b + mp * ACK_BYTES
    return {"in": inc, "out": out, "total": inc + out}


def uniform_traffic(groups: int, window: int, n_diss: int,
                    batch_nbytes: int)\
        -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic one-unit-time workload for the closed-form cross-check:
    every partition member owns window/n_diss slots (window must be a
    multiple of n_diss), every batch is fully replicated. Returns
    (packed_holds uint32[G, W, WORDS], owner int32[G, W], nbytes
    int64[G, W]); carry the holds to the port with
    ``convert.bits_from_numpy``."""
    if window % n_diss:
        raise ValueError(f"window={window} not a multiple of "
                         f"n_diss={n_diss}: owners would be ragged")
    words = (n_diss + 31) // 32
    full = np.zeros(words, np.uint32)
    for j in range(n_diss):
        full[j // 32] |= np.uint32(1) << np.uint32(j % 32)
    packed = np.broadcast_to(full, (groups, window, words)).copy()
    owner = np.broadcast_to(
        (np.arange(window, dtype=np.int32) % n_diss)[None, :],
        (groups, window)).copy()
    nbytes = np.full((groups, window), batch_nbytes, np.int64)
    return packed, owner, nbytes
