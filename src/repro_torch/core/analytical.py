"""Closed-form message & bandwidth models from paper §5.

Two families of formulas:

* ``paper_*`` — the formulas exactly as printed in §5.1.1–§5.1.4 (used to
  reproduce Figs 1–3). The paper's counting is slightly loose at batch
  granularity (it counts one client reply per *batch* and drops the
  decision/client-final-ack terms at disseminators); we reproduce the
  printed forms verbatim.

* ``derived_*`` — the exact per-role steady-state counts of *our
  executable implementation* (one "unit time" = one batch round per
  disseminator). The cross-check test asserts the simulator's measured
  counts equal ``derived_*`` exactly, and that ``paper_*`` differs from
  ``derived_*`` only by the documented small terms — which makes the
  paper's analysis *executable* rather than merely re-plotted.

Symbols follow §5.1.1: n requests per unit time, m disseminators
(replicas/acceptors for the other protocols), s sequencers; each
disseminator builds one batch of n/m requests per unit time; the leader
builds one ordering batch of m batch_ids.

The port's copy of ``repro.core.analytical`` (pure Python, as there).
"""
from __future__ import annotations

from dataclasses import dataclass

from .network import ID_BYTES, OVERHEAD


# --------------------------------------------------------------------------
# §5.1 message counts — paper-printed forms
# --------------------------------------------------------------------------

def paper_ht_disseminator(n: float, m: int, s: int) -> dict:
    inc = (n / m) + 2 * m
    out = m + 3
    return {"in": inc, "out": out, "total": 3 * m + n / m + 3}


def paper_ht_leader(n: float, m: int, s: int) -> dict:
    inc = m + s // 2
    out = 2
    return {"in": inc, "out": out, "total": m + s // 2 + 2}


def paper_ht_sequencer(n: float, m: int, s: int) -> dict:
    return {"in": m + 2, "out": 1, "total": m + 3}


def paper_ht_learner(n: float, m: int, s: int) -> dict:
    return {"in": m + 1, "out": 0, "total": m + 1}


def paper_ht_ft_leader_site(n: float, m: int, s: int) -> dict:
    """FT variant (§4.2): every disseminator site hosts a sequencer; the
    busiest site is the leader's (disseminator + ordering leader roles).
    The paper plots this (Fig 3) without printing the formula; this is the
    disseminator-site count plus the leader count with s = m."""
    d = paper_ht_disseminator(n, m, m)
    l = paper_ht_leader(n, m, m)
    return {"in": d["in"] + l["in"], "out": d["out"] + l["out"],
            "total": d["total"] + l["total"]}


def paper_ring_leader(n: float, m: int) -> dict:
    return {"in": n + m, "out": n + m + 1, "total": 2 * (n + m) + 1}


def paper_spaxos_leader(n: float, m: int) -> dict:
    inc = (n / m) + m + m * m + m // 2 + 1
    out = n / m + m + 3
    return {"in": inc, "out": out,
            "total": m * m + 2 * (n / m) + 2 * m + m // 2 + 4}


def paper_classical_leader(n: float, m: int) -> dict:
    inc = n + m * (m // 2)
    out = n + 2 * m
    return {"in": inc, "out": out, "total": 2 * (n + m) + m * (m // 2)}


# --------------------------------------------------------------------------
# §5.1 message counts — implementation-derived forms (simulator-exact)
# --------------------------------------------------------------------------
# Conventions (see network.py): multicast = 1 outgoing message; self-
# deliveries count as incoming; every client reply/final-ack is counted.

def derived_ht_disseminator(n: float, m: int, s: int) -> dict:
    k = n / m
    inc = (k          # client requests
           + m        # batches from all disseminators (incl. self)
           + m        # acks for own batch (incl. self-ack)
           + 1        # decision multicast from the leader
           + k)       # client final acks (alg. step 8)
    out = (1          # own batch multicast
           + m        # one ack per received batch
           + 1        # batched id multicast to sequencers
           + k)       # one reply per client request
    return {"in": inc, "out": out, "total": inc + out}


def derived_ht_leader(n: float, m: int, s: int) -> dict:
    inc = (m          # one id-multicast per disseminator
           + (s - 1))  # phase 2b from every other sequencer (all reply;
                       # only ⌊s/2⌋ are *required* — the paper counts the
                       # required majority, we count all arrivals)
    out = 2           # phase 2a multicast + decision multicast
    return {"in": inc, "out": out, "total": inc + out}


def derived_ht_sequencer(n: float, m: int, s: int) -> dict:
    inc = m + 1 + 1   # id multicasts + phase 2a + decision
    out = 1           # phase 2b
    return {"in": inc, "out": out, "total": inc + out}


def derived_ht_learner(n: float, m: int, s: int) -> dict:
    inc = m + 1       # batches + decision
    return {"in": inc, "out": 0, "total": inc}


# --------------------------------------------------------------------------
# §5.2 bandwidth — byte models (paper constants: 64 B overhead, 4 B ids)
# --------------------------------------------------------------------------

def _batch_bytes(k: float, q: int) -> float:
    return OVERHEAD + ID_BYTES + k * (ID_BYTES + q)


def bytes_ht_disseminator(n: float, m: int, s: int, q: int) -> dict:
    k = n / m
    inc = (k * (OVERHEAD + ID_BYTES + q)            # client requests
           + m * _batch_bytes(k, q)                 # all batches
           + m * (OVERHEAD + ID_BYTES)              # acks for own batch
           + (OVERHEAD + 2 * ID_BYTES + ID_BYTES * m)   # decision
           + k * (OVERHEAD + ID_BYTES))             # client final acks
    out = (_batch_bytes(k, q)                       # own batch multicast
           + m * (OVERHEAD + ID_BYTES)              # acks sent
           + (OVERHEAD + ID_BYTES * m)              # id multicast (m ids)
           + k * (OVERHEAD + ID_BYTES))             # replies
    return {"in": inc, "out": out, "total": inc + out}


def bytes_ht_disseminator_partitioned(n: float, m: int, s: int, q: int,
                                      groups: int) -> dict:
    """§5.5's second scaling axis: the m disseminators split into
    ``groups`` partitions of mp = m/groups; a batch replicates only
    within its owning partition, so every per-unit-time replication term
    of :func:`bytes_ht_disseminator` shrinks from m to mp — batches
    received, acks exchanged, ids per id-multicast and per decision. The
    request-facing terms (client requests, final acks, replies) are
    unchanged: partitioning shards *replication*, not load. With
    ``groups=1`` this is exactly :func:`bytes_ht_disseminator`."""
    if m % groups:
        raise ValueError(f"m={m} not divisible by groups={groups}")
    mp = m // groups
    k = n / m
    inc = (k * (OVERHEAD + ID_BYTES + q)            # client requests
           + mp * _batch_bytes(k, q)                # partition batches
           + mp * (OVERHEAD + ID_BYTES)             # acks for own batch
           + (OVERHEAD + 2 * ID_BYTES + ID_BYTES * mp)  # group decision
           + k * (OVERHEAD + ID_BYTES))             # client final acks
    out = (_batch_bytes(k, q)                       # own batch multicast
           + mp * (OVERHEAD + ID_BYTES)             # acks sent
           + (OVERHEAD + ID_BYTES * mp)             # id multicast (mp ids)
           + k * (OVERHEAD + ID_BYTES))             # replies
    return {"in": inc, "out": out, "total": inc + out}


def bytes_ht_leader(n: float, m: int, s: int, q: int) -> dict:
    inc = (m * (OVERHEAD + ID_BYTES * m)            # id multicasts
           + (s - 1) * (OVERHEAD + 2 * ID_BYTES))   # phase 2b
    out = ((OVERHEAD + 2 * ID_BYTES + ID_BYTES * m)   # phase 2a
           + (OVERHEAD + 2 * ID_BYTES + ID_BYTES * m))  # decision
    return {"in": inc, "out": out, "total": inc + out}


def bytes_spaxos_leader(n: float, m: int, q: int) -> dict:
    k = n / m
    inc = (k * (OVERHEAD + ID_BYTES + q)
           + m * _batch_bytes(k, q)                 # batches
           + m * m * (OVERHEAD + ID_BYTES)          # all-to-all acks
           + (m - 1) * (OVERHEAD + 2 * ID_BYTES))   # phase 2b (all reply)
    out = (k * (OVERHEAD + ID_BYTES)                # replies
           + _batch_bytes(k, q)                     # own batch
           + m * (OVERHEAD + ID_BYTES)              # ack multicasts
           + (OVERHEAD + 2 * ID_BYTES + ID_BYTES * m)   # phase 2a
           + (OVERHEAD + 2 * ID_BYTES + ID_BYTES * m))  # decision
    return {"in": inc, "out": out, "total": inc + out}


def bytes_ring_leader(n: float, m: int, q: int) -> dict:
    k = n / m
    inc = (n * (OVERHEAD + ID_BYTES + q)            # every client request
           + m * (OVERHEAD + 3 * ID_BYTES + m))     # ring completions
    out = (n * (OVERHEAD + ID_BYTES)                # replies
           + m * (OVERHEAD + 3 * ID_BYTES + k * (ID_BYTES + q))  # phase 2 mc
           + (OVERHEAD + 2 * ID_BYTES * m))         # decision multicast
    return {"in": inc, "out": out, "total": inc + out}


def bytes_classical_leader(n: float, m: int, q: int) -> dict:
    k = n / m
    batch_payload = k * (ID_BYTES + q)
    inc = (n * (OVERHEAD + ID_BYTES + q)            # every client request
           + m * (m - 1) * (OVERHEAD + 2 * ID_BYTES))  # 2b per batch
    out = (n * (OVERHEAD + ID_BYTES)                # replies
           + m * (OVERHEAD + 2 * ID_BYTES + batch_payload)   # 2a (payload!)
           + m * (OVERHEAD + 2 * ID_BYTES + batch_payload))  # decision
    return {"in": inc, "out": out, "total": inc + out}


def bytes_ht_ft_leader_site(n: float, m: int, q: int) -> dict:
    d = bytes_ht_disseminator(n, m, m, q)
    l = bytes_ht_leader(n, m, m, q)
    return {"in": d["in"] + l["in"], "out": d["out"] + l["out"],
            "total": d["total"] + l["total"]}


# --------------------------------------------------------------------------
# §5.3 / §5.4 best-case delay counts
# --------------------------------------------------------------------------

DELAYS = {
    # (learning delay, client-response delay) in message delays, best case
    "ht-paxos": (6, 4),
    "s-paxos": (6, 6),
    "classical": (4, 4),      # message-optimized ordering
    "fast": (2, None),
    "generalized": (2, None),
}


def ring_delays(m: int) -> tuple[int, int]:
    """Ring Paxos: (m + 2) message delays, m = acceptors in the ring."""
    return (m + 2, m + 2)
