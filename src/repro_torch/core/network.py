"""LAN model with fault injection and per-node traffic accounting. The
port's copy of ``repro.core.network`` (pure Python, as there), with the
wire size of a batch, ``batch_bytes``, which the reference defines in
``core/htpaxos.py`` and the port defines once, here.

The paper's system model (§3) has two LANs: LAN-1 carries bulk payloads
(requests/batches), LAN-2 carries control traffic (acks, ids, ordering-layer
Paxos). Messages may be lost, duplicated, and delivered out of order but not
corrupted (corruption is detected and treated as loss). We model every one of
those behaviours with a seeded RNG so property tests are reproducible.

Counting conventions (used by the §5 cross-check tests — documented here once):
  * a unicast ``send`` counts 1 outgoing message at the sender and, if
    delivered, 1 incoming message at the receiver;
  * a ``multicast`` counts **1 outgoing message** at the sender (hardware /
    IP multicast puts one frame on the wire — exactly the paper's counting:
    "one multicast of their own batch") and 1 incoming message per receiver
    that the fabric delivers to, **including the sender itself** when it is
    in the destination set (the paper counts "m batches from all
    disseminators (including self)" as incoming).
  * bytes follow the same rule: multicast transmits ``size`` bytes once.
"""
from __future__ import annotations

import random
import zlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable, Optional, TYPE_CHECKING

from .events import Scheduler

if TYPE_CHECKING:  # pragma: no cover
    from .agents import Agent


# Byte model from paper §5.2: 64-byte message overhead (IP header, Ethernet
# preamble/header/footer/gap, ARP, ...); request_id, batch_id, round number
# and instance number are 4 bytes each.
OVERHEAD = 64
ID_BYTES = 4


def batch_bytes(n_requests: int, request_bytes: int) -> int:
    # <batch_id, batch>: overhead + batch_id + per request (request_id + value)
    return OVERHEAD + ID_BYTES + n_requests * (ID_BYTES + request_bytes)


@dataclass
class Msg:
    kind: str
    src: str
    payload: dict
    size: int = OVERHEAD

    def __repr__(self) -> str:  # pragma: no cover
        return f"Msg({self.kind} from {self.src} {self.payload})"


@dataclass
class FaultModel:
    """Per-delivery fault injection. All probabilities are independent
    per (message, receiver) pair."""
    drop_p: float = 0.0
    dup_p: float = 0.0
    # uniform extra delay in [0, jitter] — with jitter > latency this yields
    # genuine reordering between consecutive sends
    jitter: float = 0.0


class NodeStats:
    __slots__ = ("sent_msgs", "recv_msgs", "sent_bytes", "recv_bytes",
                 "sent_by_kind", "recv_by_kind")

    def __init__(self) -> None:
        self.sent_msgs = 0
        self.recv_msgs = 0
        self.sent_bytes = 0
        self.recv_bytes = 0
        self.sent_by_kind: Counter = Counter()
        self.recv_by_kind: Counter = Counter()

    def total_msgs(self) -> int:
        return self.sent_msgs + self.recv_msgs

    def total_bytes(self) -> int:
        return self.sent_bytes + self.recv_bytes


class Lan:
    """One broadcast domain. ``latency`` is the one-hop message delay; the
    delay unit is abstract ("message delay" in the paper's latency analysis)."""

    def __init__(self, name: str, sched: Scheduler, latency: float = 1.0,
                 fault: Optional[FaultModel] = None, seed: int = 0) -> None:
        self.name = name
        self.sched = sched
        self.latency = latency
        self.fault = fault or FaultModel()
        # crc32-based seeding: stable across processes (str.__hash__ is
        # randomized by PYTHONHASHSEED and would break reproducibility)
        self.rng = random.Random(zlib.crc32(f"{seed}:{name}".encode()))
        self.nodes: dict[str, "Agent"] = {}
        self.stats: dict[str, NodeStats] = {}
        self.wire_bytes = 0
        self.wire_msgs = 0
        self.delivery_log: list[tuple[float, str, str, str]] = []
        self.log_deliveries = False
        # delivery taps: callables (now, dst, msg) invoked on every
        # successful arrival. Unlike delivery_log they see the Msg itself
        # (payload included) — the engine↔DES cross-validation extracts
        # dissemination traffic this way without touching agent logic.
        self.taps: list = []

    def attach(self, agent: "Agent") -> None:
        self.nodes[agent.node_id] = agent
        self.stats.setdefault(agent.node_id, NodeStats())

    def _stats(self, node_id: str) -> NodeStats:
        return self.stats.setdefault(node_id, NodeStats())

    # -- primitives of the paper's §3: Send and Multicast ------------------

    def send(self, src: str, dst: str, msg: Msg) -> None:
        st = self._stats(src)
        st.sent_msgs += 1
        st.sent_bytes += msg.size
        st.sent_by_kind[msg.kind] += 1
        self.wire_bytes += msg.size
        self.wire_msgs += 1
        self._deliver(dst, msg)

    def multicast(self, src: str, dsts: Iterable[str], msg: Msg) -> None:
        st = self._stats(src)
        st.sent_msgs += 1            # one frame on the wire
        st.sent_bytes += msg.size
        st.sent_by_kind[msg.kind] += 1
        self.wire_bytes += msg.size
        self.wire_msgs += 1
        for dst in dsts:
            self._deliver(dst, msg)

    def _deliver(self, dst: str, msg: Msg) -> None:
        f = self.fault
        ncopies = 1
        if f.drop_p and self.rng.random() < f.drop_p:
            ncopies = 0
        elif f.dup_p and self.rng.random() < f.dup_p:
            ncopies = 2
        for _ in range(ncopies):
            delay = self.latency
            if f.jitter:
                delay += self.rng.random() * f.jitter
            self.sched.after(delay, lambda dst=dst, msg=msg: self._arrive(dst, msg))

    def _arrive(self, dst: str, msg: Msg) -> None:
        agent = self.nodes.get(dst)
        if agent is None or not agent.alive:
            return  # crashed/unknown receiver: message is lost
        st = self._stats(dst)
        st.recv_msgs += 1
        st.recv_bytes += msg.size
        st.recv_by_kind[msg.kind] += 1
        if self.log_deliveries:
            self.delivery_log.append((self.sched.now, msg.src, dst, msg.kind))
        for tap in self.taps:
            tap(self.sched.now, dst, msg)
        agent.on_message(msg, self)
