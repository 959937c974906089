"""Ring Paxos baseline (paper §2.4, [23] Marandi et al. DSN'10).

A logical ring of m acceptors; one acceptor is the coordinator (leader).
All clients talk to the coordinator. Per batch:
  1. coordinator assigns ids, ip-multicasts <batch, ids, round, instance>
     to all acceptors and learners (LAN-1);
  2. the first acceptor of the ring creates a small message with its
     decision and forwards it along the ring (LAN-2);
  3. each acceptor appends its decision if it has the corresponding batch;
  4. on receiving the message from the last acceptor, the coordinator
     declares the ids chosen and multicasts the decision to all acceptors
     and learners (piggybacked onto the next multicast under high load).

Latency is (m+2) message delays (paper §5.3) and every client message rides
through the coordinator — the two structural costs HT-Paxos removes.

Failure handling: an acceptor crash stalls the ring; the coordinator
detects the stall (ring timeout) and reforms the ring excluding the dead
acceptor as long as a majority survives (the paper's "any failure of
acceptor requires a view change"). Coordinator failure is out of scope for
the §5 throughput comparison (noted in DESIGN.md).

The port's copy of ``repro.core.ring`` (pure Python, as there).
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass
from typing import Optional

from .agents import Agent, SimBase
from .network import ID_BYTES, Lan, Msg, OVERHEAD


@dataclass
class RingConfig:
    n_acceptors: int = 5             # includes the coordinator
    n_learners: int = 1
    n_clients: int = 4
    request_bytes: int = 1024
    batch_size: int = 4
    batch_linger: float = 0.0
    decision_linger: float = 0.0     # piggyback window for decisions
    ring_timeout: float = 200.0      # stall detection → view change
    client_retry: float = 400.0
    seed: int = 0


def batch_bytes(n_requests: int, request_bytes: int) -> int:
    return OVERHEAD + 3 * ID_BYTES + n_requests * (ID_BYTES + request_bytes)


class RingClient(Agent):
    def __init__(self, sim: "RingPaxosSim", node_id: str, n_requests: int,
                 gap: float = 0.0, group=None) -> None:
        super().__init__(sim, node_id)
        self.rsim = group if group is not None else sim
        self.cfg = self.rsim.cfg
        self.n_requests = n_requests
        self.gap = gap
        self.next_seq = 0
        self.pending: dict[tuple, float] = {}
        self.replied: dict[tuple, float] = {}
        if n_requests:
            self.after(0.0, self._issue_next)

    def _issue_next(self) -> None:
        if self.next_seq >= self.n_requests:
            return
        rid = (self.node_id, self.next_seq)
        self.next_seq += 1
        self.pending[rid] = self.sched.now
        self._send(rid)
        self.periodic(self.cfg.client_retry, lambda rid=rid: self._send(rid),
                      stop=lambda rid=rid: rid in self.replied)
        if self.next_seq < self.n_requests:
            self.after(self.gap, self._issue_next)

    def _send(self, rid) -> None:
        if rid in self.replied:
            return
        self.send(self.rsim.lan1, self.rsim.coordinator_id, "request",
                  size=OVERHEAD + ID_BYTES + self.cfg.request_bytes, rid=rid)

    def on_message(self, msg: Msg, lan: Lan) -> None:
        if msg.kind == "reply":
            self.replied.setdefault(msg.payload["rid"], self.sched.now)


class RingAcceptor(Agent):
    """Non-coordinator ring acceptor."""

    def __init__(self, sim: "RingPaxosSim", node_id: str, group=None) -> None:
        super().__init__(sim, node_id)
        self.rsim = group if group is not None else sim
        self.cfg = self.rsim.cfg
        self.stable.setdefault("batches", {})     # instance -> (bid, rids)
        self.stable.setdefault("instance_log", {})
        self.executed: list = []
        self._executed_rids: set = set()
        self._exec_instance = 0

    def on_message(self, msg: Msg, lan: Lan) -> None:
        k, p = msg.kind, msg.payload
        if k == "phase2":                      # ip-multicast from coordinator
            self.stable["batches"][p["instance"]] = (p["bid"], p["rids"])
        elif k == "ring":
            inst = p["instance"]
            if inst in self.stable["batches"]:
                # append own decision, forward along the ring
                nxt = self.rsim.ring_next(self.node_id)
                votes = p["votes"] + (self.node_id,)
                self.send(self.rsim.lan2, nxt, "ring",
                          size=OVERHEAD + 3 * ID_BYTES + len(votes),
                          instance=inst, bid=p["bid"], votes=votes)
            # if the batch is missing the ring stalls for this instance —
            # the coordinator's ring_timeout view-change machinery recovers
        elif k == "decision":
            for inst, bid in p["entries"]:
                self.stable["instance_log"].setdefault(inst, bid)
            self._try_execute()

    def _try_execute(self) -> None:
        log = self.stable["instance_log"]
        batches = self.stable["batches"]
        while self._exec_instance in log:
            got = batches.get(self._exec_instance)
            if got is None:
                break
            for rid in got[1]:
                if rid not in self._executed_rids:
                    self._executed_rids.add(rid)
                    self.executed.append(rid)
            self._exec_instance += 1


class RingCoordinator(Agent):
    def __init__(self, sim: "RingPaxosSim", node_id: str, group=None) -> None:
        super().__init__(sim, node_id)
        self.rsim = group if group is not None else sim
        self.cfg = self.rsim.cfg
        self.stable.setdefault("batches", {})
        self.stable.setdefault("instance_log", {})
        self.pending_requests: list = []
        self.req_client: dict = {}
        self.next_instance = 0
        self.inflight: dict[int, dict] = {}     # instance -> {bid, rids, t}
        self.decision_outbox: list = []
        self.executed: list = []
        self._executed_rids: set = set()
        self._exec_instance = 0
        self._batch_timer_armed = False
        self._decision_timer_armed = False
        self.periodic(self.cfg.ring_timeout, self._check_stalls)

    def on_message(self, msg: Msg, lan: Lan) -> None:
        k, p = msg.kind, msg.payload
        if k == "request":
            rid = p["rid"]
            self.req_client[rid] = msg.src
            if rid in self._executed_rids:
                self._reply(rid)
                return
            if rid in self.pending_requests:
                return
            self.pending_requests.append(rid)
            if len(self.pending_requests) >= self.cfg.batch_size:
                self._flush_batch()
            elif not self._batch_timer_armed:
                self._batch_timer_armed = True
                self.after(self.cfg.batch_linger, self._flush_batch)
        elif k == "ring":
            # completed the ring: ids are chosen
            inst = p["instance"]
            st = self.inflight.pop(inst, None)
            if st is None:
                return
            self._decide(inst, st)

    def _flush_batch(self) -> None:
        self._batch_timer_armed = False
        if not self.pending_requests:
            return
        rids = tuple(self.pending_requests)
        self.pending_requests = []
        inst = self.next_instance
        self.next_instance += 1
        bid = (self.node_id, inst)
        self.inflight[inst] = {"bid": bid, "rids": rids, "t": self.sched.now}
        self.stable["batches"][inst] = (bid, rids)
        # phase 2: ip-multicast batch+ids to all acceptors and learners
        dsts = self.rsim.acceptor_ids_live() + self.rsim.learner_ids
        self.multicast(self.rsim.lan1, dsts, "phase2",
                       size=batch_bytes(len(rids), self.cfg.request_bytes),
                       instance=inst, bid=bid, rids=rids)
        # kick the ring at the first acceptor
        first = self.rsim.ring_next(self.node_id)
        if first == self.node_id:
            self._decide(inst, self.inflight.pop(inst))
        else:
            self.send(self.rsim.lan2, first, "ring",
                      size=OVERHEAD + 3 * ID_BYTES,
                      instance=inst, bid=bid, votes=(self.node_id,))

    def _decide(self, inst: int, st: dict) -> None:
        self.stable["instance_log"].setdefault(inst, st["bid"])
        self.decision_outbox.append((inst, st["bid"]))
        if not self._decision_timer_armed:
            self._decision_timer_armed = True
            self.after(self.cfg.decision_linger, self._flush_decisions)
        self._try_execute()
        for rid in st["rids"]:
            self._reply(rid)

    def _flush_decisions(self) -> None:
        self._decision_timer_armed = False
        if not self.decision_outbox:
            return
        entries = tuple(self.decision_outbox)
        self.decision_outbox = []
        dsts = self.rsim.acceptor_ids_live() + self.rsim.learner_ids
        self.multicast(self.rsim.lan1, dsts, "decision",
                       size=OVERHEAD + 2 * ID_BYTES * len(entries),
                       entries=entries)

    def _reply(self, rid) -> None:
        client = self.req_client.get(rid, rid[0])
        self.send(self.rsim.lan2, client, "reply",
                  size=OVERHEAD + ID_BYTES, rid=rid)

    def _try_execute(self) -> None:
        log = self.stable["instance_log"]
        batches = self.stable["batches"]
        while self._exec_instance in log:
            got = batches.get(self._exec_instance)
            if got is None:
                break
            for rid in got[1]:
                if rid not in self._executed_rids:
                    self._executed_rids.add(rid)
                    self.executed.append(rid)
            self._exec_instance += 1

    # -- view change on ring stall (acceptor failure) -------------------------

    def _check_stalls(self) -> None:
        now = self.sched.now
        stalled = [i for i, st in self.inflight.items()
                   if now - st["t"] > self.cfg.ring_timeout]
        if not stalled:
            return
        # drop dead acceptors from the ring (view change), re-run instances
        self.rsim.reform_ring()
        for inst in sorted(stalled):
            st = self.inflight[inst]
            st["t"] = now
            dsts = self.rsim.acceptor_ids_live() + self.rsim.learner_ids
            self.multicast(self.rsim.lan1, dsts, "phase2",
                           size=batch_bytes(len(st["rids"]),
                                            self.cfg.request_bytes),
                           instance=inst, bid=st["bid"], rids=st["rids"])
            first = self.rsim.ring_next(self.node_id)
            if first == self.node_id:
                self._decide(inst, self.inflight.pop(inst))
            else:
                self.send(self.rsim.lan2, first, "ring",
                          size=OVERHEAD + 3 * ID_BYTES,
                          instance=inst, bid=st["bid"],
                          votes=(self.node_id,))


class RingPaxosSim(SimBase):
    def __init__(self, cfg: RingConfig, requests_per_client: int = 1,
                 client_gap: float = 0.0, fault=None, fault2=None,
                 latency: float = 1.0) -> None:
        super().__init__(seed=cfg.seed, latency=latency,
                         fault=fault, fault2=fault2)
        self.cfg = cfg
        self.coordinator_id = "a0"
        self.acceptor_ids = [f"a{i}" for i in range(cfg.n_acceptors)]
        self.learner_ids = [f"l{i}" for i in range(cfg.n_learners)]
        self.client_ids = [f"c{i}" for i in range(cfg.n_clients)]
        self.ring: list[str] = list(self.acceptor_ids)
        self.coordinator = RingCoordinator(self, "a0")
        self.acceptors = [RingAcceptor(self, a) for a in self.acceptor_ids[1:]]
        self.learners = [RingAcceptor(self, l) for l in self.learner_ids]
        self.clients = [RingClient(self, c, n_requests=requests_per_client,
                                   gap=client_gap) for c in self.client_ids]
        self.attach_all()

    def ring_next(self, node_id: str) -> str:
        # NOTE: dead members are NOT skipped here — a crashed acceptor
        # stalls the ring until the coordinator's ring_timeout fires and
        # reform_ring() installs the new view (paper §5.5: "any failure
        # of acceptor requires a view change").
        ring = self.ring
        if node_id not in ring:
            return ring[0]
        idx = ring.index(node_id)
        return ring[(idx + 1) % len(ring)]

    def acceptor_ids_live(self) -> list[str]:
        return [a for a in self.acceptor_ids if a != self.coordinator_id]

    def reform_ring(self) -> None:
        self.ring = [a for a in self.ring if self.agents[a].alive]

    def executed_sequences(self) -> dict[str, list]:
        out = {"a0": list(self.coordinator.executed)}
        for a in self.acceptors + self.learners:
            out[a.node_id] = list(a.executed)
        return out

    def total_replied(self) -> int:
        return sum(len(c.replied) for c in self.clients)
