"""S-Paxos baseline (paper §2.6, [29] Biely et al. 2012).

All m replicas play all roles; replica 0 starts as ordering-layer leader.
Key differences from HT-Paxos that the paper's §5 analysis exploits:
  * every replica receives client requests AND every replica acks every
    batch to ALL replicas (all-to-all acknowledgements → the m² term at
    every replica, §5.1.3);
  * the leader replica also performs dissemination work;
  * a batch is *stable* after f+1 acks (f = ⌊m/2⌋);
  * the client reply is sent only after request execution (6 message
    delays vs HT-Paxos' optimistic 4-delay reply, §5.4).

Ordering rides the same ``classic.PaxosSequencer`` engine as HT-Paxos
(acceptors = all replicas), so the comparison isolates the dissemination-
layer design — exactly the paper's framing.

The port's copy of ``repro.core.spaxos`` (pure Python, as there).
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field
from typing import Optional

from .agents import Agent, SimBase
from .classic import OrderingConfig, PaxosSequencer
from .network import ID_BYTES, Lan, Msg, OVERHEAD


@dataclass
class SPaxosConfig:
    n_replicas: int = 5
    n_clients: int = 4
    request_bytes: int = 1024
    batch_size: int = 4
    batch_linger: float = 0.0
    ack_retry: float = 300.0          # "replica retransmits ack periodically"
    client_retry: float = 400.0
    seed: int = 0
    ordering: OrderingConfig = field(default_factory=OrderingConfig)


def batch_bytes(n_requests: int, request_bytes: int) -> int:
    return OVERHEAD + ID_BYTES + n_requests * (ID_BYTES + request_bytes)


class SPaxosClient(Agent):
    def __init__(self, sim: "SPaxosSim", node_id: str, n_requests: int,
                 gap: float = 0.0) -> None:
        super().__init__(sim, node_id)
        self.ssim = sim
        self.cfg = sim.cfg
        self.rng = random.Random(zlib.crc32(f"{sim.cfg.seed}:{node_id}".encode()))
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
        alive = [r for r in self.ssim.replica_ids if self.ssim.agents[r].alive]
        tgt = self.rng.choice(alive or self.ssim.replica_ids)
        self.send(self.ssim.lan1, tgt, "request",
                  size=OVERHEAD + ID_BYTES + self.cfg.request_bytes, rid=rid)

    def on_message(self, msg: Msg, lan: Lan) -> None:
        if msg.kind == "reply":
            self.replied.setdefault(msg.payload["rid"], self.sched.now)


class SPaxosReplica(PaxosSequencer):
    """Replica = disseminator + acceptor + learner (+ maybe leader)."""

    def __init__(self, sim: "SPaxosSim", node_id: str, rank: int,
                 peers: list[str], cfg: OrderingConfig,
                 initial_leader: bool = False) -> None:
        super().__init__(sim, node_id, rank, peers, cfg, initial_leader)
        self.ssim = sim
        self.scfg: SPaxosConfig = sim.cfg
        self.rng2 = random.Random(zlib.crc32(f"{sim.cfg.seed}:{node_id}:r".encode()))
        # S-Paxos sets (the paper notes S-Paxos needs four sets; HT needs two)
        self.stable.setdefault("requests", {})       # batch_id -> rids
        self.stable.setdefault("ackd", {})           # batch_id -> set(replica)
        self.stable.setdefault("stableIds", [])      # FIFO awaiting ordering
        self.stable.setdefault("stable_set", set())
        self.stable.setdefault("proposed", set())
        self.stable.setdefault("decided_ids", set())
        self.pending_requests: list[tuple] = []
        self.req_client: dict[tuple, str] = {}
        self.next_batch = 0
        self.executed: list[tuple] = []
        self._executed_rids: set = set()
        self._exec_instance = 0
        self.anomaly_dup_ordered = 0
        self._batch_timer_armed = False

    # ---- dissemination layer ------------------------------------------------

    def on_other_message(self, msg: Msg, lan: Lan) -> None:
        k, p = msg.kind, msg.payload
        if k == "request":
            rid = p["rid"]
            self.req_client[rid] = msg.src
            if rid in self._executed_rids:
                self._reply(rid)
                return
            if rid in self.pending_requests or any(
                    rid in rids for rids in self.stable["requests"].values()):
                return
            self.pending_requests.append(rid)
            if len(self.pending_requests) >= self.scfg.batch_size:
                self._flush_batch()
            elif not self._batch_timer_armed:
                self._batch_timer_armed = True
                self.after(self.scfg.batch_linger, self._flush_batch)
        elif k == "batch":
            bid, rids = p["bid"], p["rids"]
            self.stable["requests"][bid] = rids
            # all-to-all acknowledgement — the S-Paxos m² term
            self.multicast(self.ssim.lan2, self.ssim.replica_ids, "ack",
                           size=OVERHEAD + ID_BYTES, bid=bid)
        elif k == "ack":
            bid = p["bid"]
            acks = self.stable["ackd"].setdefault(bid, set())
            acks.add(msg.src)
            f = len(self.ssim.replica_ids) // 2
            if len(acks) >= f + 1 and \
                    bid not in self.stable["stable_set"] and \
                    bid not in self.stable["decided_ids"]:
                self.stable["stableIds"].append(bid)
                self.stable["stable_set"].add(bid)
                if self.is_leader:
                    self._flush_pool()
            if bid not in self.stable["requests"]:
                # "requests q for resending the corresponding batch"
                self.send(self.ssim.lan2, msg.src, "fetch",
                          size=OVERHEAD + ID_BYTES, bid=bid)
        elif k == "fetch":
            bid = p["bid"]
            rids = self.stable["requests"].get(bid)
            if rids is not None:
                self.send(self.ssim.lan1, msg.src, "batch",
                          size=batch_bytes(len(rids), self.scfg.request_bytes),
                          bid=bid, rids=rids)

    def _flush_batch(self) -> None:
        self._batch_timer_armed = False
        if not self.pending_requests:
            return
        rids = tuple(self.pending_requests)
        self.pending_requests = []
        bid = (self.node_id, self.next_batch)
        self.next_batch += 1
        self.multicast(self.ssim.lan1, self.ssim.replica_ids, "batch",
                       size=batch_bytes(len(rids), self.scfg.request_bytes),
                       bid=bid, rids=rids)

    # ---- ordering-layer hooks -------------------------------------------------

    def pool_pull(self, k: int) -> list:
        out = []
        fifo = self.stable["stableIds"]
        while fifo and len(out) < k:
            bid = fifo.pop(0)
            if bid in self.stable["decided_ids"] or \
                    bid in self.stable["proposed"]:
                continue
            self.stable["proposed"].add(bid)
            out.append(bid)
        return out

    def on_abandon(self, values: list) -> None:
        for value in values:
            for bid in value:
                if bid == "__noop__":
                    continue
                self.stable["proposed"].discard(bid)
                if bid not in self.stable["decided_ids"] and \
                        bid not in self.stable["stableIds"]:
                    self.stable["stableIds"].append(bid)

    def on_decide(self, instance: int, value) -> None:
        for bid in value:
            if bid != "__noop__":
                self.stable["decided_ids"].add(bid)
                self.stable["stable_set"].discard(bid)
                self.stable["proposed"].discard(bid)
        self._try_execute()

    def decision_targets(self) -> list[str]:
        return [p for p in self.peers if p != self.node_id]

    # ---- execution + reply (after execution — §5.4) ---------------------------

    def _try_execute(self) -> None:
        log = self.stable["decided_log"]
        rs = self.stable["requests"]
        while self._exec_instance in log:
            bids = [b for b in log[self._exec_instance] if b != "__noop__"]
            if any(b not in rs for b in bids):
                break
            for bid in bids:
                for rid in rs[bid]:
                    if rid in self._executed_rids:
                        continue
                    self._executed_rids.add(rid)
                    self.executed.append(rid)
                    if rid in self.req_client:
                        self._reply(rid)
            self._exec_instance += 1

    def _reply(self, rid) -> None:
        client = self.req_client.get(rid, rid[0])
        self.send(self.ssim.lan2, client, "reply",
                  size=OVERHEAD + ID_BYTES, rid=rid)


class SPaxosSim(SimBase):
    def __init__(self, cfg: SPaxosConfig, requests_per_client: int = 1,
                 client_gap: float = 0.0, fault=None, fault2=None,
                 latency: float = 1.0) -> None:
        super().__init__(seed=cfg.seed, latency=latency,
                         fault=fault, fault2=fault2)
        self.cfg = cfg
        self.replica_ids = [f"r{i}" for i in range(cfg.n_replicas)]
        self.client_ids = [f"c{i}" for i in range(cfg.n_clients)]
        self.replicas = [
            SPaxosReplica(self, r, rank=i, peers=self.replica_ids,
                          cfg=cfg.ordering, initial_leader=(i == 0))
            for i, r in enumerate(self.replica_ids)]
        self.clients = [
            SPaxosClient(self, c, n_requests=requests_per_client,
                         gap=client_gap) for c in self.client_ids]
        self.attach_all()
        for r in self.replicas:
            r.start()

    @property
    def leader(self) -> Optional[SPaxosReplica]:
        for r in self.replicas:
            if r.is_leader and r.alive:
                return r
        return None

    def executed_sequences(self) -> dict[str, list]:
        return {r.node_id: list(r.executed) for r in self.replicas}

    def total_replied(self) -> int:
        return sum(len(c.replied) for c in self.clients)
