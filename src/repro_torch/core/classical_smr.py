"""Standalone classical Paxos SMR baseline (paper §2.1 + §5.1.4).

The leader receives every client request, batches them, and runs the
message-optimized MultiPaxos engine over the *full request payloads* (no
id/payload split — that is precisely the §5.2/Fig-4 "extremely large amount
of data at the leader" the high-throughput variants avoid).

Acceptors double as learners: the decision message carries the payloads, so
every acceptor can execute.

The port's copy of ``repro.core.classical_smr`` (pure Python, as there).
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
class ClassicalConfig:
    n_acceptors: int = 5
    n_clients: int = 4
    request_bytes: int = 1024
    batch_size: int = 4
    batch_linger: float = 0.0
    client_retry: float = 400.0
    seed: int = 0
    ordering: OrderingConfig = field(default_factory=OrderingConfig)

    def __post_init__(self) -> None:
        # value = tuple of (rid, payload_size) — size: ids + full payloads
        self.ordering.value_size = lambda v: sum(
            ID_BYTES + self.request_bytes for _ in v) \
            if isinstance(v, (list, tuple)) else ID_BYTES


class ClassicalClient(Agent):
    def __init__(self, sim: "ClassicalSim", node_id: str, n_requests: int,
                 gap: float = 0.0) -> None:
        super().__init__(sim, node_id)
        self.csim = sim
        self.cfg = sim.cfg
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
        ldr = self.csim.leader_id()
        self.send(self.csim.lan1, ldr, "request",
                  size=OVERHEAD + ID_BYTES + self.cfg.request_bytes, rid=rid)

    def on_message(self, msg: Msg, lan: Lan) -> None:
        if msg.kind == "reply":
            self.replied.setdefault(msg.payload["rid"], self.sched.now)


class ClassicalAcceptor(PaxosSequencer):
    """Acceptor + learner (+ client intake & batching when leader)."""

    def __init__(self, sim: "ClassicalSim", node_id: str, rank: int,
                 peers: list[str], cfg: OrderingConfig,
                 initial_leader: bool = False) -> None:
        super().__init__(sim, node_id, rank, peers, cfg, initial_leader)
        self.csim = sim
        self.ccfg: ClassicalConfig = sim.cfg
        self.pending_requests: list = []
        self.req_client: dict = {}
        self.executed: list = []
        self._executed_rids: set = set()
        self._exec_instance = 0
        self._batch_timer_armed = False
        self._seen_rids: set = set()

    def on_other_message(self, msg: Msg, lan: Lan) -> None:
        if msg.kind != "request":
            return
        rid = msg.payload["rid"]
        self.req_client[rid] = msg.src
        if rid in self._executed_rids:
            self._reply(rid)
            return
        if rid in self._seen_rids:
            return
        self._seen_rids.add(rid)
        self.pending_requests.append(rid)
        if len(self.pending_requests) >= self.ccfg.batch_size:
            self._flush_batch()
        elif not self._batch_timer_armed:
            self._batch_timer_armed = True
            self.after(self.ccfg.batch_linger, self._flush_batch)

    def _flush_batch(self) -> None:
        self._batch_timer_armed = False
        if not self.pending_requests or not self.is_leader:
            return
        # value carries the full requests — classical Paxos orders payloads
        self._pending_batches = getattr(self, "_pending_batches", [])
        self._pending_batches.append(tuple(self.pending_requests))
        self.pending_requests = []
        self._flush_pool()

    def pool_pull(self, k: int) -> list:
        batches = getattr(self, "_pending_batches", [])
        out: list = []
        while batches and len(out) < k:
            out.extend(batches.pop(0))
        return out

    def on_decide(self, instance: int, value) -> None:
        self._try_execute()

    def _try_execute(self) -> None:
        log = self.stable["decided_log"]
        while self._exec_instance in log:
            for rid in log[self._exec_instance]:
                if rid == "__noop__" or rid in self._executed_rids:
                    continue
                self._executed_rids.add(rid)
                self.executed.append(rid)
                if rid in self.req_client:
                    self._reply(rid)
            self._exec_instance += 1

    def _decide_local(self, instance: int, value) -> None:
        super()._decide_local(instance, value)
        self._try_execute()

    def _reply(self, rid) -> None:
        client = self.req_client.get(rid, rid[0])
        self.send(self.csim.lan2, client, "reply",
                  size=OVERHEAD + ID_BYTES, rid=rid)


class ClassicalSim(SimBase):
    def __init__(self, cfg: ClassicalConfig, requests_per_client: int = 1,
                 client_gap: float = 0.0, fault=None, fault2=None,
                 latency: float = 1.0) -> None:
        super().__init__(seed=cfg.seed, latency=latency,
                         fault=fault, fault2=fault2)
        self.cfg = cfg
        self.acceptor_ids = [f"a{i}" for i in range(cfg.n_acceptors)]
        self.client_ids = [f"c{i}" for i in range(cfg.n_clients)]
        self.acceptors = [
            ClassicalAcceptor(self, a, rank=i, peers=self.acceptor_ids,
                              cfg=cfg.ordering, initial_leader=(i == 0))
            for i, a in enumerate(self.acceptor_ids)]
        self.clients = [
            ClassicalClient(self, c, n_requests=requests_per_client,
                            gap=client_gap) for c in self.client_ids]
        self.attach_all()
        for a in self.acceptors:
            a.start()

    def leader_id(self) -> str:
        for a in self.acceptors:
            if a.is_leader and a.alive:
                return a.node_id
        return self.acceptor_ids[0]

    def executed_sequences(self) -> dict[str, list]:
        return {a.node_id: list(a.executed) for a in self.acceptors}

    def total_replied(self) -> int:
        return sum(len(c.replied) for c in self.clients)
