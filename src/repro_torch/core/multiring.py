"""Multi-Ring Paxos baseline (paper §2.5, [27] Marandi et al. DSN'12).

State partitioning: P logical partitions, each running an independent Ring
Paxos instance (its own coordinator + acceptor ring). Clients are assigned
to partitions; learners subscribe to one or more partitions and merge
decisions with a *deterministic round-robin* procedure — consume the next
decided instance from ring 0, then ring 1, ..., blocking on a lagging ring
(the determinism is what makes cross-partition learners consistent).

Throughput scales with P because each coordinator carries only n/P request
traffic — the paper's point that HT-Paxos can adopt the same state
partitioning on its dissemination layer (§5.5).

The port's copy of ``repro.core.multiring`` (pure Python, as there).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from .agents import Agent, SimBase
from .network import Lan, Msg
from .ring import (RingAcceptor, RingClient, RingConfig, RingCoordinator,
                   batch_bytes)


@dataclass
class MultiRingConfig:
    n_partitions: int = 2
    ring: RingConfig = field(default_factory=RingConfig)
    n_merge_learners: int = 1        # learners subscribed to ALL partitions


class RingGroup:
    """Duck-typed 'sim view' handed to ring agents of one partition."""

    def __init__(self, sim: "MultiRingSim", pidx: int, cfg: RingConfig)\
            -> None:
        self.sim = sim
        self.pidx = pidx
        self.cfg = cfg
        self.coordinator_id = f"p{pidx}a0"
        self.acceptor_ids = [f"p{pidx}a{i}" for i in range(cfg.n_acceptors)]
        self.learner_ids = [f"p{pidx}l{i}" for i in range(cfg.n_learners)]
        self.ring = list(self.acceptor_ids)

    # interface used by ring agents
    @property
    def lan1(self) -> Lan:
        return self.sim.lan1

    @property
    def lan2(self) -> Lan:
        return self.sim.lan2

    @property
    def agents(self):
        return self.sim.agents

    def ring_next(self, node_id: str) -> str:
        ring = self.ring           # stall-then-view-change (see ring.py)
        if node_id not in ring:
            return ring[0]
        return ring[(ring.index(node_id) + 1) % len(ring)]

    def acceptor_ids_live(self) -> list[str]:
        return [a for a in self.acceptor_ids if a != self.coordinator_id]

    def reform_ring(self) -> None:
        self.ring = [a for a in self.ring if self.sim.agents[a].alive]


class MergeLearner(Agent):
    """Learner subscribed to every partition; deterministic merge."""

    def __init__(self, sim: "MultiRingSim", node_id: str) -> None:
        super().__init__(sim, node_id)
        self.msim = sim
        self.P = sim.cfg.n_partitions
        # per-ring decided log + payloads
        self.logs = [dict() for _ in range(self.P)]
        self.batches = [dict() for _ in range(self.P)]
        self.cursors = [0] * self.P
        self.merge_ring = 0
        self.executed: list = []
        self._executed_rids: set = set()

    def on_message(self, msg: Msg, lan: Lan) -> None:
        k, p = msg.kind, msg.payload
        pidx = self.msim.partition_of(msg.src)
        if pidx is None:
            return
        if k == "phase2":
            self.batches[pidx][p["instance"]] = (p["bid"], p["rids"])
            self._merge()
        elif k == "decision":
            for inst, bid in p["entries"]:
                self.logs[pidx].setdefault(inst, bid)
            self._merge()

    def _merge(self) -> None:
        # round-robin: execute next instance of ring r, then advance.
        # Blocks (deterministically) while ring r's next instance is absent
        # but that ring's coordinator has decided something newer elsewhere?
        # — no: strict round-robin requires the next instance in sequence.
        progressed = True
        while progressed:
            progressed = False
            r = self.merge_ring
            inst = self.cursors[r]
            if inst in self.logs[r] and inst in self.batches[r]:
                for rid in self.batches[r][inst][1]:
                    if rid not in self._executed_rids:
                        self._executed_rids.add(rid)
                        self.executed.append(rid)
                self.cursors[r] += 1
                self.merge_ring = (r + 1) % self.P
                progressed = True
            # skip-token equivalent: if a ring is idle (coordinator has no
            # undecided inflight work and nothing pending), rotate past it so
            # one idle partition does not stall the merge forever.
            elif self.msim.ring_idle(r, inst):
                self.merge_ring = (r + 1) % self.P
                progressed = self.merge_ring != r and \
                    any(self.cursors[q] in self.logs[q] and
                        self.cursors[q] in self.batches[q]
                        for q in range(self.P))


class MultiRingSim(SimBase):
    def __init__(self, cfg: MultiRingConfig, requests_per_client: int = 1,
                 client_gap: float = 0.0, fault=None, fault2=None,
                 latency: float = 1.0) -> None:
        super().__init__(seed=cfg.ring.seed, latency=latency,
                         fault=fault, fault2=fault2)
        self.cfg = cfg
        self.groups: list[RingGroup] = []
        self.coordinators: list[RingCoordinator] = []
        self.acceptors: list[RingAcceptor] = []
        self.clients: list[RingClient] = []
        self._node_partition: dict[str, int] = {}
        for pidx in range(cfg.n_partitions):
            rcfg = replace(cfg.ring, seed=cfg.ring.seed + pidx)
            grp = RingGroup(self, pidx, rcfg)
            self.groups.append(grp)
            coord = RingCoordinator(self, grp.coordinator_id, group=grp)
            self.coordinators.append(coord)
            self._node_partition[coord.node_id] = pidx
            for a in grp.acceptor_ids[1:]:
                acc = RingAcceptor(self, a, group=grp)
                self.acceptors.append(acc)
                self._node_partition[a] = pidx
            for i in range(rcfg.n_clients):
                cid = f"p{pidx}c{i}"
                cl = RingClient(self, cid, n_requests=requests_per_client,
                                gap=client_gap, group=grp)
                self.clients.append(cl)
        # merge learners subscribe to every partition's multicast groups:
        # register them in every group's learner list
        self.merge_learners = []
        for i in range(cfg.n_merge_learners):
            ml = MergeLearner(self, f"ml{i}")
            self.merge_learners.append(ml)
            for grp in self.groups:
                grp.learner_ids.append(ml.node_id)
        self.attach_all()

    def partition_of(self, node_id: str) -> Optional[int]:
        return self._node_partition.get(node_id)

    def ring_idle(self, pidx: int, next_inst: int) -> bool:
        coord = self.coordinators[pidx]
        return (not coord.inflight and not coord.pending_requests
                and coord.next_instance <= next_inst)

    def total_replied(self) -> int:
        return sum(len(c.replied) for c in self.clients)

    def merged_sequences(self) -> dict[str, list]:
        return {ml.node_id: list(ml.executed) for ml in self.merge_learners}
