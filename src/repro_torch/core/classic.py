"""Classical (Multi-)Paxos — the ordering layer (paper §2.1 / §4.1.3).

Implements the message-optimized variant the paper assumes (§2.1.1):
  * phase 1 is skipped while the leader is stable (MultiPaxos);
  * phase 2b goes to the leader only; the leader broadcasts decisions;
  * the ordering layer batches: one Paxos instance decides a *list* of
    batch_ids (§4.2 "the ordering layer ... can use the traditional
    optimizations of batching and pipelining").

The same engine backs
  * the ordering layer of HT-Paxos (values = tuples of batch_ids, 4 B each),
  * the ordering layer of S-Paxos, and
  * the standalone classical-Paxos baseline (values = whole request batches),
so the §5 comparisons run on identical consensus machinery.

Correctness-critical rules implemented exactly:
  * ballots from disjoint sets: ballot = round * MAX_NODES + rank;
  * acceptor records promises/accepts in stable storage before replying;
  * a new leader re-proposes every value learned from phase-1b responses and
    *must decide all of them before proposing anything new* (paper §4.1.3:
    "New leader always make it sure that before proposing new request_id
    from stable_ids, all the request_ids received in phase 1b messages must
    be decided"); gaps below the recovery horizon are filled with no-ops;
  * a duplicate id is never decided twice by the ordering layer even across
    leader failover (dedup against the decided log — the paper's claim that
    HT-Paxos needs no ``proposed``/``reproposed`` sets).

The port's copy of ``repro.core.classic`` (pure Python, as there).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from .agents import Agent, SimBase
from .network import ID_BYTES, Lan, Msg, OVERHEAD

MAX_NODES = 1024
NOOP = ("__noop__",)


def ballot_of(rnd: int, rank: int) -> int:
    return rnd * MAX_NODES + rank


@dataclass
class OrderingConfig:
    pipeline_depth: int = 8          # max in-flight instances (pipelining)
    order_batch_max: int = 64        # max ids per instance value (batching)
    flush_interval: float = 1.0      # how often the leader drains its pool
    retry_interval: float = 50.0     # re-send 2a for undecided instances
    heartbeat_interval: float = 10.0
    election_timeout: float = 60.0
    # value payload size in bytes (ids are 4 B in HT/S-Paxos; whole batches
    # for standalone classical Paxos) — callable so protocols can size values
    value_size: Callable[[Any], int] = lambda v: ID_BYTES * (len(v) if isinstance(v, (list, tuple)) else 1)


class PaxosSequencer(Agent):
    """A sequencer: always an acceptor, possibly the proposer/leader.

    Subclass hooks:
      * ``pool_pull(k)``   -> list of up to k values to propose (leader only)
      * ``on_decide(instance, value)`` local decision callback
      * ``decision_targets()`` -> node ids to multicast decisions to
    """

    def __init__(self, sim: SimBase, node_id: str, rank: int,
                 peers: list[str], cfg: OrderingConfig,
                 initial_leader: bool = False) -> None:
        super().__init__(sim, node_id)
        self.rank = rank
        self.peers = peers                      # all sequencer ids, incl. self
        self.cfg = cfg
        self.lan: Lan = sim.lan2                # ordering layer rides LAN-2
        # --- acceptor state (stable storage, survives crashes) ---
        self.stable.setdefault("promised", -1)
        self.stable.setdefault("accepted", {})    # instance -> (ballot, value)
        self.stable.setdefault("decided_log", {})  # instance -> value
        # --- proposer state (volatile; rebuilt on election) ---
        self.is_leader = initial_leader
        self.ballot = ballot_of(0, rank) if initial_leader else -1
        self.next_instance = 0
        self.inflight: dict[int, dict] = {}       # instance -> {value, acks}
        self.recovery_pending: set[int] = set()
        self.promises: dict[str, dict] = {}
        self.candidate_ballot = -1
        self.last_leader_sign = 0.0
        self._decision_outbox: list[tuple[int, Any]] = []
        self._started = False

    # ---- hooks --------------------------------------------------------------

    def pool_pull(self, k: int) -> list:
        return []

    def on_decide(self, instance: int, value) -> None:
        pass

    def decision_targets(self) -> list[str]:
        return [p for p in self.peers if p != self.node_id]

    # ---- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._started = True
        if self.is_leader:
            self.next_instance = self._first_gap()
            self.periodic(self.cfg.flush_interval, self._flush_pool)
            self.periodic(self.cfg.retry_interval, self._retry_inflight)
            self.periodic(self.cfg.heartbeat_interval, self._heartbeat)
        self.periodic(self.cfg.election_timeout, self._check_leader,
                      stop=lambda: False)

    def on_restart(self) -> None:
        # stable storage (promised/accepted/decided_log) already present
        self.is_leader = False
        self.inflight.clear()
        self.recovery_pending.clear()
        self.promises.clear()
        self.last_leader_sign = self.sched.now
        self.start()

    # ---- helpers ------------------------------------------------------------

    def _first_gap(self) -> int:
        d = self.stable["decided_log"]
        i = 0
        while i in d:
            i += 1
        return i

    def _alive_quorum(self) -> int:
        return len(self.peers) // 2 + 1

    def decided_value(self, instance: int):
        return self.stable["decided_log"].get(instance)

    def already_ordered(self, vid) -> bool:
        for v in self.stable["decided_log"].values():
            if isinstance(v, (list, tuple)) and vid in v:
                return True
        return False

    # ---- leader: proposing --------------------------------------------------

    def _flush_pool(self) -> None:
        if not self.is_leader or self.recovery_pending:
            return
        while len(self.inflight) < self.cfg.pipeline_depth:
            vals = self.pool_pull(self.cfg.order_batch_max)
            if not vals:
                break
            self._propose(self.next_instance, tuple(vals))
            self.next_instance += 1

    def _propose(self, instance: int, value) -> None:
        self.inflight[instance] = {"value": value, "acks": {self.node_id}}
        # leader self-accepts locally (it is an acceptor): stable write first
        self.stable["accepted"][instance] = (self.ballot, value)
        self._send_2a(instance, value)
        self._maybe_decide(instance)

    def _send_2a(self, instance: int, value) -> None:
        others = [p for p in self.peers if p != self.node_id]
        size = OVERHEAD + 2 * ID_BYTES + self.cfg.value_size(value)
        self.multicast(self.lan, others, "p2a", size=size,
                       ballot=self.ballot, instance=instance, value=value)

    def _retry_inflight(self) -> None:
        if not self.is_leader:
            return
        for i, st in list(self.inflight.items()):
            self._send_2a(i, st["value"])

    def _heartbeat(self) -> None:
        if not self.is_leader:
            return
        others = [p for p in self.peers if p != self.node_id]
        self.multicast(self.lan, others, "hb", size=OVERHEAD,
                       ballot=self.ballot)

    def _maybe_decide(self, instance: int) -> None:
        st = self.inflight.get(instance)
        if st is None:
            return
        if len(st["acks"]) >= self._alive_quorum():
            value = st["value"]
            del self.inflight[instance]
            self._decide_local(instance, value)
            self.recovery_pending.discard(instance)
            self._decision_outbox.append((instance, value))
            if not self.recovery_pending:
                self._flush_decisions()
                self._flush_pool()

    def _flush_decisions(self) -> None:
        if not self._decision_outbox:
            return
        batch = self._decision_outbox
        self._decision_outbox = []
        total_ids = sum(self.cfg.value_size(v) for _, v in batch)
        size = OVERHEAD + 2 * ID_BYTES * len(batch) + total_ids
        self.multicast(self.lan, self.decision_targets(), "decision",
                       size=size, entries=tuple(batch))

    def _decide_local(self, instance: int, value) -> None:
        log = self.stable["decided_log"]
        if instance not in log:
            log[instance] = value
            self.on_decide(instance, value)

    # ---- elections ----------------------------------------------------------

    def _check_leader(self) -> None:
        if self.is_leader or not self._started:
            return
        if self.sched.now - self.last_leader_sign > self.cfg.election_timeout:
            self._start_election()

    def _start_election(self) -> None:
        rnd = self.stable["promised"] // MAX_NODES + 1
        self.candidate_ballot = ballot_of(rnd, self.rank)
        self.promises = {}
        low = self._first_gap()
        # promise to self
        self.stable["promised"] = self.candidate_ballot
        self.promises[self.node_id] = {
            i: ba for i, ba in self.stable["accepted"].items() if i >= low}
        others = [p for p in self.peers if p != self.node_id]
        self.multicast(self.lan, others, "p1a",
                       size=OVERHEAD + 2 * ID_BYTES,
                       ballot=self.candidate_ballot, low=low)
        self._maybe_win()

    def _maybe_win(self) -> None:
        if self.candidate_ballot < 0:
            return
        if len(self.promises) < self._alive_quorum():
            return
        # won: adopt highest-ballot accepted value per instance
        self.is_leader = True
        self.ballot = self.candidate_ballot
        self.candidate_ballot = -1
        self.last_leader_sign = self.sched.now
        best: dict[int, tuple[int, Any]] = {}
        for amap in self.promises.values():
            for i, (b, v) in amap.items():
                if i not in best or b > best[i][0]:
                    best[i] = (b, v)
        self.promises = {}
        self.inflight.clear()
        self.recovery_pending.clear()
        decided = self.stable["decided_log"]
        horizon = max(best.keys(), default=-1)
        self.next_instance = max(self._first_gap(), horizon + 1)
        # paper §4.1.3: decide all phase-1b values before proposing new ones
        for i in range(self.next_instance):
            if i in decided:
                continue
            value = best.get(i, (None, NOOP))[1]
            self.recovery_pending.add(i)
            self._propose(i, value)
        if not self.recovery_pending:
            self._flush_pool()
        self.periodic(self.cfg.flush_interval, self._flush_pool,
                      stop=lambda: not self.is_leader)
        self.periodic(self.cfg.retry_interval, self._retry_inflight,
                      stop=lambda: not self.is_leader)
        self.periodic(self.cfg.heartbeat_interval, self._heartbeat,
                      stop=lambda: not self.is_leader)

    def _step_down(self, higher_ballot: int) -> None:
        self.is_leader = False
        self.candidate_ballot = -1
        abandoned = [st["value"] for st in self.inflight.values()]
        self.inflight.clear()
        self.recovery_pending.clear()
        self.last_leader_sign = self.sched.now
        if abandoned:
            self.on_abandon(abandoned)

    def on_abandon(self, values: list) -> None:
        """Hook: in-flight values lost to a step-down. Subclasses may
        re-enqueue them into their proposal pool."""

    # ---- message handling -----------------------------------------------------

    def on_message(self, msg: Msg, lan: Lan) -> None:
        k, p = msg.kind, msg.payload
        if k == "p1a":
            self.last_leader_sign = self.sched.now
            if p["ballot"] > self.stable["promised"]:
                self.stable["promised"] = p["ballot"]
                if self.is_leader or self.candidate_ballot >= 0:
                    self._step_down(p["ballot"])
                accepted = {i: ba for i, ba in self.stable["accepted"].items()
                            if i >= p["low"]}
                nvals = sum(len(v) if isinstance(v, (list, tuple)) else 1
                            for (_b, v) in accepted.values())
                self.send(lan, msg.src, "p1b",
                          size=OVERHEAD + 2 * ID_BYTES + ID_BYTES * nvals,
                          ballot=p["ballot"], accepted=dict(accepted))
            else:
                self.send(lan, msg.src, "nack", size=OVERHEAD + ID_BYTES,
                          promised=self.stable["promised"])
        elif k == "p1b":
            if p["ballot"] == self.candidate_ballot:
                self.promises[msg.src] = p["accepted"]
                self._maybe_win()
        elif k == "p2a":
            self.last_leader_sign = self.sched.now
            if p["ballot"] >= self.stable["promised"]:
                self.stable["promised"] = p["ballot"]
                if (self.is_leader or self.candidate_ballot >= 0) and \
                        p["ballot"] > self.ballot:
                    self._step_down(p["ballot"])
                self.stable["accepted"][p["instance"]] = (p["ballot"], p["value"])
                self.send(lan, msg.src, "p2b", size=OVERHEAD + 2 * ID_BYTES,
                          ballot=p["ballot"], instance=p["instance"])
            else:
                self.send(lan, msg.src, "nack", size=OVERHEAD + ID_BYTES,
                          promised=self.stable["promised"])
        elif k == "p2b":
            if self.is_leader and p["ballot"] == self.ballot:
                st = self.inflight.get(p["instance"])
                if st is not None:
                    st["acks"].add(msg.src)
                    self._maybe_decide(p["instance"])
        elif k == "nack":
            if p["promised"] > max(self.ballot, self.candidate_ballot):
                if self.is_leader or self.candidate_ballot >= 0:
                    self._step_down(p["promised"])
        elif k == "hb":
            self.last_leader_sign = self.sched.now
            if self.is_leader and p["ballot"] > self.ballot:
                self._step_down(p["ballot"])
        elif k == "decision":
            self.last_leader_sign = self.sched.now
            for (i, v) in p["entries"]:
                self._decide_local(i, v)
        elif k == "learn_req":
            # catch-up pull: reply with decided entries >= from
            ent = tuple((i, v) for i, v in
                        sorted(self.stable["decided_log"].items())
                        if i >= p["from"])
            if ent:
                nbytes = sum(self.cfg.value_size(v) for _, v in ent)
                self.send(lan, msg.src, "decision",
                          size=OVERHEAD + 2 * ID_BYTES * len(ent) + nbytes,
                          entries=ent)
        else:
            self.on_other_message(msg, lan)

    def on_other_message(self, msg: Msg, lan: Lan) -> None:  # pragma: no cover
        pass
