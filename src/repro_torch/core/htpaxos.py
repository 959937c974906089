"""HT-Paxos (paper §4) — executable implementation of Algorithm 1. The
port's copy of ``repro.core.htpaxos`` (pure Python, as there).

Agent taxonomy (§3): proposers (clients), disseminators, sequencers,
learners. Disseminator nodes co-host a learner (§3: "Any computing node that
has a disseminator will also have a learner and in such nodes, both agents
can share all incoming messages and data structures") — we implement the
pair as one ``DissNode`` agent sharing ``requests_set``/``decided``.
Standalone learner nodes are ``LearnerNode``. Sequencers run the ordering
layer (classical Paxos on ids, ``classic.PaxosSequencer``).

Algorithm-1 step numbers appear as ``# [step N]`` comments.

Batching (§4.2): client requests are grouped into batches at each
disseminator; the protocol then runs on ``batch_id``s. The id-multicast to
sequencers (step 18) is itself batched — one LAN-2 multicast carries every
id queued since the last flush, which is what makes the leader's incoming
message count ``m`` per unit time (§5.1.1.2) rather than ``m²``.

The FT variant (§4.2 "all disseminator sites also have a sequencer") is
modeled by the ``site_map`` accounting: traffic of co-located agents is
summed per site (the paper's Figs 3/7 busiest-*site* numbers).

Multi-group ordering (``n_groups > 1``, Multi-Ring-style — see
``repro_torch.engine``): the ordering layer is sharded across independent
sequencer groups; each batch_id is owned by the group
``engine.router.route_id`` hashes it to, disseminators id-multicast only
to the owning group, and every learner merges the per-group decision logs
with a *strict deterministic round-robin* over per-group instance cursors.
Idle group leaders fill their logs with explicit no-op (skip) instances so
a slow group cannot stall the merged log unboundedly — the skips are
decided in-band, which is what keeps the merge identical at every learner.

Dynamic group membership (``reconfig_schedule``, §5.5's elasticity claim —
see ``repro_torch.engine.epochs`` for the engine twin): ``n_groups`` is the
*physical* group count; an :class:`repro_torch.engine.epochs.EpochTable` names
the rows active per epoch. A scheduled reconfiguration is an admin
control-plane event: it bumps every disseminator's routing epoch and has
each group's leader decide an in-band ``__reconfig_<e>__`` marker, the
DES twin of the engine's RECONFIG merge-log row. Ownership is
**drain-then-switch**: each batch's routing epoch is pinned at batch
origin and travels with the batch message, so in-flight old-epoch ids
keep draining to their old owner groups while new batches route by the
new assignment — no view change, no id is ever ordered by two groups.
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field
from typing import Optional

from .agents import Agent, SimBase
from .classic import NOOP, OrderingConfig, PaxosSequencer
from .network import ID_BYTES, Lan, Msg, OVERHEAD, batch_bytes
from ..dissem.batcher import BatchAccumulator, EMPTY_BATCH_BYTES
from ..engine.epochs import EpochTable, route_id_epoch
from ..engine.router import partition_ids


def is_control_bid(bid) -> bool:
    """True for in-band control values that hold an ordering instance but
    never execute: the ``__noop__`` skip and ``__reconfig_<e>__`` epoch
    markers. Control bids have no payload batch and are dropped from every
    learner-facing order (the DES twin of the engine's SKIP/RECONFIG
    tokens)."""
    return isinstance(bid, str) and bid.startswith("__")


def reconfig_bid(epoch: int) -> str:
    """The in-band epoch-boundary marker decided by every group at a
    membership switch."""
    return f"__reconfig_{epoch}__"


@dataclass
class HTConfig:
    n_diss: int = 5                 # n disseminators (paper's m in §5)
    n_seq: int = 3                  # s sequencers
    n_learners: int = 0             # standalone learner nodes
    n_clients: int = 4
    request_bytes: int = 1024       # q, payload size (§5.2 uses 1024 / 512)
    batch_size: int = 4             # requests per batch (n/m in §5)
    batch_linger: float = 0.0       # 0 → flush same-instant arrivals together
    id_linger: float = 0.0
    # Δ timers (Algorithm 1). Large defaults so failure-free runs never fire.
    d1_client_retry: float = 400.0
    d2_id_rebroadcast: float = 300.0
    d3_reply_retry: float = 300.0
    d4_missing_after: float = 60.0
    d5_resend_retry: float = 80.0
    d6_learner_pull: float = 80.0
    random_client_target: bool = True   # False → deterministic round-robin
    seed: int = 0
    ordering: OrderingConfig = field(default_factory=OrderingConfig)
    # FT variant (§4.2): sequencer co-located on every disseminator site
    fault_tolerant_colocation: bool = False
    # multi-group sharded ordering (repro_torch.engine): G independent sequencer
    # groups of n_seq each; 1 = the paper's single group (exact seed path)
    n_groups: int = 1
    # idle leaders decide explicit no-op (skip) instances at this period so
    # a quiet group cannot stall the learners' round-robin merge
    group_skip_interval: float = 4.0
    # dynamic membership (engine.epochs twin). initial_active names the
    # group rows active in epoch 0 (None → all n_groups rows, the exact
    # static-membership seed path). reconfig_schedule is a tuple of
    # (time, active_rows) pairs: at each time an admin event switches the
    # routing epoch to the given row set and every group leader decides an
    # in-band __reconfig__ marker. Rows must all be < n_groups — physical
    # groups are never created or destroyed mid-run, only (de)activated.
    initial_active: Optional[tuple] = None
    reconfig_schedule: tuple = ()
    # closed-pipeline workload injection: (time, client_idx, payload_bytes)
    # triples. When non-empty, clients issue exactly these requests at
    # exactly these times (the self-driven n_requests loop is disabled) —
    # the DES side of the closed-pipeline cross-validation replays the
    # same pre-drawn Workload the pipeline consumed
    # (repro_torch.pipeline.workload.Workload.schedule()).
    workload_schedule: tuple = ()
    # byte-budget batching (§4.1 step 13): when set, disseminators batch
    # by wire bytes through dissem.batcher.BatchAccumulator instead of by
    # count (batch_size is then ignored); per-request payload sizes ride
    # the request messages, so batches carry their true wire size.
    batch_budget_bytes: Optional[int] = None


class ClientNode(Agent):
    """[steps 1–11]"""

    def __init__(self, sim: "HTPaxosSim", node_id: str, n_requests: int,
                 start_t: float = 0.0, gap: float = 0.0) -> None:
        super().__init__(sim, node_id)
        self.hsim = sim
        self.cfg = sim.cfg
        self.rng = random.Random(zlib.crc32(f"{sim.cfg.seed}:{node_id}".encode()))
        self.n_requests = n_requests
        self.gap = gap
        self.next_seq = 0
        self.pending: dict[tuple, float] = {}     # rid -> send time
        self.replied: dict[tuple, float] = {}     # rid -> reply time
        self.req_size: dict[tuple, int] = {}      # rid -> payload override
        self._fixed_diss = sim.diss_ids[
            int(node_id[1:]) % len(sim.diss_ids)] if sim.diss_ids else None
        self.after(start_t if start_t > 0 else 0.0, self._issue_next) \
            if n_requests else None

    def _pick_diss(self) -> str:
        alive = [d for d in self.hsim.diss_ids
                 if self.hsim.agents[d].alive]
        if not alive:
            alive = self.hsim.diss_ids
        if self.cfg.random_client_target:
            return self.rng.choice(alive)        # [step 3]
        return self._fixed_diss if self._fixed_diss in alive else alive[0]

    def _issue_next(self) -> None:
        if self.next_seq >= self.n_requests:
            return
        self.inject_request()
        if self.next_seq < self.n_requests:
            self.after(self.gap, self._issue_next)

    def inject_request(self, size: Optional[int] = None) -> None:
        """[steps 1–6] Issue one request now, with an optional per-request
        payload size override — the workload_schedule entry point (the DES
        twin of one Workload cell). Shares the self-driven loop's retry
        machinery, so Δ1 semantics are identical either way."""
        rid = (self.node_id, self.next_seq)
        self.next_seq += 1
        if size is not None:
            self.req_size[rid] = int(size)
        self.pending[rid] = self.sched.now
        self._send_request(rid)
        self.periodic(self.cfg.d1_client_retry,                 # [steps 5–6]
                      lambda rid=rid: self._send_request(rid),
                      stop=lambda rid=rid: rid in self.replied)

    def _send_request(self, rid) -> None:
        if rid in self.replied:
            return
        d = self._pick_diss()
        q = self.req_size.get(rid, self.cfg.request_bytes)
        self.send(self.hsim.lan1, d, "request",                 # [step 4]
                  size=OVERHEAD + ID_BYTES + q,
                  rid=rid, req_bytes=q)

    def on_message(self, msg: Msg, lan: Lan) -> None:
        if msg.kind == "reply":                                  # [step 7]
            rid = msg.payload["rid"]
            if rid not in self.replied:
                self.replied[rid] = self.sched.now
            self.send(self.hsim.lan2, msg.src, "client_ack",     # [step 8]
                      size=OVERHEAD + ID_BYTES, rid=rid)


class MergedExecutionMixin:
    """Learner-side execution over per-group decision logs: strict
    deterministic round-robin — consume the next instance of group r, then
    advance to group r+1, ... — blocking until group r's next instance is
    decided (idle groups decide explicit no-op skips, so the merge never
    stalls unboundedly). G=1 degenerates to the paper's single sequential
    cursor. Shared by DissNode's co-located learner and LearnerNode so the
    two node types can never diverge on merge semantics."""

    def _init_merged_exec(self, n_groups: int) -> None:
        self._exec_cursor = [0] * n_groups
        self._merge_ring = 0
        self.executed: list[tuple] = []              # rid execution order
        self.executed_bid_order: list[tuple] = []    # merged bid order
        self._executed_bids: set = set()
        self._executed_rids: set = set()

    def _try_execute(self) -> None:
        log = self.stable["instance_log"]
        rs = self.stable["requests_set"]
        G = self.hsim.cfg.n_groups
        while True:
            g = self._merge_ring
            key = (g, self._exec_cursor[g])
            if key not in log:
                break
            bids = [b for b in log[key] if not is_control_bid(b)]
            if any(b not in rs for b in bids):
                break  # wait for payload pull (Δ4/Δ5 machinery)
            for bid in bids:
                if bid in self._executed_bids:
                    self.anomaly_dup_ordered += 1
                    continue
                self._executed_bids.add(bid)
                self.executed_bid_order.append(bid)
                for rid in rs[bid]:
                    # §3: "learners discard duplicate proposals" — a client
                    # Δ1-retry may have landed the same request in a second
                    # disseminator's batch; execute each rid exactly once
                    if rid in self._executed_rids:
                        continue
                    self._executed_rids.add(rid)
                    self.executed.append(rid)             # [step 46]
            self._exec_cursor[g] += 1
            self._merge_ring = (g + 1) % G


class DissNode(MergedExecutionMixin, Agent):
    """Disseminator + co-located learner. [steps 12–34, 38–46]"""

    def __init__(self, sim: "HTPaxosSim", node_id: str) -> None:
        super().__init__(sim, node_id)
        self.hsim = sim
        self.cfg = sim.cfg
        self.rng = random.Random(zlib.crc32(f"{sim.cfg.seed}:{node_id}:d".encode()))
        # stable storage (§4.1.1: requests_set / decided survive failures)
        self.stable.setdefault("requests_set", {})   # batch_id -> tuple(rid)
        self.stable.setdefault("decided_ids", set())
        self.stable.setdefault("instance_log", {})   # instance -> tuple(bid)
        # batch_id -> routing epoch, pinned once at batch origin and learned
        # by every other disseminator from the batch message itself. Stable
        # (survives crashes) so Δ2 rebroadcasts after a restart still route
        # an old id to its old owner group — the drain half of
        # drain-then-switch.
        self.stable.setdefault("bid_epoch", {})
        self.epoch = sim.current_epoch               # routing epoch for NEW batches
        self.next_batch = 0
        # volatile
        self.pending_requests: list[tuple] = []      # rids awaiting batching
        self.req_client: dict[tuple, str] = {}       # rid -> client id
        self.req_bytes: dict[tuple, int] = {}        # rid -> payload bytes
        self.bid_nbytes: dict[tuple, int] = {}       # bid -> batch wire bytes
        # byte-budget batching (§4.1 step 13): the streaming accumulator
        # mirrors pending_requests one-to-one (same length, same order)
        self._acc = BatchAccumulator(self.cfg.batch_budget_bytes) \
            if self.cfg.batch_budget_bytes is not None else None
        self.own_acks: dict[tuple, set] = {}         # batch_id -> diss acks
        self.own_batches: dict[tuple, tuple] = {}    # batch_id -> rids
        self.replied_batches: set = set()
        self.client_acked: set = set()               # rids acked by client
        self.id_outbox: list[tuple] = []
        self.id_seen_from: dict[tuple, str] = {}     # batch_id -> src (step 25)
        self.undecided_known: set = set()            # for Δ2 rebroadcast
        self._init_merged_exec(sim.cfg.n_groups)     # co-located learner
        self.anomaly_dup_ordered = 0                 # invariant: stays 0
        self._batch_timer_armed = False
        self._id_timer_armed = False
        self.periodic(self.cfg.d2_id_rebroadcast, self._rebroadcast_ids)
        self.periodic(self.cfg.d4_missing_after, self._check_missing)
        self.periodic(self.cfg.d6_learner_pull, self._catch_up)

    # ---- request intake & batching [steps 13–14, §4.2] -------------------

    def on_message(self, msg: Msg, lan: Lan) -> None:
        k, p = msg.kind, msg.payload
        if k == "request":
            rid = p["rid"]
            self.req_client[rid] = msg.src
            if "req_bytes" in p:
                self.req_bytes[rid] = p["req_bytes"]
            bid = self._rid_batch(rid)
            if bid is not None:
                # duplicate client retry for an already-batched request:
                # re-reply if we already replied
                if bid in self.replied_batches:
                    self._reply_client(rid)
                return
            if rid in self.pending_requests:
                return
            self.pending_requests.append(rid)
            if self._acc is not None:
                # [step 13, byte budget] admitting this request may close
                # the previous batch (the accumulator returns it); the new
                # request always joins the (possibly fresh) open batch
                if self._acc.add(self._rid_q(rid)) is not None:
                    closed = tuple(self.pending_requests[:-1])
                    self.pending_requests = [rid]
                    self._emit_batch(closed)
                if not self._batch_timer_armed:
                    self._batch_timer_armed = True
                    self.after(self.cfg.batch_linger, self._flush_batch)
            elif len(self.pending_requests) >= self.cfg.batch_size:
                self._flush_batch()
            elif not self._batch_timer_armed:
                self._batch_timer_armed = True
                self.after(self.cfg.batch_linger, self._flush_batch)
        elif k == "batch":                                    # [steps 15–18]
            self._on_batch(p["bid"], p["rids"], msg.src,
                           p.get("epoch", 0), p.get("nbytes"))
        elif k == "batch_ack":                                # [step 20]
            bid = p["bid"]
            if bid in self.own_acks:
                self.own_acks[bid].add(msg.src)
                self._maybe_reply_clients(bid)
        elif k == "client_ack":
            self.client_acked.add(p["rid"])
        elif k == "resend":                                   # [steps 27–28]
            bid = p["bid"]
            rids = self.stable["requests_set"].get(bid)
            if rids is not None:
                nbytes = self.bid_nbytes.get(
                    bid, batch_bytes(len(rids), self.cfg.request_bytes))
                self.send(self.hsim.lan1, msg.src, "batch",
                          size=nbytes, bid=bid, rids=rids,
                          epoch=self.stable["bid_epoch"].get(bid, 0),
                          nbytes=nbytes)
        elif k == "decision":                                 # ordering layer
            self._on_decision(p["entries"],
                              self.hsim.group_of_seq.get(msg.src, 0))

    def _rid_batch(self, rid) -> Optional[tuple]:
        for bid, rids in self.own_batches.items():
            if rid in rids:
                return bid
        return None

    def _rid_q(self, rid) -> int:
        """Payload bytes of one request (per-request override, else the
        config's uniform q)."""
        return self.req_bytes.get(rid, self.cfg.request_bytes)

    def _batch_wire(self, rids) -> int:
        """Wire bytes of a batch of ``rids``: header + Σ (id + payload).
        Uniform-q batches reduce to ``batch_bytes`` exactly."""
        return EMPTY_BATCH_BYTES + sum(ID_BYTES + self._rid_q(r)
                                       for r in rids)

    def _flush_batch(self) -> None:
        self._batch_timer_armed = False
        if self._acc is not None:
            # budget mode: the linger timer drains the accumulator tail
            if self._acc.flush() is None:
                return
            rids = tuple(self.pending_requests)
            self.pending_requests = []
            self._emit_batch(rids)
            return
        if not self.pending_requests:
            return
        rids = tuple(self.pending_requests)
        self.pending_requests = []
        self._emit_batch(rids)

    def _emit_batch(self, rids: tuple) -> None:
        bid = (self.node_id, self.next_batch)
        self.next_batch += 1
        self.own_batches[bid] = rids
        self.own_acks[bid] = set()
        # pin the routing epoch at batch origin; the pin travels with every
        # copy of the batch message (incl. Δ5 resends) so all disseminators
        # id-multicast this bid to the same owner group forever
        epoch = self.stable["bid_epoch"].setdefault(bid, self.epoch)
        nbytes = self._batch_wire(rids)
        self.bid_nbytes[bid] = nbytes
        # [step 14] multicast batch to all disseminators and learners, LAN-1
        # (self included — the paper counts self-delivery, §5.1.1.1)
        dsts = self.hsim.diss_ids + self.hsim.learner_ids
        self.multicast(self.hsim.lan1, dsts, "batch",
                       size=nbytes, bid=bid, rids=rids, epoch=epoch,
                       nbytes=nbytes)

    def _on_batch(self, bid, rids, src, epoch: int = 0,
                  nbytes: Optional[int] = None) -> None:
        rs = self.stable["requests_set"]
        known = bid in rs
        rs[bid] = rids                                         # [step 16]
        if nbytes is not None:
            # remember the origin's wire size so Δ5 resends from *this*
            # node replay the true (per-request-sized) batch bytes
            self.bid_nbytes.setdefault(bid, nbytes)
        # first-writer-wins: the origin's pin arrived with the message; a
        # stale duplicate can never re-route an already-pinned bid
        self.stable["bid_epoch"].setdefault(bid, epoch)
        self.id_seen_from[bid] = src
        if bid not in self.stable["decided_ids"]:
            self.undecided_known.add(bid)
        # [step 17] ack to the sender only (vs S-Paxos all-to-all ack)
        self.send(self.hsim.lan2, src, "batch_ack",
                  size=OVERHEAD + ID_BYTES, bid=bid)
        if not known:
            # [step 18] queue id for the (batched) multicast to sequencers
            self.id_outbox.append(bid)
            if not self._id_timer_armed:
                self._id_timer_armed = True
                self.after(self.cfg.id_linger, self._flush_ids)
        self._try_execute()

    def _flush_ids(self) -> None:
        self._id_timer_armed = False
        if not self.id_outbox:
            return
        ids = tuple(self.id_outbox)
        self.id_outbox = []
        # [step 18] each id goes only to its owning ordering group (owner
        # resolved through the bid's pinned epoch, not the current one)
        for g, gids in self.hsim.ids_by_group(ids, self.stable["bid_epoch"]):
            self.multicast(self.hsim.lan2, self.hsim.seq_groups[g], "ids",
                           size=OVERHEAD + ID_BYTES * len(gids), ids=gids)

    def _rebroadcast_ids(self) -> None:
        # [steps 18–19] Δ2: re-multicast undecided known ids to sequencers
        if not self.undecided_known:
            return
        ids = tuple(sorted(self.undecided_known))
        for g, gids in self.hsim.ids_by_group(ids, self.stable["bid_epoch"]):
            self.multicast(self.hsim.lan2, self.hsim.seq_groups[g], "ids",
                           size=OVERHEAD + ID_BYTES * len(gids), ids=gids)

    # ---- client replies [steps 20–24] ---------------------------------------

    def _maybe_reply_clients(self, bid) -> None:
        rids = self.own_batches.get(bid)
        if rids is None or bid in self.replied_batches:
            return
        majority = len(self.hsim.diss_ids) // 2 + 1
        acks = self.own_acks.get(bid, set())
        if len(acks) >= majority or bid in self.stable["decided_ids"]:
            self.replied_batches.add(bid)
            for rid in rids:
                self._reply_client(rid)
                self.periodic(self.cfg.d3_reply_retry,        # [step 24]
                              lambda rid=rid: self._reply_client(rid),
                              stop=lambda rid=rid: rid in self.client_acked)

    def _reply_client(self, rid) -> None:
        if rid in self.client_acked:
            return
        client = self.req_client.get(rid)
        if client is None:
            client = rid[0]
        self.send(self.hsim.lan2, client, "reply",
                  size=OVERHEAD + ID_BYTES, rid=rid)           # [step 23]

    # ---- missing-payload recovery [steps 25–34] ------------------------------

    def _check_missing(self) -> None:
        rs = self.stable["requests_set"]
        for bid in sorted(self.stable["decided_ids"]):
            if bid not in rs:
                # [steps 32–34] decided but payload missing: pull from any
                # other disseminator, retried by the periodic Δ4/Δ5 sweep
                others = [d for d in self.hsim.diss_ids if d != self.node_id]
                if others:
                    tgt = self.rng.choice(others)
                    self.send(self.hsim.lan2, tgt, "resend",
                              size=OVERHEAD + ID_BYTES, bid=bid)

    # ---- learner role [steps 38–46] -----------------------------------------

    def _on_decision(self, entries, group: int = 0) -> None:
        """Record ordering-layer decisions keyed by *(group, instance)* —
        the paper: "Every Learner learns request_id sequentially as per the
        instance numbers of classical Paxos" (§4.1.3), here per ordering
        group. Arrival order of decision messages is irrelevant; execution
        only advances over the deterministic round-robin merge of the
        per-group contiguous prefixes."""
        log = self.stable["instance_log"]
        for (inst, value) in entries:
            if (group, inst) in log:
                continue
            log[(group, inst)] = value
            for bid in value:
                if is_control_bid(bid):
                    continue
                self.stable["decided_ids"].add(bid)
                self.undecided_known.discard(bid)
                self._maybe_reply_clients(bid)
        self._try_execute()

    def _catch_up(self) -> None:
        """Catch-up pull: whenever a group's execution-frontier instance is
        not yet known locally, ask a sequencer of that group for the
        decided log from the frontier (covers both dropped decision
        multicasts and restart recovery, where the node cannot know how far
        the log advanced while it was down). A no-op reply costs one
        message."""
        log = self.stable["instance_log"]
        for g in range(self.hsim.cfg.n_groups):
            if (g, self._exec_cursor[g]) not in log:
                tgt = self.rng.choice(self.hsim.seq_groups[g])
                self.send(self.hsim.lan2, tgt, "learn_req",
                          size=OVERHEAD + ID_BYTES,
                          **{"from": self._exec_cursor[g]})

    # _try_execute: the round-robin merged execution loop is inherited
    # from MergedExecutionMixin

    def on_restart(self) -> None:
        # volatile state lost; stable requests_set / instance_log survive
        self.pending_requests = []
        self.own_acks = {}
        self.id_outbox = []
        if self._acc is not None:
            self._acc = BatchAccumulator(self.cfg.batch_budget_bytes)
        self.epoch = self.hsim.current_epoch   # re-learn the routing epoch
        self._batch_timer_armed = False
        self._id_timer_armed = False
        self._init_merged_exec(self.hsim.cfg.n_groups)
        self.undecided_known = set(
            bid for bid in self.stable["requests_set"]
            if bid not in self.stable["decided_ids"])
        self.periodic(self.cfg.d2_id_rebroadcast, self._rebroadcast_ids)
        self.periodic(self.cfg.d4_missing_after, self._check_missing)
        self.periodic(self.cfg.d6_learner_pull, self._catch_up)
        self._try_execute()


class LearnerNode(MergedExecutionMixin, Agent):
    """Standalone learner [steps 39–46]."""

    def __init__(self, sim: "HTPaxosSim", node_id: str) -> None:
        super().__init__(sim, node_id)
        self.hsim = sim
        self.cfg = sim.cfg
        self.rng = random.Random(zlib.crc32(f"{sim.cfg.seed}:{node_id}:l".encode()))
        self.stable.setdefault("requests_set", {})
        self.stable.setdefault("instance_log", {})
        self._init_merged_exec(sim.cfg.n_groups)
        self.anomaly_dup_ordered = 0
        self.periodic(self.cfg.d6_learner_pull, self._pull_missing)

    def on_message(self, msg: Msg, lan: Lan) -> None:
        k, p = msg.kind, msg.payload
        if k == "batch":                                      # [steps 41–42]
            self.stable["requests_set"][p["bid"]] = p["rids"]
            self._try_execute()
        elif k == "decision":
            g = self.hsim.group_of_seq.get(msg.src, 0)
            log = self.stable["instance_log"]
            for (inst, value) in p["entries"]:
                log.setdefault((g, inst), value)
            self._try_execute()

    def _pull_missing(self) -> None:                          # [steps 43–45]
        rs = self.stable["requests_set"]
        log = self.stable["instance_log"]
        # missing payloads for decided instances
        for (g, inst), value in log.items():
            if inst < self._exec_cursor[g]:
                continue
            for bid in value:
                if not is_control_bid(bid) and bid not in rs:
                    tgt = self.rng.choice(self.hsim.diss_ids)
                    self.send(self.hsim.lan2, tgt, "resend",
                              size=OVERHEAD + ID_BYTES, bid=bid)
        # instance-frontier repair (incl. restart recovery)
        for g in range(self.hsim.cfg.n_groups):
            if (g, self._exec_cursor[g]) not in log:
                tgt = self.rng.choice(self.hsim.seq_groups[g])
                self.send(self.hsim.lan2, tgt, "learn_req",
                          size=OVERHEAD + ID_BYTES,
                          **{"from": self._exec_cursor[g]})

    # _try_execute: inherited from MergedExecutionMixin

    def on_restart(self) -> None:
        self._init_merged_exec(self.hsim.cfg.n_groups)
        self.periodic(self.cfg.d6_learner_pull, self._pull_missing)
        self._try_execute()


class HTSequencer(PaxosSequencer):
    """[steps 35–37] + ordering layer (§4.1.3).

    Maintains only ``stable_ids`` and ``decided`` (the paper's point vs
    S-Paxos' four sets)."""

    def __init__(self, sim: "HTPaxosSim", node_id: str, rank: int,
                 peers: list[str], cfg: OrderingConfig,
                 initial_leader: bool = False, group_idx: int = 0) -> None:
        super().__init__(sim, node_id, rank, peers, cfg, initial_leader)
        self.hsim = sim
        self.group_idx = group_idx
        self.stable.setdefault("stable_ids", [])     # FIFO of stable batch_ids
        self.stable.setdefault("stable_set", set())
        self.stable.setdefault("decided_ids", set())
        self.id_votes: dict[tuple, set] = {}         # batch_id -> diss heard
        self._skip_armed = False

    def start(self) -> None:
        super().start()
        # multi-group only: an idle leader periodically decides an explicit
        # no-op (skip) instance — Multi-Ring's skip messages — so the
        # learners' strict round-robin merge never blocks on a quiet group.
        # In-band skips keep the merge deterministic at every learner.
        if self.hsim.cfg.n_groups > 1 and not self._skip_armed:
            self._skip_armed = True
            self.periodic(self.hsim.cfg.group_skip_interval,
                          self._maybe_skip)

    def _maybe_skip(self) -> None:
        if not self.is_leader or self.recovery_pending or self.inflight:
            return
        if self.stable["stable_ids"]:
            return  # real work pending — _flush_pool will propose it
        self._propose(self.next_instance, NOOP)
        self.next_instance += 1

    def propose_marker(self, epoch: int) -> None:
        """Decide the in-band ``__reconfig_<epoch>__`` marker — the DES
        twin of the engine's RECONFIG merge-log row. Called by the admin
        reconfiguration event on each group's current leader; consumes one
        ordering instance and rides the normal Paxos pipeline, so every
        learner sees the epoch boundary at a group-consistent merge
        position."""
        if not self.is_leader or self.recovery_pending:
            return
        self._propose(self.next_instance, (reconfig_bid(epoch),))
        self.next_instance += 1

    def on_restart(self) -> None:
        self._skip_armed = False        # timers are volatile across crashes
        super().on_restart()

    # sequencer stability rule [steps 36–37]
    def on_other_message(self, msg: Msg, lan: Lan) -> None:
        if msg.kind != "ids":
            return
        majority = len(self.hsim.diss_ids) // 2 + 1
        for bid in msg.payload["ids"]:
            if bid in self.stable["stable_set"] or \
                    bid in self.stable["decided_ids"]:
                continue
            votes = self.id_votes.setdefault(bid, set())
            votes.add(msg.src)
            if len(votes) >= majority:
                self.stable["stable_ids"].append(bid)
                self.stable["stable_set"].add(bid)
                del self.id_votes[bid]
        if self.is_leader:
            self._flush_pool()

    def pool_pull(self, k: int) -> list:
        # Paper §4.1.3: proposing does NOT delete from stable_ids — deletion
        # happens on decide. ``stable_set`` ("stabilized, not yet decided")
        # stays populated while an id is in flight, which blocks the Δ2
        # disseminator rebroadcasts from re-stabilizing (and re-ordering!)
        # an id that is merely still undecided.
        out = []
        fifo = self.stable["stable_ids"]
        while fifo and len(out) < k:
            bid = fifo.pop(0)
            if bid in self.stable["decided_ids"]:
                continue  # dedup across failover (§4.1.3)
            if bid in out:
                continue
            out.append(bid)
        return out

    def on_decide(self, instance: int, value) -> None:
        for bid in value:
            if not is_control_bid(bid):
                self.stable["decided_ids"].add(bid)
                self.stable["stable_set"].discard(bid)

    def on_abandon(self, values: list) -> None:
        # step-down with proposals in flight: return undecided ids to the
        # pool so they are not lost if no other sequencer has them queued
        fifo = self.stable["stable_ids"]
        for value in values:
            for bid in value:
                if not is_control_bid(bid) and \
                        bid not in self.stable["decided_ids"] and \
                        bid not in fifo:
                    fifo.append(bid)

    def decision_targets(self) -> list[str]:
        # leader multicasts the decision to all sequencers, disseminators
        # and learners (§5.1.1.2)
        return ([p for p in self.peers if p != self.node_id]
                + self.hsim.diss_ids + self.hsim.learner_ids)


class HTPaxosSim(SimBase):
    """Builds the topology and runs HT-Paxos end to end."""

    def __init__(self, cfg: HTConfig, requests_per_client: int = 1,
                 client_gap: float = 0.0, fault=None, fault2=None,
                 latency: float = 1.0) -> None:
        super().__init__(seed=cfg.seed, latency=latency,
                         fault=fault, fault2=fault2)
        self.cfg = cfg
        if cfg.fault_tolerant_colocation and cfg.n_groups > 1:
            # §4.2's FT variant ("all disseminator sites also have a
            # sequencer") is defined for the single-group topology; the
            # flat-index colocation rule would smear groups across
            # dissemination sites arbitrarily and corrupt the busiest-site
            # metrics. Refuse loudly until a per-group rule exists.
            raise ValueError(
                "fault_tolerant_colocation with n_groups > 1 is not "
                "supported (undefined site mapping)")
        # dynamic membership: epoch 0 is initial_active (default: all rows);
        # each reconfig_schedule entry appends one epoch. The table is the
        # single source of truth shared with the engine twin
        # (repro_torch.engine.epochs.EpochTable).
        active0 = tuple(cfg.initial_active) if cfg.initial_active is not None \
            else tuple(range(cfg.n_groups))
        self.epoch_table = EpochTable(
            (active0, *(tuple(a) for _t, a in cfg.reconfig_schedule)),
            n_rows=cfg.n_groups)
        self.current_epoch = 0
        self._trivial_epochs = (self.epoch_table.n_epochs == 1
                                and active0 == tuple(range(cfg.n_groups)))
        self.diss_ids = [f"d{i}" for i in range(cfg.n_diss)]
        # ordering groups: group 0 keeps the paper's s0..s{n-1} naming (the
        # exact single-group topology when n_groups == 1); extra groups are
        # g<k>s<i>. seq_ids stays the flat list across all groups.
        self.seq_groups: list[list[str]] = [
            [f"s{i}" if g == 0 else f"g{g}s{i}" for i in range(cfg.n_seq)]
            for g in range(cfg.n_groups)]
        self.seq_ids = [s for grp in self.seq_groups for s in grp]
        self.group_of_seq = {s: g for g, grp in enumerate(self.seq_groups)
                             for s in grp}
        self.learner_ids = [f"l{i}" for i in range(cfg.n_learners)]
        self.client_ids = [f"c{i}" for i in range(cfg.n_clients)]
        # site accounting (FT variant co-locates sequencer k on diss site k)
        self.site_map: dict[str, str] = {}
        for i, d in enumerate(self.diss_ids):
            self.site_map[d] = d
        for i, s in enumerate(self.seq_ids):
            if cfg.fault_tolerant_colocation and i < len(self.diss_ids):
                self.site_map[s] = self.diss_ids[i]
            else:
                self.site_map[s] = s

        self.disseminators = [DissNode(self, d) for d in self.diss_ids]
        self.sequencers = [
            HTSequencer(self, s, rank=i, peers=grp, cfg=cfg.ordering,
                        initial_leader=(i == 0), group_idx=g)
            for g, grp in enumerate(self.seq_groups)
            for i, s in enumerate(grp)]
        self.learners = [LearnerNode(self, l) for l in self.learner_ids]
        # workload_schedule replaces the clients' self-driven request loop
        # with exact scheduled injections (closed-pipeline cross-validation)
        self.clients = [
            ClientNode(self, c,
                       n_requests=0 if cfg.workload_schedule
                       else requests_per_client,
                       gap=client_gap)
            for c in self.client_ids]
        self.attach_all()
        for s in self.sequencers:
            s.start()
        # admin reconfiguration events (sim constructed at t=0, so the
        # schedule's absolute times are also delays)
        for k, (t, _active) in enumerate(cfg.reconfig_schedule):
            self.sched.after(t, lambda e=k + 1: self._apply_reconfig(e))
        for (t, ci, size) in cfg.workload_schedule:
            if not 0 <= int(ci) < cfg.n_clients:
                raise ValueError(f"workload_schedule client {ci} outside "
                                 f"[0, {cfg.n_clients})")
            cl = self.clients[int(ci)]
            self.sched.after(t, lambda cl=cl, q=int(size):
                             cl.inject_request(q))

    def _apply_reconfig(self, epoch: int) -> None:
        """Admin control-plane event at a scheduled membership switch:
        bump every live disseminator's routing epoch (new batches route by
        the new assignment; bids pinned to older epochs keep draining to
        their old owner groups — §5.5: no view change) and have every
        group's leader decide the in-band epoch marker."""
        self.current_epoch = epoch
        for d in self.disseminators:
            if d.alive:
                d.epoch = epoch
        for g in range(self.cfg.n_groups):
            ldr = self.group_leader(g)
            if ldr is not None:
                ldr.propose_marker(epoch)

    # -- convenience ----------------------------------------------------------

    @property
    def leader(self) -> Optional[HTSequencer]:
        for s in self.sequencers:
            if s.is_leader and s.alive:
                return s
        return None

    def group_leader(self, g: int) -> Optional[HTSequencer]:
        for s in self.sequencers:
            if s.group_idx == g and s.is_leader and s.alive:
                return s
        return None

    def ids_by_group(self, ids, bid_epoch=None) -> list[tuple[int, tuple]]:
        """Partition batch_ids by owning ordering group via
        ``engine.router.partition_ids`` (crc32 on the id's repr — note the
        engine's vectorized ``route_ids`` is a *different* hash for uint32
        arrays; cross-validating DES against the engine must route both
        sides with ``route_id``). Returns only non-empty (group,
        ids-tuple) pairs, group-ascending.

        With dynamic membership, ``bid_epoch`` maps each bid to its pinned
        routing epoch and the owner is ``route_id_epoch`` over the sim's
        epoch table (an unpinned bid defaults to epoch 0). The static
        single-epoch all-rows-active table keeps the exact legacy
        ``partition_ids`` path, bit-for-bit."""
        if self._trivial_epochs or bid_epoch is None:
            if self.cfg.n_groups == 1:
                return [(0, tuple(ids))]
            return [(g, tuple(part)) for g, part in
                    enumerate(partition_ids(ids, self.cfg.n_groups)) if part]
        parts: list[list] = [[] for _ in range(self.cfg.n_groups)]
        for bid in ids:
            g = route_id_epoch(bid, self.epoch_table, bid_epoch.get(bid, 0))
            parts[g].append(bid)
        return [(g, tuple(p)) for g, p in enumerate(parts) if p]

    def group_decided_orders(self) -> list[list]:
        """Canonical per-group bid order: each group's decided log sorted by
        instance (Paxos safety makes every member's log agree on the
        prefix), no-ops dropped."""
        orders = []
        for grp in self.seq_groups:
            log: dict = {}
            for s in grp:
                log.update(self.agents[s].stable["decided_log"])
            orders.append([bid for inst in sorted(log) for bid in log[inst]
                           if not is_control_bid(bid)])
        return orders

    def check_merged_interleaving(self) -> list:
        """Invariant (engine merge ↔ DES): every learner's executed bid
        order must be a legal interleaving of the per-group decided orders
        — its restriction to group g equals a prefix of group g's decided
        order. Returns violations (empty = invariant holds)."""
        from .invariants import check_legal_interleaving
        orders = self.group_decided_orders()
        out = []
        for a in self.all_learner_agents():
            out += [(a.node_id, *v) for v in check_legal_interleaving(
                a.executed_bid_order, orders)]
        return out

    def all_learner_agents(self) -> list:
        return list(self.disseminators) + list(self.learners)

    def executed_sequences(self) -> dict[str, list]:
        return {a.node_id: list(a.executed) for a in self.all_learner_agents()}

    def total_replied(self) -> int:
        return sum(len(c.replied) for c in self.clients)

    def site_total_msgs(self, site: str) -> int:
        return sum(self.node_total_msgs(n) for n, s in self.site_map.items()
                   if s == site)

    def site_total_bytes(self, site: str) -> int:
        return sum(self.node_total_bytes(n) for n, s in self.site_map.items()
                   if s == site)
