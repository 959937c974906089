"""TrainingService: a multi-pod training cluster whose control plane IS
HT-Paxos.

Topology (mirrors paper §3 onto a training fleet):
  * clients     → the data-ingest frontends submitting batch metadata +
                  control commands,
  * disseminators → payload replicas: each training batch (the *bulk*
                  payload) is multicast once on LAN-1 and acked point-to-
                  point — batches are replicated f+1 times before they can
                  be ordered,
  * sequencers  → the lightweight ordering group; the leader orders only
                  batch_ids (never payloads),
  * learners    → the pods: each applies the decided command log to its
                  ``TrainerStateMachine`` (a real train_step on the
                  pods' device).

The service runs the executable protocol from ``repro_torch.core``
in-process —
the same state machines a deployment would bind to real sockets; the
discrete-event scheduler stands in for wall-clock I/O. Fault tolerance is
not simulated away: you can crash pods/sequencers mid-run, and learners
recover via the paper's catch-up machinery (decision pulls + payload
resends) or restart from a quorum-committed checkpoint.

The port's copy of ``repro.runtime.coordinator``. Pods live where their
state is: the device of the ``init_state_fn`` states (the CUDA card for a
state made with no device given), and ``submit_batch`` stores each
batch's tensors on that device. ``TrainerStateMachine`` takes the
port's in-place ``train_step``, so ``init_state_fn`` returns a state of
its own at every call, and ``restart_pod``'s template is filled in place
by ``restore_sharded``.
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..core.htpaxos import HTConfig, HTPaxosSim
from .checkpoint import restore_sharded, save_sharded
from .statemachine import Command, TrainerStateMachine


@dataclass
class ServiceConfig:
    n_pods: int = 2                  # learners (co-located on diss nodes)
    n_diss: int = 3
    n_seq: int = 3
    ckpt_every: int = 4
    # under the process's temporary directory (TMPDIR)
    ckpt_dir: str = field(
        default_factory=lambda: tempfile.gettempdir() + "/repro_ckpt")
    ckpt_shards: int = 4
    seed: int = 0


class TrainingService:
    """Drives N pod state machines through an HT-Paxos ordered log."""

    def __init__(self, cfg: ServiceConfig, train_step: Callable,
                 init_state_fn: Callable[[], dict]) -> None:
        self.cfg = cfg
        ht = HTConfig(n_diss=max(cfg.n_diss, cfg.n_pods), n_seq=cfg.n_seq,
                      n_learners=0, n_clients=1, batch_size=1,
                      seed=cfg.seed,
                      d2_id_rebroadcast=40.0, d4_missing_after=50.0,
                      d6_learner_pull=45.0)
        ht.ordering.flush_interval = 0.5
        ht.ordering.retry_interval = 30.0
        ht.ordering.heartbeat_interval = 10.0
        ht.ordering.election_timeout = 80.0
        self.sim = HTPaxosSim(ht, requests_per_client=0)
        self.batch_store: dict = {}
        self.pods = {
            f"pod{i}": TrainerStateMachine(
                f"pod{i}", train_step, init_state_fn(), self.batch_store,
                on_ckpt=self._make_ckpt_cb(f"pod{i}"))
            for i in range(cfg.n_pods)}
        self.device = self.pods["pod0"].state["step"].device
        # pod i executes the decided log of disseminator node d{i}
        self._pod_diss = {f"pod{i}": self.sim.disseminators[i]
                          for i in range(cfg.n_pods)}
        self._applied_upto = {p: 0 for p in self.pods}
        self._next_client_seq = 0
        self._down: set = set()

    # --- command/batch submission (the "client" role) ---------------------

    def submit_command(self, cmd: Command) -> None:
        """Inject a command as a client request to a random disseminator.
        The request id carries the encoded command (the *payload* rides
        the dissemination layer exactly like any client request)."""
        client = self.sim.clients[0]
        rid = ((client.node_id, self._next_client_seq), cmd.encode())
        self._next_client_seq += 1
        client.n_requests += 1
        client.pending[rid] = self.sim.sched.now
        self.sim.sched.after(0.0, lambda: self._send(client, rid))
        client.periodic(self.sim.cfg.d1_client_retry,
                        lambda rid=rid: self._send(client, rid),
                        stop=lambda rid=rid: rid in client.replied)

    def _send(self, client, rid) -> None:
        if rid in client.replied:
            return
        d = client._pick_diss()
        client.send(self.sim.lan1, d, "request",
                    size=64 + 4 + 1024, rid=rid)

    def submit_batch(self, batch) -> Command:
        bid = f"batch{len(self.batch_store)}"
        self.batch_store[bid] = {
            k: v.to(self.device) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}
        return Command("STEP", bid)

    # --- progress ----------------------------------------------------------

    def run(self, until: float) -> None:
        self.sim.run(until=until)
        self._drain()

    def _drain(self) -> None:
        """Apply newly-decided commands at every live pod, in log order."""
        for pod_id, sm in self.pods.items():
            if pod_id in self._down:
                continue
            diss = self._pod_diss[pod_id]
            executed = diss.executed
            while self._applied_upto[pod_id] < len(executed):
                rid = executed[self._applied_upto[pod_id]]
                # rid = ((client, seq), encoded_cmd) — see _send
                cmd = Command.decode(rid[1])
                sm.apply(cmd)
                self._applied_upto[pod_id] += 1

    # --- fault injection ----------------------------------------------------

    def crash_pod(self, pod_id: str) -> None:
        self._down.add(pod_id)
        self._pod_diss[pod_id].crash()

    def restart_pod(self, pod_id: str, template_state) -> None:
        """Restart: restore from the latest quorum-committed checkpoint,
        then replay the decided suffix (the paper's learner catch-up)."""
        self._down.discard(pod_id)
        self._pod_diss[pod_id].restart()
        sm = self.pods[pod_id]
        try:
            state, manifest = restore_sharded(template_state,
                                              self.cfg.ckpt_dir)
            sm.state = state
            # fast-forward the apply cursor to the checkpoint step by
            # replaying the decided log deterministically
            self._applied_upto[pod_id] = 0
            sm.applied = []
            sm.metrics_log = []
            target = manifest["step"]
            diss = self._pod_diss[pod_id]
            idx = 0
            steps_seen = 0
            while steps_seen < target and idx < len(diss.executed):
                cmd = Command.decode(diss.executed[idx][1])
                if cmd.kind == "STEP":
                    steps_seen += 1
                idx += 1
            self._applied_upto[pod_id] = idx
        except (FileNotFoundError, IOError):
            # no committed checkpoint: reset to INITIAL state and replay
            # the whole decided log (otherwise the log would be applied
            # on top of the pre-crash state — double-application)
            sm.state = template_state
            sm.metrics_log = []
            self._applied_upto[pod_id] = 0
            sm.applied = []

    def leader_id(self) -> Optional[str]:
        l = self.sim.leader
        return l.node_id if l else None

    def crash_leader(self) -> None:
        l = self.sim.leader
        if l:
            l.crash()

    # --- checkpoint commit hook ----------------------------------------------

    def _make_ckpt_cb(self, pod_id: str):
        def cb(sm: TrainerStateMachine, arg) -> None:
            # only pod0 writes (single-writer per shard-set in this
            # in-process stand-in; every pod would write its own FSDP
            # shard in a real fleet)
            if pod_id != "pod0":
                return
            save_sharded(sm.state, self.cfg.ckpt_dir, sm.step,
                         n_shards=self.cfg.ckpt_shards)
        return cb

    # --- audits ---------------------------------------------------------------

    def digests(self) -> dict:
        return {p: sm.digest() for p, sm in self.pods.items()
                if p not in self._down}

    def consistent(self) -> bool:
        """§4.3 lifted to training: live pods at equal step have equal
        params."""
        by_step: dict[int, set] = {}
        for p, sm in self.pods.items():
            if p in self._down:
                continue
            by_step.setdefault(sm.step, set()).add(sm.digest())
        return all(len(v) == 1 for v in by_step.values())
