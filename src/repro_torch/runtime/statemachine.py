"""The trainer as a replicated state machine.

SMR applied to training: every state transition of the training service is
a *command* ordered by the HT-Paxos ordering layer; pods are learners that
apply the decided command log in sequence. Because ``train_step`` is a pure
deterministic function of (state, batch), two pods that apply the same
command prefix hold bitwise-identical training state — the paper's
consistency guarantee (§4.3) lifted to whole-model training.

Commands:
  STEP(batch_id)      — run one train step on the disseminated batch
  CKPT(step)          — cut a checkpoint; commit needs a disseminator
                        majority of shard-write acks (§4.4: stability ⇒
                        f+1 durable copies)
  SCALE(n_pods)       — elastic membership change (reconfiguration rides
                        the ordered log, so every pod switches at the same
                        step boundary)
  NOOP                — gap filler after leader failover, and the explicit
                        skip instance of an idle ordering group

With the sharded ordering engine (``repro.engine``), G sequencer groups
decide commands independently; ``MergedCommandLog`` is the learner-side
adapter that merges the per-group decision streams into the single total
order a pod applies — deterministic round-robin over per-group instance
cursors, NOOP/skip instances advancing the ring without touching training
state — and audits that the merged order is a legal interleaving of the
per-group orders.

Counterpart of ``repro.runtime.statemachine``. ``tree_digest`` walks the
reference's layout of a state (keys sorted, segment leaves stacked along
the layer axis) and hashes each leaf's native bytes (bf16 as its 2-byte
pattern), so a port state and the reference state of the same arrays
give the same hex digest. On the CUDA card the train step runs with
deterministic algorithms (``repro_torch.train.trainer``).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..convert import tensor_to_numpy
from ..core.invariants import check_legal_interleaving
from ..models.common import reference_leaves


@dataclass(frozen=True)
class Command:
    kind: str                  # STEP | CKPT | SCALE | NOOP
    arg: Any = None

    def encode(self) -> tuple:
        return (self.kind, self.arg)

    @staticmethod
    def decode(t) -> "Command":
        return Command(t[0], t[1])


def tree_digest(tree) -> str:
    """Order-stable digest of a state or parameter tree (for
    replica-consistency audits and checkpoint manifests): sha256 over the
    native bytes of the reference's leaves in its flatten order, first 16
    hex digits. Equal to ``repro.runtime.statemachine.tree_digest`` of the
    reference tree of the same arrays."""
    h = hashlib.sha256()
    for _, tensors, _ in reference_leaves(tree):
        for t in tensors:
            h.update((tensor_to_numpy(t, native=True)
                      if isinstance(t, torch.Tensor) else np.asarray(t))
                     .tobytes())
    return h.hexdigest()[:16]


class MergedCommandLog:
    """Multiple sequencer groups feeding one learner log.

    ``feed(group, instance, cmd)`` records group-local decisions (in any
    arrival order); the deterministic round-robin merge applies commands to
    the attached state machine as soon as the next (group, cursor) instance
    is available. Two pods fed the same per-group decisions — in *any*
    interleaving of feed calls — apply the identical merged command
    sequence, which is what keeps replica training state bitwise equal.
    """

    def __init__(self, groups: int,
                 apply: Optional[Callable[[Command], None]] = None) -> None:
        self.groups = groups
        self.apply_fn = apply
        self.logs: list[dict] = [dict() for _ in range(groups)]
        self.cursors = [0] * groups
        self.ring = 0
        self.merged: list[tuple] = []        # merged encoded commands
        self.merged_groups: list[int] = []   # owning group per merged entry

    def feed(self, group: int, instance: int, cmd: Command) -> None:
        prev = self.logs[group].get(instance)
        if prev is not None and prev != cmd.encode():
            raise AssertionError(
                f"ordering safety violation: group {group} instance "
                f"{instance} decided twice with different commands "
                f"({prev} vs {cmd.encode()})")
        self.logs[group][instance] = cmd.encode()
        self._drain()

    def _drain(self) -> None:
        while True:
            g = self.ring
            enc = self.logs[g].get(self.cursors[g])
            if enc is None:
                return
            cmd = Command.decode(enc)
            self.merged.append(enc)
            self.merged_groups.append(g)
            if self.apply_fn is not None and cmd.kind != "NOOP":
                self.apply_fn(cmd)
            self.cursors[g] += 1
            self.ring = (g + 1) % self.groups

    def audit(self) -> list:
        """Check the merged log is a legal interleaving of the per-group
        instance orders (repro.core.invariants). Entries are disambiguated
        by (group, instance) so identical commands in different groups
        don't alias. Returns violations (empty = invariant holds)."""
        orders = [[(g, i) for i in sorted(self.logs[g])]
                  for g in range(self.groups)]
        tagged = []
        cursors = [0] * self.groups
        for g in self.merged_groups:
            tagged.append((g, cursors[g]))    # drain consumes 0,1,2,... per g
            cursors[g] += 1
        return check_legal_interleaving(tagged, orders)


class TrainerStateMachine:
    """One pod's deterministic apply loop."""

    def __init__(self, pod_id: str, train_step: Callable,
                 init_state, batch_store: dict,
                 on_ckpt: Optional[Callable] = None) -> None:
        self.pod_id = pod_id
        self.train_step = train_step
        self.state = init_state
        self.batch_store = batch_store       # batch_id -> batch pytree
        self.on_ckpt = on_ckpt
        self.applied: list[tuple] = []       # decided command log
        self.metrics_log: list[dict] = []
        self.n_pods = 1

    def apply(self, cmd: Command) -> None:
        if cmd.kind == "NOOP":
            pass
        elif cmd.kind == "STEP":
            batch = self.batch_store[cmd.arg]
            self.state, metrics = self.train_step(self.state, batch)
            self.metrics_log.append(
                {k: float(v) for k, v in metrics.items()})
        elif cmd.kind == "CKPT":
            if self.on_ckpt is not None:
                self.on_ckpt(self, cmd.arg)
        elif cmd.kind == "SCALE":
            self.n_pods = int(cmd.arg)
        self.applied.append(cmd.encode())

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def digest(self) -> str:
        return tree_digest(self.state["params"])
