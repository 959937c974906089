"""Elastic membership: cluster views as ordered reconfiguration commands.

The paper's point (§5.5, vs Mencius/LCR): HT-Paxos tolerates disseminator
churn WITHOUT a view change — only the *sequencer group* runs elections,
and clients/disseminators/learners never need to know who leads. We keep
the same split for the training fleet:

  * pod (disseminator/learner) joins and leaves are SCALE commands in the
    ordered log — every pod observes the membership flip at the same log
    position, so resharding happens at an agreed step boundary;
  * sequencer membership is fixed at service start (the paper's model);
    leader churn inside it is handled by `core.classic` elections and is
    invisible to the data plane.

``MembershipView`` additionally derives the device-mesh consequence of a
view: how many pods participate in the "pod" axis and the FSDP resharding
plan (which checkpoint shards each new pod must fetch) — the glue between
the ordered log and `launch.mesh`.

``OrderingGroupLog`` is the ordering-layer analogue: SCALE commands over
*group rows* instead of pods. Its applied sequence compiles directly to a
``repro_torch.engine.epochs.EpochTable`` (and an ``HTConfig.reconfig_schedule``
for the DES), so the control plane that reshards pods is the same one
that drains-then-switches ordering groups. A copy of
``repro.runtime.membership`` over the port's ``engine.epochs``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..engine.epochs import EpochTable


@dataclass(frozen=True)
class MembershipView:
    epoch: int
    pods: tuple                      # pod ids, sorted
    step_boundary: int               # training step at which it activates

    def mesh_pod_axis(self) -> int:
        return max(1, len(self.pods))

    def reshard_plan(self, n_shards: int) -> dict:
        """shard k → owning pod (round-robin over the view); a joining pod
        fetches its shards from the quorum-committed checkpoint, exactly
        like a restarted learner pulls missing payloads (§4.1 resend)."""
        return {k: self.pods[k % len(self.pods)]
                for k in range(n_shards)}


class MembershipLog:
    """Derives the view sequence from applied SCALE commands."""

    def __init__(self, initial_pods: list) -> None:
        self.views = [MembershipView(0, tuple(sorted(initial_pods)), 0)]

    def apply_scale(self, pods: list, step: int) -> MembershipView:
        v = MembershipView(self.views[-1].epoch + 1,
                           tuple(sorted(pods)), step)
        self.views.append(v)
        return v

    @property
    def current(self) -> MembershipView:
        return self.views[-1]

    def view_at_step(self, step: int) -> MembershipView:
        out = self.views[0]
        for v in self.views:
            if v.step_boundary <= step:
                out = v
        return out


class OrderingGroupLog:
    """Ordered SCALE commands over ordering-group *rows* — the ordering
    layer's membership log. Each applied command appends one epoch; the
    whole history compiles to the :class:`repro_torch.engine.epochs.EpochTable`
    shared by the vectorized engine (``reconfigure_*``) and the DES
    (``HTConfig.reconfig_schedule``). ``n_rows`` is the physical group
    count: rows are only ever (de)activated, never created mid-run, which
    is what lets the engine keep fixed array shapes across epochs."""

    def __init__(self, initial_active, *, n_rows: int | None = None) -> None:
        self.n_rows = n_rows
        self._epochs: list[tuple[int, ...]] = []
        self._boundaries: list[float] = [0.0]
        self._append(initial_active)

    def _append(self, active) -> None:
        rows = tuple(sorted(set(int(r) for r in active)))
        self._epochs.append(rows)
        # validate incrementally — EpochTable rejects empty/overflowing rows
        EpochTable(tuple(self._epochs), n_rows=self.n_rows)

    def apply_scale(self, active, at: float) -> int:
        """Append an epoch activating exactly ``active`` rows at time/step
        boundary ``at`` (must be non-decreasing). Returns the new epoch
        index."""
        if at < self._boundaries[-1]:
            raise ValueError(
                f"scale boundary {at} precedes {self._boundaries[-1]}")
        self._append(active)
        self._boundaries.append(float(at))
        return len(self._epochs) - 1

    @property
    def current_epoch(self) -> int:
        return len(self._epochs) - 1

    def table(self) -> EpochTable:
        """The compiled epoch table (engine-side source of truth)."""
        return EpochTable(tuple(self._epochs), n_rows=self.n_rows)

    def reconfig_schedule(self) -> tuple:
        """The DES twin: ``HTConfig.reconfig_schedule`` value — one
        (time, active_rows) pair per post-initial epoch."""
        return tuple(zip(self._boundaries[1:], self._epochs[1:]))

    def epoch_at(self, t: float) -> int:
        """Routing epoch in force at time/step ``t``."""
        e = 0
        for k, b in enumerate(self._boundaries):
            if b <= t:
                e = k
        return e
