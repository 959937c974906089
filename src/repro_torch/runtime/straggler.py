"""Straggler mitigation: the paper's Δ-timeout/resend machinery applied to
pod progress.

A pod that holds a decided command but lags in applying it is a
*straggler*, not a failure: the paper's recovery ladder (Δ2 id
re-multicast → Δ4 <Resend> payload pull → Δ5 retry elsewhere) maps to

  1. detect  — a pod whose applied-log position trails the decided
               frontier by more than `lag_threshold` entries for longer
               than `patience` ticks;
  2. re-disseminate — ask a healthy replica to resend the payloads the
               straggler is missing (the DES already does this via
               `resend`; here we track it at command granularity);
  3. escalate — declare the pod failed (crash semantics) so the service
               can continue with the remaining majority and later
               re-admit it via restart/catch-up.

This module is pure bookkeeping over observable positions — it never
blocks the ordering layer (the paper's leader never waits on learners).
A copy of ``repro.runtime.straggler`` (it imports no JAX).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StragglerPolicy:
    lag_threshold: int = 4          # decided-minus-applied entries
    patience: float = 200.0         # sim-time a pod may stay lagged
    escalate_after: float = 800.0   # declare failed


class StragglerMonitor:
    def __init__(self, policy: StragglerPolicy | None = None) -> None:
        self.policy = policy or StragglerPolicy()
        self._lag_since: dict[str, float] = {}
        self.resend_requests: list[tuple[float, str, int]] = []
        self.escalated: set = set()

    def observe(self, now: float, pod_id: str, applied: int,
                decided_frontier: int) -> str:
        """Returns the pod's state: ok | lagging | resend | failed."""
        lag = decided_frontier - applied
        p = self.policy
        if lag <= p.lag_threshold:
            self._lag_since.pop(pod_id, None)
            return "ok"
        since = self._lag_since.setdefault(pod_id, now)
        dur = now - since
        if dur >= p.escalate_after:
            self.escalated.add(pod_id)
            return "failed"
        if dur >= p.patience:
            # request re-dissemination of the missing suffix from a peer
            self.resend_requests.append((now, pod_id, applied))
            return "resend"
        return "lagging"

    def healthy_majority(self, pods: list) -> bool:
        alive = [p for p in pods if p not in self.escalated]
        return len(alive) >= len(pods) // 2 + 1
