"""Agent base class: crash/restart semantics, stable storage, timers.

Paper §3 system model: agents operate at arbitrary speed, may fail by
stopping, may restart, and always perform actions correctly (non-Byzantine).
Agents have access to stable storage whose state survives failures.

``Agent.stable`` is the stable-storage dict — it survives ``crash()``;
everything else is volatile and is re-initialized by ``on_restart()``.
Periodic timers are volatile (a restarted agent re-arms its own timers).

The port's copy of ``repro.core.agents`` (pure Python, as there).
"""
from __future__ import annotations

from typing import Callable, Optional

from .events import Cancellable, Scheduler
from .network import Lan, Msg


class Agent:
    def __init__(self, sim: "SimBase", node_id: str) -> None:
        self.sim = sim
        self.sched: Scheduler = sim.sched
        self.node_id = node_id
        self.alive = True
        self.stable: dict = {}          # survives crashes
        self._timers: list[Cancellable] = []
        sim.agents[node_id] = self

    # -- messaging ----------------------------------------------------------

    def send(self, lan: Lan, dst: str, kind: str, size: int = 64, **payload) -> None:
        if not self.alive:
            return
        lan.send(self.node_id, dst, Msg(kind, self.node_id, payload, size))

    def multicast(self, lan: Lan, dsts, kind: str, size: int = 64, **payload) -> None:
        if not self.alive:
            return
        lan.multicast(self.node_id, list(dsts), Msg(kind, self.node_id, payload, size))

    def on_message(self, msg: Msg, lan: Lan) -> None:  # pragma: no cover
        raise NotImplementedError

    # -- timers ---------------------------------------------------------------

    def after(self, delay: float, fn: Callable[[], None]) -> Cancellable:
        def guarded() -> None:
            if self.alive:
                fn()
        h = self.sched.after(delay, guarded)
        self._timers.append(h)
        return h

    def periodic(self, interval: float, fn: Callable[[], None],
                 stop: Optional[Callable[[], bool]] = None) -> None:
        """Run ``fn`` every ``interval`` until ``stop()`` is true (checked
        before each firing) or the agent crashes. This is the paper's
        "repeat from step k after every Δ time, until ..." construct."""
        def tick() -> None:
            if not self.alive or (stop is not None and stop()):
                return
            fn()
            self.after(interval, tick)
        self.after(interval, tick)

    # -- failure model --------------------------------------------------------

    def crash(self) -> None:
        self.alive = False
        for t in self._timers:
            t.cancel()
        self._timers.clear()

    def restart(self) -> None:
        if self.alive:
            return
        self.alive = True
        self.on_restart()

    def on_restart(self) -> None:
        """Override: re-read stable storage, re-arm timers."""


class SimBase:
    """Common harness: scheduler + LANs + agent registry + run helpers."""

    def __init__(self, seed: int = 0, latency: float = 1.0,
                 fault=None, fault2=None) -> None:
        from .network import FaultModel
        self.sched = Scheduler()
        self.seed = seed
        # Two LANs per paper §3. LAN-1: bulk payloads; LAN-2: control traffic.
        self.lan1 = Lan("lan1", self.sched, latency=latency,
                        fault=fault, seed=seed)
        self.lan2 = Lan("lan2", self.sched, latency=latency,
                        fault=fault2 if fault2 is not None else fault, seed=seed + 1)
        self.agents: dict[str, Agent] = {}

    def attach_all(self) -> None:
        for a in self.agents.values():
            self.lan1.attach(a)
            self.lan2.attach(a)

    def run(self, until: Optional[float] = None, max_events: int = 10_000_000) -> int:
        return self.sched.run(until=until, max_events=max_events)

    def node_stats(self, node_id: str):
        s1 = self.lan1._stats(node_id)
        s2 = self.lan2._stats(node_id)
        return s1, s2

    def node_total_msgs(self, node_id: str) -> int:
        s1, s2 = self.node_stats(node_id)
        return s1.total_msgs() + s2.total_msgs()

    def node_total_bytes(self, node_id: str) -> int:
        s1, s2 = self.node_stats(node_id)
        return s1.total_bytes() + s2.total_bytes()
