"""SMR safety/progress invariant checkers (paper §4.3–§4.4). A copy of
``repro.core.invariants`` (it imports no JAX).

Used by the hypothesis property tests and by the runtime integration: any
simulation (HT-Paxos or a baseline) can be audited with ``audit()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AuditReport:
    prefix_consistent: bool = True
    no_duplicates: bool = True
    nontrivial: bool = True
    violations: list = field(default_factory=list)

    @property
    def safe(self) -> bool:
        return self.prefix_consistent and self.no_duplicates and self.nontrivial


def check_prefix_consistency(sequences: dict[str, list]) -> list:
    """§4.3.1: no two learners learn values in different orders — every
    learner's executed sequence must be a prefix of the longest one."""
    out = []
    if not sequences:
        return out
    ref = max(sequences.values(), key=len)
    for node, seq in sequences.items():
        if seq != ref[: len(seq)]:
            # locate first divergence for the report
            for i, (a, b) in enumerate(zip(seq, ref)):
                if a != b:
                    out.append((node, i, a, b))
                    break
            else:
                out.append((node, len(ref), "<len>", "<len>"))
    return out


def check_no_duplicates(sequences: dict[str, list]) -> list:
    out = []
    for node, seq in sequences.items():
        if len(seq) != len(set(seq)):
            seen = set()
            for x in seq:
                if x in seen:
                    out.append((node, x))
                    break
                seen.add(x)
    return out


def check_nontriviality(sequences: dict[str, list], issued: set) -> list:
    """§4.3.2 Nontriviality: learners learn only proposed client requests."""
    out = []
    for node, seq in sequences.items():
        for x in seq:
            if x not in issued:
                out.append((node, x))
                break
    return out


def check_legal_interleaving(merged: list, group_orders: list[list]) -> list:
    """Multi-group merge invariant (repro.engine / Multi-Ring §2.5): a
    merged log is legal iff its restriction to each ordering group's ids is
    a prefix of that group's decided order, and it contains no ids owned by
    no group. Returns violation tuples (empty = legal)."""
    owner: dict = {}
    for g, order in enumerate(group_orders):
        for x in order:
            owner.setdefault(x, g)
    out = []
    cursors = [0] * len(group_orders)
    for pos, x in enumerate(merged):
        g = owner.get(x)
        if g is None:
            out.append(("foreign", pos, x))
            continue
        if cursors[g] >= len(group_orders[g]):
            out.append(("overrun", pos, x, g))
        elif group_orders[g][cursors[g]] != x:
            out.append(("reorder", pos, x, g, group_orders[g][cursors[g]]))
        cursors[g] += 1
    return out


def check_unique_ownership(group_orders: list[list]) -> list:
    """Dynamic-membership safety (repro.engine.epochs / §5.5): an id must
    be ordered by exactly one group exactly once, even across an epoch
    switch that moves its ownership. Pinned-epoch routing guarantees this
    (a bid's owner is resolved through the epoch recorded at batch origin);
    a violation means an id was double-routed or re-ordered after a
    re-home. Returns ("cross", id, g1, g2) for an id decided by two groups
    and ("dup", id, g) for an id decided twice by one group."""
    out = []
    first: dict = {}
    for g, order in enumerate(group_orders):
        seen: set = set()
        for x in order:
            if x in seen:
                out.append(("dup", x, g))
                continue
            seen.add(x)
            if x in first and first[x] != g:
                out.append(("cross", x, first[x], g))
            first.setdefault(x, g)
    return out


def audit(sequences: dict[str, list], issued: set | None = None)\
        -> AuditReport:
    rep = AuditReport()
    v = check_prefix_consistency(sequences)
    if v:
        rep.prefix_consistent = False
        rep.violations += [("prefix", *x) for x in v]
    v = check_no_duplicates(sequences)
    if v:
        rep.no_duplicates = False
        rep.violations += [("dup", *x) for x in v]
    if issued is not None:
        v = check_nontriviality(sequences, issued)
        if v:
            rep.nontrivial = False
            rep.violations += [("nontrivial", *x) for x in v]
    return rep


def issued_requests(sim) -> set:
    """All rids issued by a simulation's clients."""
    out = set()
    for c in sim.clients:
        for i in range(c.next_seq):
            out.add((c.node_id, i))
    return out
