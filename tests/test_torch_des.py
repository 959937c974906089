"""The port's HT-Paxos DES and its baselines (``repro_torch.core``)
against the reference's (``repro.core``), on the CPU.

Each case builds the same configuration in both packages, with the same
seed, runs both simulators in this process and compares them exactly:
the learners' executed sequences (and HT-Paxos' per-group decided
orders, merged bid orders, per-site message and byte totals and the
merge audit), the clients' replies, every node's LAN-1 and LAN-2
counters (messages and bytes, sent and received, by kind), each LAN's
wire totals, the events run and the scheduler's final time. The
configurations are those of the reference's own protocol tests (the
file and line of each is in its case), with message loss, duplication,
jitter, crashes, leader failover and a mid-run reconfiguration among
them. Nothing is held to a tolerance: equal seeds give equal runs. The
closed forms of ``analytical`` are compared at the paper's parameters.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
from repro.core import analytical as j_analytical  # noqa: E402
from repro.core import classic as j_classic  # noqa: E402
from repro.core import classical_smr as j_classical  # noqa: E402
from repro.core import htpaxos as j_htpaxos  # noqa: E402
from repro.core import invariants as j_invariants  # noqa: E402
from repro.core import multiring as j_multiring  # noqa: E402
from repro.core import network as j_network  # noqa: E402
from repro.core import ring as j_ring  # noqa: E402
from repro.core import spaxos as j_spaxos  # noqa: E402
from repro_torch.core import analytical, classic, classical_smr  # noqa: E402
from repro_torch.core import htpaxos, invariants, multiring  # noqa: E402
from repro_torch.core import network, ring, spaxos  # noqa: E402

REF = SimpleNamespace(ht=j_htpaxos, classic=j_classic, net=j_network,
                      ring=j_ring, multiring=j_multiring, spaxos=j_spaxos,
                      classical=j_classical, inv=j_invariants)
PORT = SimpleNamespace(ht=htpaxos, classic=classic, net=network, ring=ring,
                       multiring=multiring, spaxos=spaxos,
                       classical=classical_smr, inv=invariants)

QUIET = dict(d1_client_retry=1e7, d2_id_rebroadcast=1e7,
             d3_reply_retry=1e7, d4_missing_after=1e7, d5_resend_retry=1e7,
             d6_learner_pull=1e7)
RETRY = dict(d1_client_retry=150, d2_id_rebroadcast=100, d3_reply_retry=100,
             d4_missing_after=50, d5_resend_retry=60, d6_learner_pull=60)


def _ordering(cfg, **kw):
    for k, v in kw.items():
        setattr(cfg.ordering, k, v)


def _run(sim, until, max_events=10_000_000):
    sim.events_run = sim.run(until=until, max_events=max_events)
    return sim


# -- HT-Paxos cases -----------------------------------------------------------

def safety(seed, drop, dup, jitter, n_diss, n_seq, n_clients, reqs, bs):
    """test_protocol_safety.py:21 (make_sim), at one hypothesis draw."""
    def build(ns):
        cfg = ns.ht.HTConfig(n_diss=n_diss, n_seq=n_seq, n_learners=1,
                             n_clients=n_clients, batch_size=bs, seed=seed,
                             **RETRY)
        _ordering(cfg, retry_interval=40, election_timeout=120,
                  heartbeat_interval=30)
        fault = ns.net.FaultModel(drop_p=drop, dup_p=dup, jitter=jitter)
        sim = ns.ht.HTPaxosSim(cfg, requests_per_client=reqs,
                               client_gap=20.0, fault=fault, fault2=fault)
        return _run(sim, 30_000, 2_000_000)
    return build


def progress(seed, drop, crash_plan=(), until=60_000, n_clients=6, reqs=4,
             dup=0.05, jitter=3.0):
    """test_protocol_progress.py:14 (run_sim); ``crash_plan`` holds
    (time, fn(sim) -> action)."""
    def build(ns):
        cfg = ns.ht.HTConfig(n_diss=5, n_seq=3, n_learners=1,
                             n_clients=n_clients, batch_size=2, seed=seed,
                             **RETRY)
        _ordering(cfg, retry_interval=40, election_timeout=120,
                  heartbeat_interval=30)
        fault = ns.net.FaultModel(drop_p=drop, dup_p=dup, jitter=jitter)
        sim = ns.ht.HTPaxosSim(cfg, requests_per_client=reqs,
                               client_gap=20.0, fault=fault, fault2=fault)
        for t, action in crash_plan:
            sim.sched.at(t, action(sim))
        return _run(sim, until, 4_000_000)
    return build


def multigroup(n_groups, n_clients=6, reqs=4, until=2_000):
    """test_multigroup_des.py:17 (run_sim)."""
    def build(ns):
        cfg = ns.ht.HTConfig(n_diss=5, n_seq=3, n_learners=1,
                             n_clients=n_clients, batch_size=2, seed=0,
                             n_groups=n_groups)
        sim = ns.ht.HTPaxosSim(cfg, requests_per_client=reqs,
                               client_gap=10.0)
        return _run(sim, until)
    return build


def multigroup_group_leader_crash(ns):
    """test_multigroup_des.py:71: loss plus a crashed group-1 leader."""
    fault = ns.net.FaultModel(drop_p=0.08, dup_p=0.03, jitter=2.0)
    sim = ns.ht.HTPaxosSim(
        ns.ht.HTConfig(n_diss=5, n_seq=3, n_learners=1, n_clients=4,
                       batch_size=2, seed=1, n_groups=2,
                       d1_client_retry=150, d2_id_rebroadcast=100,
                       d3_reply_retry=100, d4_missing_after=50,
                       d6_learner_pull=60),
        requests_per_client=3, client_gap=15.0, fault=fault, fault2=fault)
    _ordering(sim.cfg, retry_interval=40, election_timeout=120,
              heartbeat_interval=30)
    sim.sched.at(150, lambda: sim.agents[sim.seq_groups[1][0]].crash())
    return _run(sim, 30_000, 2_000_000)


def multigroup_learner_restart(ns):
    """test_multigroup_des.py:93: a disseminator/learner crashes and
    restarts from stable storage."""
    sim = ns.ht.HTPaxosSim(
        ns.ht.HTConfig(n_diss=5, n_seq=3, n_learners=0, n_clients=4,
                       batch_size=2, seed=2, n_groups=2, d6_learner_pull=40),
        requests_per_client=3, client_gap=10.0)
    d0 = sim.disseminators[0]
    sim.sched.at(120, d0.crash)
    sim.sched.at(400, d0.restart)
    return _run(sim, 5_000)


def counting(m=6, s=3, k=2, q=1024):
    """test_message_counts.py:20 (counting_sim): one failure-free
    counting round, every timer beyond the horizon."""
    def build(ns):
        cfg = ns.ht.HTConfig(n_diss=m, n_seq=s, n_learners=1,
                             n_clients=m * k, batch_size=k, request_bytes=q,
                             seed=0, random_client_target=False, **QUIET)
        _ordering(cfg, flush_interval=0.5, retry_interval=1e7,
                  heartbeat_interval=1e7, election_timeout=1e7)
        return _run(ns.ht.HTPaxosSim(cfg, requests_per_client=1), 200)
    return build


def ft_variant(ns, m=6, k=2):
    """test_ft_variant_and_pipelining.py:13 (make_ft_sim): a sequencer
    on every disseminator site."""
    cfg = ns.ht.HTConfig(n_diss=m, n_seq=m, n_learners=0, n_clients=m * k,
                         batch_size=k, fault_tolerant_colocation=True,
                         random_client_target=False, **QUIET)
    _ordering(cfg, heartbeat_interval=1e7, election_timeout=1e7)
    return _run(ns.ht.HTPaxosSim(cfg, requests_per_client=1), 300)


def pipelining(m, depth, until, flush=None):
    """test_ft_variant_and_pipelining.py:56 (depth 8) and :79 (depth
    1): one id per ordering instance."""
    def build(ns):
        cfg = ns.ht.HTConfig(n_diss=m, n_seq=3, n_learners=0, n_clients=m,
                             batch_size=1, random_client_target=False,
                             **QUIET)
        _ordering(cfg, pipeline_depth=depth, order_batch_max=1,
                  heartbeat_interval=1e7, election_timeout=1e7)
        if flush is not None:
            cfg.ordering.flush_interval = flush
        return _run(ns.ht.HTPaxosSim(cfg, requests_per_client=1), until)
    return build


def reconfig(G_max, initial_active, schedule, seed=0):
    """test_engine_vs_des_reconfig.py:34 (run_des): a mid-run epoch
    flip with traffic in flight."""
    def build(ns):
        cfg = ns.ht.HTConfig(
            n_diss=5, n_seq=3, n_learners=1, n_clients=6, batch_size=2,
            seed=seed, n_groups=G_max, initial_active=initial_active,
            reconfig_schedule=schedule,
            ordering=ns.classic.OrderingConfig(order_batch_max=1))
        return _run(ns.ht.HTPaxosSim(cfg, requests_per_client=20,
                                     client_gap=10.0), 6_000)
    return build


def byte_budget(ns):
    """Byte-budget batching on a replayed workload (the DES side of
    test_pipeline_vs_des.py:124): 40 requests of 64-2048 bytes from a
    numpy seed, two groups, a flip to one group mid-run."""
    rng = np.random.default_rng(11)
    times = np.sort(rng.uniform(0.0, 200.0, 40))
    clients = rng.integers(0, 10, 40)
    sizes = rng.integers(64, 2048, 40)
    schedule = tuple((float(t), int(c), int(q))
                     for t, c, q in zip(times, clients, sizes))
    cfg = ns.ht.HTConfig(
        n_diss=5, n_seq=3, n_clients=10, batch_budget_bytes=4096,
        random_client_target=False, n_groups=2, group_skip_interval=8.0,
        ordering=ns.classic.OrderingConfig(order_batch_max=1),
        reconfig_schedule=((120.0, (0,)),), workload_schedule=schedule)
    return _run(ns.ht.HTPaxosSim(cfg, requests_per_client=0), 2_000)


def _crash(role, i):
    return lambda sim: getattr(sim, role)[i].crash


def _restart(role, i):
    return lambda sim: getattr(sim, role)[i].restart


HT_CASES = {
    "safety-lossy": safety(17, 0.2, 0.1, 3.0, 5, 3, 4, 3, 2),
    "safety-lossy-5seq": safety(4242, 0.25, 0.15, 5.0, 7, 5, 6, 4, 3),
    "safety-reorder": safety(9, 0.05, 0.0, 4.5, 3, 3, 2, 2, 1),
    "progress-failure-free": progress(1, 0.0),
    "progress-lossy": progress(2, 0.2),
    "progress-diss-crashes": progress(3, 0.1, crash_plan=(
        (150, _crash("disseminators", 0)), (300, _crash("disseminators", 1)),
        (700, _restart("disseminators", 0)))),
    "progress-leader-crash": progress(4, 0.1, crash_plan=(
        (200, _crash("sequencers", 0)),)),
    "progress-sequencer-crash": progress(5, 0.1, crash_plan=(
        (250, _crash("sequencers", 1)),)),
    "progress-best-case": progress(6, 0.0, until=100, n_clients=1, reqs=1,
                                   dup=0.0, jitter=0.0),
    "multigroup-1": multigroup(1),
    "multigroup-2": multigroup(2),
    "multigroup-4": multigroup(4),
    "multigroup-spread": multigroup(2, n_clients=8, reqs=6, until=3_000),
    "multigroup-skips": multigroup(4, n_clients=2, reqs=2, until=3_000),
    "multigroup-leader-crash": multigroup_group_leader_crash,
    "multigroup-learner-restart": multigroup_learner_restart,
    "counting": counting(),
    "ft-variant": ft_variant,
    "pipelining-depth-8": pipelining(5, 8, 300),
    "pipelining-depth-1": pipelining(4, 1, 600, flush=0.5),
    "reconfig-grow": reconfig(3, (0, 1), ((100.0, (0, 1, 2)),)),
    "reconfig-shrink": reconfig(4, (0, 1, 2, 3), ((100.0, (0, 1)),)),
    "reconfig-grow-seed3": reconfig(3, (0, 1), ((120.0, (0, 1, 2)),),
                                    seed=3),
    "byte-budget": byte_budget,
}


# -- baseline cases (test_baseline_protocols.py:24-112) -----------------------

def spaxos_e2e(ns):
    sim = ns.spaxos.SPaxosSim(
        ns.spaxos.SPaxosConfig(n_replicas=5, n_clients=8, batch_size=2),
        requests_per_client=3, client_gap=5.0)
    return _run(sim, 4000)


def spaxos_lossy(ns):
    sim = ns.spaxos.SPaxosSim(
        ns.spaxos.SPaxosConfig(n_replicas=5, n_clients=6, batch_size=2),
        requests_per_client=3, client_gap=10.0,
        fault=ns.net.FaultModel(drop_p=0.1, dup_p=0.05, jitter=2.0))
    return _run(sim, 30_000)


def spaxos_counting(ns, m=6, k=2):
    cfg = ns.spaxos.SPaxosConfig(n_replicas=m, n_clients=m * k,
                                 batch_size=k)
    cfg.ordering.heartbeat_interval = 1e7
    return _run(ns.spaxos.SPaxosSim(cfg, requests_per_client=1), 300)


def ring_e2e(ns):
    sim = ns.ring.RingPaxosSim(
        ns.ring.RingConfig(n_acceptors=5, n_learners=1, n_clients=8,
                           batch_size=2),
        requests_per_client=3, client_gap=5.0)
    return _run(sim, 4000)


def ring_view_change(ns):
    cfg = ns.ring.RingConfig(n_acceptors=5, n_learners=1, n_clients=4,
                             batch_size=2, ring_timeout=80.0)
    sim = ns.ring.RingPaxosSim(cfg, requests_per_client=3, client_gap=30.0)
    sim.sched.at(50, lambda: sim.acceptors[0].crash())
    return _run(sim, 20_000)


def ring_latency(m):
    def build(ns):
        cfg = ns.ring.RingConfig(n_acceptors=m, n_learners=0, n_clients=1,
                                 batch_size=1)
        return _run(ns.ring.RingPaxosSim(cfg, requests_per_client=1), 200)
    return build


def ring_lossy(ns):
    sim = ns.ring.RingPaxosSim(
        ns.ring.RingConfig(n_acceptors=5, n_learners=1, n_clients=6,
                           batch_size=2, seed=5),
        requests_per_client=3, client_gap=10.0,
        fault=ns.net.FaultModel(drop_p=0.1, dup_p=0.05, jitter=2.0))
    return _run(sim, 30_000)


def classical_e2e(ns):
    sim = ns.classical.ClassicalSim(
        ns.classical.ClassicalConfig(n_acceptors=5, n_clients=8,
                                     batch_size=2),
        requests_per_client=3, client_gap=5.0)
    return _run(sim, 4000)


def classical_lossy(ns):
    sim = ns.classical.ClassicalSim(
        ns.classical.ClassicalConfig(n_acceptors=5, n_clients=6,
                                     batch_size=2, seed=7),
        requests_per_client=3, client_gap=10.0,
        fault=ns.net.FaultModel(drop_p=0.1, dup_p=0.05, jitter=2.0))
    return _run(sim, 30_000)


def multiring_merge(ns):
    cfg = ns.multiring.MultiRingConfig(
        n_partitions=3,
        ring=ns.ring.RingConfig(n_acceptors=4, n_learners=0, n_clients=4,
                                batch_size=2),
        n_merge_learners=3)
    sim = ns.multiring.MultiRingSim(cfg, requests_per_client=3,
                                    client_gap=7.0)
    return _run(sim, 6000)


BASELINE_CASES = {
    "spaxos-e2e": spaxos_e2e,
    "spaxos-lossy": spaxos_lossy,
    "spaxos-counting": spaxos_counting,
    "ring-e2e": ring_e2e,
    "ring-view-change": ring_view_change,
    "ring-latency-3": ring_latency(3),
    "ring-latency-6": ring_latency(6),
    "ring-lossy": ring_lossy,
    "classical-e2e": classical_e2e,
    "classical-lossy": classical_lossy,
    "multiring-merge": multiring_merge,
}


# -- the comparison -----------------------------------------------------------

def _node_stats(st):
    return (st.sent_msgs, st.recv_msgs, st.sent_bytes, st.recv_bytes,
            dict(st.sent_by_kind), dict(st.recv_by_kind))


def _lan(lan):
    return {"wire": (lan.wire_msgs, lan.wire_bytes),
            "nodes": {n: _node_stats(s) for n, s in sorted(lan.stats.items())}}


def fingerprint(sim) -> dict:
    out = {"now": sim.sched.now, "events": sim.events_run,
           "replied": sim.total_replied(),
           "lan1": _lan(sim.lan1), "lan2": _lan(sim.lan2),
           "client_replies": [sorted(c.replied.items())
                              for c in sim.clients]}
    if hasattr(sim, "merged_sequences"):
        out["executed"] = sim.merged_sequences()
    else:
        out["executed"] = sim.executed_sequences()
    if hasattr(sim, "group_decided_orders"):
        sites = sorted(set(sim.site_map.values()))
        out.update(
            decided=sim.group_decided_orders(),
            bid_orders={a.node_id: list(a.executed_bid_order)
                        for a in sim.all_learner_agents()},
            site_msgs={s: sim.site_total_msgs(s) for s in sites},
            site_bytes={s: sim.site_total_bytes(s) for s in sites},
            merge_audit=sim.check_merged_interleaving(),
            leader=sim.leader.node_id if sim.leader else None)
    return out


def _compare(build):
    ref, port = build(REF), build(PORT)
    want, got = fingerprint(ref), fingerprint(port)
    for key in want:
        assert got[key] == want[key], key
    assert got["replied"] > 0
    issued = REF.inv.issued_requests(port)
    assert issued == PORT.inv.issued_requests(port)
    assert PORT.inv.audit(got["executed"], issued).safe
    if "merge_audit" in got:
        assert got["merge_audit"] == []
    return ref, port


@pytest.mark.parametrize("case", sorted(HT_CASES))
def test_htpaxos_equals_reference(case):
    ref, port = _compare(HT_CASES[case])
    # the decided logs of every sequencer, instance for instance
    for s in ref.seq_ids:
        assert (port.agents[s].stable["decided_log"]
                == ref.agents[s].stable["decided_log"]), s


@pytest.mark.parametrize("case", sorted(BASELINE_CASES))
def test_baseline_equals_reference(case):
    _compare(BASELINE_CASES[case])


def test_counting_round_matches_derived_forms():
    """The counting round of test_message_counts.py in the port, against
    the derived closed forms, as the reference's test holds its own."""
    m, s, k = 6, 3, 2
    sim = counting(m, s, k)(PORT)
    want = analytical.derived_ht_disseminator(m * k, m, s)
    for d in sim.diss_ids:
        s1, s2 = sim.node_stats(d)
        assert s1.recv_msgs + s2.recv_msgs == want["in"]
        assert s1.sent_msgs + s2.sent_msgs == want["out"]
    lead = analytical.derived_ht_leader(m * k, m, s)
    s1, s2 = sim.node_stats("s0")
    assert s1.recv_msgs + s2.recv_msgs == lead["in"]
    assert s1.sent_msgs + s2.sent_msgs == lead["out"]


# the paper's parameters: m = 1000 disseminators, s = 20 sequencers,
# n requests per unit time, q-byte requests (Figs 1-7)
PAPER_N = (10_000, 50_000, 100_000, 500_000)
PAPER_FORMS = [
    (name, args)
    for n in PAPER_N
    for name, args in (
        ("paper_ht_disseminator", (n, 1000, 20)),
        ("paper_ht_leader", (n, 1000, 20)),
        ("paper_ht_sequencer", (n, 1000, 20)),
        ("paper_ht_learner", (n, 1000, 20)),
        ("paper_ht_ft_leader_site", (n, 1000, 1000)),
        ("paper_ring_leader", (n, 1000)),
        ("paper_spaxos_leader", (n, 1000)),
        ("paper_classical_leader", (n, 1000)),
        ("derived_ht_disseminator", (n, 1000, 20)),
        ("derived_ht_leader", (n, 1000, 20)),
        ("derived_ht_sequencer", (n, 1000, 20)),
        ("derived_ht_learner", (n, 1000, 20)),
        *((f, (n, 1000, 20, q)) for q in (512, 1024)
          for f in ("bytes_ht_disseminator", "bytes_ht_leader")),
        *((f, (n, 1000, q)) for q in (512, 1024)
          for f in ("bytes_spaxos_leader", "bytes_ring_leader",
                    "bytes_classical_leader", "bytes_ht_ft_leader_site")),
        *(("bytes_ht_disseminator_partitioned", (n, 1000, 20, q, g))
          for q in (512, 1024) for g in (1, 4, 10)),
    )]


def test_analytical_forms_equal_reference():
    for name, args in PAPER_FORMS:
        assert (getattr(analytical, name)(*args)
                == getattr(j_analytical, name)(*args)), (name, args)
    assert analytical.DELAYS == j_analytical.DELAYS
    assert all(analytical.ring_delays(m) == j_analytical.ring_delays(m)
               for m in (3, 6, 1000))
    public = {n for n in dir(j_analytical) if not n.startswith("__")}
    assert public <= set(dir(analytical))


def test_wire_constants_and_batch_bytes():
    """``batch_bytes`` is defined once, in ``core.network``, and
    ``htpaxos`` re-exports it; both equal the reference's."""
    assert (network.OVERHEAD, network.ID_BYTES) == (j_network.OVERHEAD,
                                                    j_network.ID_BYTES)
    assert htpaxos.batch_bytes is network.batch_bytes
    for n, q in ((0, 0), (1, 1024), (7, 512), (64, 100)):
        assert network.batch_bytes(n, q) == j_htpaxos.batch_bytes(n, q)
    for bid in ("__noop__", "__reconfig_3__", ("d1", 4), "x"):
        assert htpaxos.is_control_bid(bid) == j_htpaxos.is_control_bid(bid)
    assert [htpaxos.reconfig_bid(e) for e in range(4)] == \
        [j_htpaxos.reconfig_bid(e) for e in range(4)]
