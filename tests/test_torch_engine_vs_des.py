"""DES replays through the port (repro_torch) on the CPU.

Reruns the replays of tests/test_engine_vs_des.py and
tests/test_dissem_vs_des.py with the port's engine in place of the JAX
engine. The discrete-event simulator stays the oracle: the port's merged
consumable prefix must equal every DES learner's executed bid order, and
the port's stability engine must derive the DES sequencers' per-group
stable-id sets."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_dissem_vs_des import (MAJ, N_DISS, des_stable_sets,  # noqa: E402
                                hold_ticks_from_deliveries, run_des_tapped,
                                slot_map_from_streams)
from test_engine_vs_des import NOOP, group_instance_streams, run_des  # noqa: E402

from repro_torch.convert import bits_from_numpy  # noqa: E402
from repro_torch.dissem.engine import init_dissem, run_stability_ticks  # noqa: E402
from repro_torch.engine import merge as M  # noqa: E402
from repro_torch.engine import sharded as S  # noqa: E402


def _b(a):
    return bits_from_numpy(a, "cpu")


def slot_table(real, bid_slot, G, W):
    """Flat bid table and the int32[G, W] slot→id map (sentinel for
    unused slots), as the reference replays lay them out."""
    bid_table = [b for r in real for b in r]
    bid_to_int = {b: i for i, b in enumerate(bid_table)}
    slot_ids = np.full((G, W), len(bid_table), np.int32)
    for b, (g, k) in bid_slot.items():
        slot_ids[g, k] = bid_to_int[b]
    return bid_table, slot_ids


def ordering_acks(streams, G, W, T, offset=0):
    """Ack the slot of instance t's bid at tick offset + t (saturated)."""
    acks = np.zeros((T, G, W, 1), np.uint32)
    for g, s in enumerate(streams):
        k = 0
        for t, b in enumerate(s):
            if b != NOOP:
                acks[offset + t, g, k, 0] = 0xFFFFFFFF
                k += 1
    return acks


def replay_through_port(streams, G):
    T = max((len(s) for s in streams), default=0)
    real, bid_slot, W = slot_map_from_streams(streams, G)
    bid_table, slot_ids = slot_table(real, bid_slot, G, W)
    acks = ordering_acks(streams, G, W, T)
    votes = np.full((T, G, W, 1), 0xFFFFFFFF, np.uint32)
    st, ms, merged, cnt, committed = S.run_sharded_ticks_merged(
        S.init_sharded(G, W, 5, 3, "cpu"), M.init_merge(G, max(T, 1), "cpu"),
        _b(acks), _b(votes), torch.from_numpy(slot_ids), diss_majority=3,
        seq_majority=2, order_budget=1)
    assert int(committed) == int(cnt) == len(bid_table)
    return [bid_table[i] for i in merged[:int(committed)].tolist()]


@pytest.mark.parametrize("G,seed", [(1, 0), (2, 0), (4, 0), (2, 3)])
def test_port_merge_matches_des_learners(G, seed):
    sim = run_des(G, seed=seed)
    streams = group_instance_streams(sim)
    order = replay_through_port(streams, G)
    learners = sim.all_learner_agents()
    assert learners
    for a in learners:
        assert a.executed_bid_order == order, a.node_id
    assert sorted(order) == sorted(b for s in streams for b in s
                                   if b != NOOP)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_port_stability_matches_des_stable_sets(G):
    sim, deliveries = run_des_tapped(G)
    streams = group_instance_streams(sim)
    real, bid_slot, W = slot_map_from_streams(streams, G)
    holds = hold_ticks_from_deliveries(deliveries, bid_slot, G, W)
    st, outs = run_stability_ticks(init_dissem(G, W, N_DISS, device="cpu"),
                                   _b(holds), majority=MAJ)
    stable = st.stable.numpy()
    engine_sets = [{r[w] for w in range(len(r)) if stable[g, w]}
                   for g, r in enumerate(real)]
    assert engine_sets == des_stable_sets(sim, G)
    # the per-group newly-stable counts sum to the stable slots
    assert outs["newly_per_group"].sum(0).tolist() == \
        stable.sum(1).tolist()


@pytest.mark.parametrize("G", [1, 2, 4])
def test_port_gated_engine_matches_des_learners(G):
    sim, deliveries = run_des_tapped(G)
    streams = group_instance_streams(sim)
    real, bid_slot, W = slot_map_from_streams(streams, G)
    bid_table, slot_ids = slot_table(real, bid_slot, G, W)
    TH = max(len({t for t, _, _ in deliveries}), 1)
    T = TH + max((len(s) for s in streams), default=0)
    holds = np.zeros((T, G, W, 1), np.uint32)
    holds[:TH] = hold_ticks_from_deliveries(deliveries, bid_slot, G, W)
    acks = ordering_acks(streams, G, W, T, offset=TH)
    votes = np.full((T, G, W, 1), 0xFFFFFFFF, np.uint32)
    st, d, ms, merged, cnt, committed = S.run_gated_ticks_merged(
        S.init_sharded(G, W, N_DISS, 3, "cpu"),
        init_dissem(G, W, N_DISS, device="cpu"),
        M.init_merge(G, max(T, 1), "cpu"), _b(acks), _b(holds), _b(votes),
        torch.from_numpy(slot_ids), diss_majority=MAJ, seq_majority=2,
        stab_majority=MAJ, order_budget=1)
    assert bool(d.stable.numpy()[slot_ids < len(bid_table)].all())
    assert int(committed) == int(cnt) == len(bid_table)
    order = [bid_table[i] for i in merged[:int(committed)].tolist()]
    for a in sim.all_learner_agents():
        assert a.executed_bid_order == order, a.node_id
