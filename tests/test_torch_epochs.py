"""The port's epoch membership (repro_torch.engine.epochs and router)
against repro.engine.epochs, bit for bit on the CPU: EpochTable
validation messages, routing (with ids that have bit 31 set), the
aligned RECONFIG marker and its refusals, the no-op flip, the three
reconfigure_* families through the facade (state, slot ids, merge logs
and report), Engine.reconfigure, and the DES replays of
tests/test_engine_vs_des_reconfig.py (grow 2→3, shrink 4→2, across
seeds) through the port's engine."""
from __future__ import annotations

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from test_engine_vs_des_reconfig import (group_instance_streams,  # noqa: E402
                                         run_des)

from repro.core.htpaxos import is_control_bid, reconfig_bid  # noqa: E402
from repro.engine import api as japi  # noqa: E402
from repro.engine import epochs as JE  # noqa: E402
from repro.engine import merge as JM  # noqa: E402
from repro.engine import router as JR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.engine import api as tapi  # noqa: E402
from repro_torch.engine import epochs as TE  # noqa: E402
from repro_torch.engine import merge as TM  # noqa: E402
from repro_torch.engine import router as TR  # noqa: E402
from repro_torch.engine import sharded as TS  # noqa: E402

D, SQ = 5, 3            # disseminators / sequencers per group
DM, SM = 3, 2           # majorities
BUDGET = 4              # order budget per tick
STRIDE = 1 << 10        # recycled id range per group row
FULL = np.uint32(0xFFFFFFFF)
FAMILIES = ["plain", "recycled", "gated_recycled"]
# (G, old active, new active): grow, shrink and the identical-set flip
SCENARIOS = {"grow": (3, (0, 1), (0, 1, 2)),
             "shrink": (4, (0, 1, 2, 3), (0, 1)),
             "noop": (2, (0, 1), (0, 1))}


def port_ids(ids) -> torch.Tensor:
    """uint32 ids as the int32 tensor holding their bits."""
    return torch.from_numpy(np.asarray(ids, np.uint32).view(np.int32))


def ref_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return {f: ref_tree(getattr(tree, f)) for f in tree._fields}
    return np.asarray(tree)


def assert_tree_equal(port, ref, path="state"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            assert_tree_equal(port[k], ref[k], f"{path}.{k}")
    elif ref is None:
        assert port is None, path
    else:
        assert port.dtype == ref.dtype and port.shape == ref.shape, \
            (path, port.dtype, ref.dtype)
        assert np.array_equal(port, ref), path


# -- EpochTable / routing ------------------------------------------------------

@pytest.mark.parametrize("active,n_rows", [
    ((), None), (((0, 1), ()), None), (((1, 0),), None), (((0, 0),), None),
    (((0, 3),), 3)])
def test_epoch_table_errors_match_reference(active, n_rows):
    with pytest.raises(ValueError) as ref_err:
        JE.EpochTable(active, n_rows=n_rows)
    with pytest.raises(ValueError) as port_err:
        TE.EpochTable(active, n_rows=n_rows)
    assert str(port_err.value) == str(ref_err.value)


def test_epoch_table_normalizes_like_reference():
    for args in ((((0, 1), (0, 1, 2)),), (([0, 2], (1,)), 5)):
        ref, port = JE.EpochTable(*args), TE.EpochTable(*args)
        assert (port.active, port.n_rows, port.n_epochs) == \
            (ref.active, ref.n_rows, ref.n_epochs)
        assert port.groups(1) == ref.groups(1)
    assert hash(TE.EpochTable(((0, 1),))) == hash(TE.EpochTable(((0, 1),)))


@given(ids=st.lists(st.integers(min_value=0, max_value=2**32 - 1),
                    min_size=1, max_size=64),
       groups=st.integers(min_value=1, max_value=70000),
       version=st.sampled_from([1, 2]))
@settings(max_examples=40, deadline=None)
def test_route_ids_matches_reference(ids, groups, version):
    ids = ids + [2**31, 2**32 - 1]          # bit 31 set, always
    want = np.asarray(JR.route_ids(jnp.asarray(np.asarray(ids, np.uint32)),
                                   groups, version=version))
    got = TR.route_ids(port_ids(ids), groups, version=version)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(TR.route_u32(ids, groups, version=version), want)


@given(ids=st.lists(st.integers(min_value=0, max_value=2**32 - 1),
                    min_size=1, max_size=64),
       epoch=st.sampled_from([0, 1, 2]))
@settings(max_examples=40, deadline=None)
def test_route_ids_epoch_matches_reference(ids, epoch):
    ids = ids + [2**31 + 7, 2**32 - 2]
    jt = JE.EpochTable(((0, 2), (0, 1, 2, 3), (1,)), n_rows=4)
    tt = TE.EpochTable(((0, 2), (0, 1, 2, 3), (1,)), n_rows=4)
    want = np.asarray(JE.route_ids_epoch(
        jnp.asarray(np.asarray(ids, np.uint32)), jt, epoch))
    got = TE.route_ids_epoch(port_ids(ids), tt, epoch)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert set(got.tolist()) <= set(tt.active[epoch])
    assert np.array_equal(
        TE._route_rows_np(np.asarray(ids, np.uint32), tt, epoch), want)


def test_route_id_epoch_python_twin():
    jt = JE.EpochTable(((0, 2), (0, 1, 2)), n_rows=3)
    tt = TE.EpochTable(((0, 2), (0, 1, 2)), n_rows=3)
    bids = [("d0", 7), ("d3", 0), "abc", 42, ("d999", 511)]
    for e in range(2):
        for bid in bids:
            assert TE.route_id_epoch(bid, tt, e) == \
                JE.route_id_epoch(bid, jt, e)
    assert TR.partition_ids(bids, 3) == JR.partition_ids(bids, 3)


# -- marker round --------------------------------------------------------------

def test_append_reconfig_marker_matches_reference():
    entries = np.asarray([[10, 11], [20, -2], [30, 0]], np.int32)
    counts = np.asarray([2, 2, 1], np.int32)
    jm = JM.append_entries(JM.init_merge(3, 16), jnp.asarray(entries),
                           jnp.asarray(counts))
    tm = TM.append_entries(TM.init_merge(3, 16, "cpu"),
                           torch.from_numpy(entries),
                           torch.from_numpy(counts))
    logs0 = tm.logs.clone()
    jm2, jr = JE.append_reconfig_marker(jm)
    tm2, tr = TE.append_reconfig_marker(tm)
    assert tr == jr == 2
    assert torch.equal(tm.logs, logs0)          # input untouched
    assert_tree_equal(convert.engine_state_to_numpy(tm2), ref_tree(jm2))
    out, cnt = TM.merged_prefix(tm2)
    assert TM.RECONFIG not in out[:int(cnt)].tolist()


@pytest.mark.parametrize("case", ["capacity", "overflow"])
def test_append_reconfig_marker_refusals_match_reference(case):
    def build(M, dev):
        ms = M.init_merge(2, 4, *dev)
        if case == "capacity":
            full = np.full((2, 4), 1, np.int32)
            cnt = np.asarray([4, 4], np.int32)
            return M.append_entries(
                ms, *((torch.from_numpy(x) for x in (full, cnt)) if dev
                      else (jnp.asarray(x) for x in (full, cnt))))
        over = np.asarray([1, 0], np.int32)
        return ms._replace(overflowed=torch.from_numpy(over) if dev
                           else jnp.asarray(over))
    with pytest.raises(ValueError) as ref_err:
        JE.append_reconfig_marker(build(JM, ()))
    with pytest.raises(ValueError, match=case) as port_err:
        TE.append_reconfig_marker(build(TM, ("cpu",)))
    assert str(port_err.value) == str(ref_err.value)


# -- reconfigure_* through the facade, against the reference -------------------

def configs(fam, G, old, new, merge_capacity=256):
    """(reference, port) EngineConfig of one family with a two-epoch
    table (every slot of the gated family is born stable)."""
    out = []
    for mod, E in ((japi, JE), (tapi, TE)):
        kw = dict(groups=G, window=8, n_diss=D, n_seq=SQ,
                  order_budget=BUDGET, merge_capacity=merge_capacity,
                  diss_majority=DM, seq_majority=SM,
                  epochs=E.EpochTable((old, new), n_rows=G))
        if "recycled" in fam:
            kw["recycling"] = mod.RecyclingConfig(watermark=1,
                                                  id_stride=STRIDE)
        if "gated" in fam:
            kw["gating"] = mod.GatingConfig(stab_majority=DM)
        out.append(mod.EngineConfig(**kw))
    return out


def phase_tiles(G, W, T, ack_slots=(), partial_slots=(), holds=True):
    """T ticks of uint32 traffic: saturated acks (and holds) on
    ``ack_slots``, one ack bit (and one hold bit) on ``partial_slots``
    (admitted, never stable), saturated votes everywhere."""
    acks = np.zeros((G, W, 1), np.uint32)
    hold = np.zeros((G, W, 1), np.uint32)
    for g, w in ack_slots:
        acks[g, w] = hold[g, w] = FULL
    for g, w in partial_slots:
        acks[g, w] = hold[g, w] = 1
    votes = np.full((G, W, 1), FULL, np.uint32)
    out = [np.broadcast_to(x, (T, G, W, 1)).copy()
           for x in (acks, votes, hold)]
    return out if holds else out[:2]


def both_run(jc, tc, js, ts, tiles):
    js, *jres = japi.run(jc, js, *(jnp.asarray(x) for x in tiles))
    ts, *tres = tapi.run(tc, ts, *(convert.bits_from_numpy(x, "cpu")
                                   for x in tiles))
    assert int(tres[1]) == int(jres[1]) and int(tres[2]) == int(jres[2])
    assert np.array_equal(tres[0].numpy(), np.asarray(jres[0]))
    return js, ts, tres


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("fam", FAMILIES)
def test_reconfigure_matches_reference(fam, scenario):
    """Traffic on the old epoch's rows with admitted-but-unordered slots,
    the flip, then traffic on the new rows and a settle: the port's
    state, slot ids, merge logs and report equal the reference's at
    every step, and the input state is untouched."""
    G, old, new = SCENARIOS[scenario]
    W = 8
    jc, tc = configs(fam, G, old, new)
    gated = "gated" in fam
    js, ts = japi.create_state(jc), tapi.create_state(tc, "cpu")
    part = [(g, w) for g in old[-2:]
            for w in ((7,) if scenario == "shrink" else (4, 5, 6, 7))]
    js, ts, _ = both_run(jc, tc, js, ts, phase_tiles(
        G, W, 4, [(g, w) for g in old for w in range(3)], part, gated))
    before = convert.engine_state_to_numpy(ts)
    js, jrep = japi.reconfigure(jc, js, 0, 1)
    ts2, trep = tapi.reconfigure(tc, ts, 0, 1)
    assert_tree_equal(convert.engine_state_to_numpy(ts), before)
    assert trep == jrep
    assert (trep["moved"] == 0) == (scenario == "noop")
    assert_tree_equal(convert.engine_state_to_numpy(ts2), ref_tree(js))
    if scenario == "noop":
        assert_tree_equal(convert.engine_state_to_numpy(ts2)["core"],
                          before["core"])
    js, ts2, _ = both_run(jc, tc, js, ts2, phase_tiles(
        G, W, 4, [(g, w) for g in new for w in range(W)], (), gated))
    js, ts2, res = both_run(jc, tc, js, ts2, phase_tiles(G, W, 3,
                                                         holds=gated))
    assert_tree_equal(convert.engine_state_to_numpy(ts2), ref_tree(js))
    out = res[0][:int(res[2])].tolist()
    assert len(out) == len(set(out)) and int(res[2]) > 0


def test_shrink_seals_removed_rows():
    """G=4→2 in the recycled family: removed rows seal (retired ==
    next_instance), their admitted ids re-home to surviving rows."""
    _, tc = configs("recycled", 4, (0, 1, 2, 3), (0, 1))
    ts = tapi.create_state(tc, "cpu")
    part = [(g, w) for g in (2, 3) for w in (6, 7)]
    ts, *_ = tapi.run(tc, ts, *(convert.bits_from_numpy(x, "cpu")
                                for x in phase_tiles(
        4, 8, 4, [(g, w) for g in range(4) for w in range(6)], part,
        holds=False)))
    admitted = sorted(ts.core.slot_ids[g, w].item() for g, w in part)
    ts, report = tapi.reconfigure(tc, ts, 0, 1)
    assert report["removed"] == (2, 3)
    assert report["sealed_retired"] == {2: 6, 3: 6}
    for g in (2, 3):
        assert int(ts.core.retired[g]) == int(ts.core.q.next_instance[g])
        assert not bool((ts.core.q.instance[g] >= 0).any())
    assert sorted(m[0] for m in report["moves"]) == admitted
    assert {m[2] for m in report["moves"]} <= {0, 1}


def test_reconfigure_requires_drained_removed_rows():
    jc, tc = configs("recycled", 2, (0, 1), (0,))
    acks = np.zeros((2, 2, 8, 1), np.uint32)
    acks[:, 1, :4] = FULL
    votes = np.zeros((2, 2, 8, 1), np.uint32)  # ordered, never decided
    js, *_ = japi.run(jc, japi.create_state(jc), jnp.asarray(acks),
                      jnp.asarray(votes))
    ts, *_ = tapi.run(tc, tapi.create_state(tc, "cpu"),
                      *(convert.bits_from_numpy(x, "cpu")
                        for x in (acks, votes)))
    assert not TE.is_drained(ts.core.q, rows=[1])
    assert TE.is_drained(ts.core.q, rows=[0])
    with pytest.raises(ValueError) as ref_err:
        japi.reconfigure(jc, js, 0, 1)
    with pytest.raises(ValueError, match="drain") as port_err:
        tapi.reconfigure(tc, ts, 0, 1)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("case", ["no_epochs", "gated_plain", "same_epoch",
                                  "bad_epoch"])
def test_reconfigure_refusals_match_reference(case):
    ref_port = []
    for mod, E in ((japi, JE), (tapi, TE)):
        kw = dict(groups=2, window=8, n_diss=D, n_seq=SQ, order_budget=4,
                  merge_capacity=64)
        if case != "no_epochs":
            kw["epochs"] = E.EpochTable(((0, 1), (0,)))
        if case == "gated_plain":
            kw["gating"] = mod.GatingConfig()
        cfg = mod.EngineConfig(**kw)
        state = mod.create_state(cfg) if mod is japi \
            else mod.create_state(cfg, "cpu")
        new = {"same_epoch": 0, "bad_epoch": 5}.get(case, 1)
        with pytest.raises(ValueError) as err:
            mod.reconfigure(cfg, state, 0, new)
        ref_port.append(str(err.value))
    assert ref_port[1] == ref_port[0]


def test_epochs_config_validation_matches_reference():
    errs = []
    for mod, E in ((japi, JE), (tapi, TE)):
        with pytest.raises(ValueError) as err:
            mod.EngineConfig(groups=2, window=8, n_diss=D, n_seq=SQ,
                             order_budget=4, merge_capacity=64,
                             epochs=E.EpochTable(((0, 1), (0, 1, 2))))
        errs.append(str(err.value))
    assert errs[1] == errs[0]
    _, tc = configs("recycled", 3, (0, 1), (0, 1, 2))
    _, tc2 = configs("recycled", 3, (0, 1), (0, 1, 2))
    assert tc == tc2 and hash(tc) == hash(tc2)


def test_engine_reconfigure_matches_reference():
    """Engine.create's epoch range check, ticks, Engine.reconfigure and
    its epoch bookkeeping, against the reference's Engine."""
    jc, tc = configs("gated_recycled", 3, (0, 1), (0, 1, 2))
    with pytest.raises(ValueError) as ref_err:
        japi.Engine.create(jc, epoch=2)
    with pytest.raises(ValueError) as port_err:
        tapi.Engine.create(tc, device="cpu", epoch=2)
    assert str(port_err.value) == str(ref_err.value)
    je, te = japi.Engine.create(jc), tapi.Engine.create(tc, device="cpu")
    part = [(g, 7) for g in (0, 1)]
    tiles = phase_tiles(3, 8, 3, [(g, w) for g in (0, 1) for w in range(5)],
                        part)
    for t in range(3):
        je.tick(*(jnp.asarray(x[t]) for x in tiles))
        te.tick(*(convert.bits_from_numpy(x[t], "cpu") for x in tiles))
    assert te.epoch == 0
    jrep, trep = je.reconfigure(1), te.reconfigure(1)
    assert trep == jrep and te.epoch == je.epoch == 1
    assert "epoch=1" in repr(te)
    assert_tree_equal(convert.engine_state_to_numpy(te.state),
                      ref_tree(je.state))
    assert np.array_equal(te.slot_ids.numpy(), np.asarray(je.slot_ids))


# -- DES replays across a mid-run membership change ----------------------------

def replay_through_port(streams, G):
    """tests/test_engine_vs_des_reconfig.py's replay with the port's
    engine: saturated per-instance acks from the DES streams, control
    instances as unacked skip rounds."""
    T = max((len(s) for s in streams), default=0)
    real = [[b for b in s if not is_control_bid(b)] for s in streams]
    W = max(max((len(r) for r in real), default=1), 1)
    bid_table = [b for r in real for b in r]
    bid_to_int = {b: i for i, b in enumerate(bid_table)}
    slot_ids = np.full((G, W), len(bid_table), np.int32)
    for g, r in enumerate(real):
        for k, b in enumerate(r):
            slot_ids[g, k] = bid_to_int[b]
    acks = np.zeros((T, G, W, 1), np.uint32)
    for g, s in enumerate(streams):
        k = 0
        for t, b in enumerate(s):
            if not is_control_bid(b):
                acks[t, g, k, 0] = FULL
                k += 1
    votes = np.full((T, G, W, 1), FULL, np.uint32)
    st_, ms, merged, cnt, committed = TS.run_sharded_ticks_merged(
        TS.init_sharded(G, W, 5, 3, "cpu"), TM.init_merge(G, max(T, 1), "cpu"),
        convert.bits_from_numpy(acks, "cpu"),
        convert.bits_from_numpy(votes, "cpu"), torch.from_numpy(slot_ids),
        diss_majority=3, seq_majority=2, order_budget=1)
    assert int(committed) == int(cnt) == len(bid_table)
    return [bid_table[i] for i in merged[:int(committed)].tolist()]


@pytest.mark.parametrize("G_max,initial,schedule,seed", [
    (3, (0, 1), ((100.0, (0, 1, 2)),), 0),           # grow 2→3
    (4, (0, 1, 2, 3), ((100.0, (0, 1)),), 0),         # shrink 4→2
    (3, (0, 1), ((120.0, (0, 1, 2)),), 3),            # another seed
])
def test_des_reconfig_matches_port(G_max, initial, schedule, seed):
    sim = run_des(G_max, initial, schedule, seed=seed)
    assert sim.total_replied() == 6 * 20
    streams = group_instance_streams(sim)
    for s in streams:
        assert s.count(reconfig_bid(1)) == 1
    # pinned-epoch routing through the port's twin of the DES router
    table = TE.EpochTable(sim.epoch_table.active,
                          n_rows=sim.epoch_table.n_rows)
    bid_epoch: dict = {}
    for d in sim.disseminators:
        bid_epoch.update(d.stable["bid_epoch"])
    for g, s in enumerate(streams):
        for b in s:
            if not is_control_bid(b):
                assert TE.route_id_epoch(b, table, bid_epoch[b]) == g
    order = replay_through_port(streams, sim.cfg.n_groups)
    learners = sim.all_learner_agents()
    assert learners
    for a in learners:
        assert a.executed_bid_order == order, a.node_id
    assert sorted(order) == sorted(
        b for s in streams for b in s if not is_control_bid(b))
