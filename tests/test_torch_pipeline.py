"""The port's closed pipeline (repro_torch.pipeline) against
repro.pipeline on the CPU: the tensor batcher against the reference's
host batchers and its vectorized twin, Workload and WorkloadModel,
PipelineConfig refusals, route tables, run_pipeline at G=2 x D=5 on a
workload the reference drew (every state field equal), plan_admissions
and decode_merged, and the DES cross-checks of
tests/test_pipeline_vs_des.py (G, D in (1, 5), (2, 10), (4, 12), and a
mid-run epoch flip): the port's learner order must equal HTPaxosSim's."""
from __future__ import annotations

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_pipeline_vs_des import (greedy_cover_schedule,  # noqa: E402
                                  make_workload)
from test_pipeline_vs_des import P as SKIP_PERIOD  # noqa: E402
from test_pipeline_vs_des import run_des as run_pipeline_des  # noqa: E402

from repro import pipeline as J  # noqa: E402
from repro.dissem import batcher as JB  # noqa: E402
from repro.engine import api as japi  # noqa: E402
from repro.engine import epochs as JE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import pipeline as T  # noqa: E402
from repro_torch.core.network import ID_BYTES, batch_bytes  # noqa: E402
from repro_torch.dissem import batcher as TB  # noqa: E402
from repro_torch.engine import api as tapi  # noqa: E402
from repro_torch.engine import epochs as TE  # noqa: E402

EMPTY = TB.EMPTY_BATCH_BYTES


def ref_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return {f: ref_tree(getattr(tree, f)) for f in tree._fields}
    return np.asarray(tree)


def port_tree(state):
    """A port pipeline state → nested numpy dicts (engine bitsets as
    uint32, like the reference's)."""
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if f == "engine":
            out[f] = convert.engine_state_to_numpy(v)
        elif isinstance(v, tuple):
            out[f] = port_tree(v)
        else:
            out[f] = v.numpy()
    return out


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


def to_port(wl) -> T.Workload:
    return T.Workload(torch.from_numpy(np.array(wl.arrived)),
                      torch.from_numpy(np.array(wl.sizes)))


# -- the tensor batcher --------------------------------------------------------

def stream_through_vbatch(size_stream, budget, max_requests,
                          slots_per_tick=4):
    """A size stream through one lane of tick_flushes with the tail flush
    off (one endless accumulator): each request's batch index."""
    state = T.init_batch_state(1, "cpu")
    req_seq = []
    for i in range(0, len(size_stream), slots_per_tick):
        chunk = size_stream[i:i + slots_per_tick]
        sizes = torch.zeros((1, slots_per_tick), dtype=torch.int32)
        valid = torch.zeros((1, slots_per_tick), dtype=torch.bool)
        sizes[0, :len(chunk)] = torch.tensor(chunk)
        valid[0, :len(chunk)] = True
        state, fl = T.tick_flushes(state, sizes, valid, budget_bytes=budget,
                                   max_requests=max_requests,
                                   flush_tail=False)
        req_seq += fl.req_seq[0, :len(chunk)].tolist()
    return req_seq


@given(sizes=st.lists(st.integers(min_value=0, max_value=3000),
                      min_size=1, max_size=60),
       budget=st.integers(min_value=EMPTY + ID_BYTES + 1, max_value=4000),
       cap=st.sampled_from([None, 1, 3, 7]))
@settings(max_examples=40, deadline=None)
def test_vbatch_assignment_equals_plan_batches(sizes, budget, cap):
    plan = JB.plan_batches(sizes, budget_bytes=budget, max_requests=cap)
    assert stream_through_vbatch(sizes, budget, cap) == plan.tolist()


@given(sizes=st.lists(st.integers(min_value=0, max_value=3000),
                      min_size=1, max_size=40),
       budget=st.integers(min_value=EMPTY + ID_BYTES + 1, max_value=4000))
@settings(max_examples=40, deadline=None)
def test_vbatch_tail_flush_bytes_equal_accumulator(sizes, budget):
    """One tick with the tail flush = the reference's BatchAccumulator
    (and the port's copy) add* + flush: same batches, bytes, counts."""
    want = []
    for acc_cls in (JB.BatchAccumulator, TB.BatchAccumulator):
        acc, batches = acc_cls(budget), []
        for s in sizes:
            out = acc.add(s)
            if out is not None:
                batches.append(out)
        if (out := acc.flush()) is not None:
            batches.append(out)
        want.append((batches, acc.n_flushed, acc.bytes_flushed))
    assert want[1] == want[0]
    batches = want[0][0]
    state, fl = T.tick_flushes(
        T.init_batch_state(1, "cpu"), torch.tensor([sizes], dtype=torch.int32),
        torch.ones((1, len(sizes)), dtype=torch.bool), budget_bytes=budget)
    valid = fl.valid[0]
    assert fl.count[0][valid].tolist() == [len(b) for b in batches]
    assert fl.bytes[0][valid].tolist() == [
        EMPTY + sum(ID_BYTES + s for s in b) for b in batches]
    assert sum(fl.bytes[0][valid].tolist()) == want[0][2]
    assert int(state.count[0]) == 0 and int(state.used[0]) == EMPTY
    assert int(state.seq[0]) == len(batches)


@pytest.mark.parametrize("flush_tail,cap", [(True, None), (False, 2),
                                            (True, 3)])
def test_tick_flushes_matches_reference(flush_tail, cap):
    """Several lanes over several ticks: every field of TickFlushes and
    BatchState equals the reference's vmapped scan."""
    rng = np.random.default_rng(5)
    D, K, budget = 6, 5, 2600
    js = J.init_batch_state(D)
    ts = T.init_batch_state(D, "cpu")
    for _ in range(4):
        sizes = rng.choice([0, 200, 900, 1800, 3000], (D, K)).astype(np.int32)
        valid = rng.random((D, K)) < 0.7
        js, jf = J.tick_flushes(js, jnp.asarray(sizes), jnp.asarray(valid),
                                budget_bytes=budget, max_requests=cap,
                                flush_tail=flush_tail)
        ts, tf = T.tick_flushes(ts, torch.from_numpy(sizes),
                                torch.from_numpy(valid), budget_bytes=budget,
                                max_requests=cap, flush_tail=flush_tail)
        for got, want in ((tf, jf), (ts, js)):
            assert_tree_equal({k: v.numpy() for k, v in got._asdict().items()},
                              ref_tree(want))


def test_vbatch_oversized_request_gets_own_batch():
    budget = EMPTY + ID_BYTES + 100
    assert stream_through_vbatch([50, 5000, 50], budget, None) == [0, 1, 2]


def test_vbatch_rejects_headerless_budget():
    msgs = []
    for mod, args in ((J, (J.init_batch_state(1), jnp.zeros((1, 2), jnp.int32),
                           jnp.ones((1, 2), bool))),
                      (T, (T.init_batch_state(1, "cpu"),
                           torch.zeros((1, 2), dtype=torch.int32),
                           torch.ones((1, 2), dtype=torch.bool)))):
        with pytest.raises(ValueError, match="budget") as err:
            mod.tick_flushes(*args, budget_bytes=EMPTY)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    with pytest.raises(ValueError, match="budget"):
        TB.BatchAccumulator(EMPTY)


def test_batch_bytes_matches_reference():
    from repro.core.htpaxos import batch_bytes as ref_batch_bytes
    for n, size in ((0, 0), (1, 1024), (8, 1024), (3, 77)):
        assert batch_bytes(n, size) == ref_batch_bytes(n, size)
    assert batch_bytes(8, 1024) == 8292


# -- workload ------------------------------------------------------------------

def test_workload_schedule_round_trip_matches_reference():
    events = [(0, 2, 100), (3, 0, 50), (3, 4, 0), (9, 2, 777)]
    ref = J.Workload.from_schedule(events, ticks=10, n_clients=5)
    wl = T.Workload.from_schedule(events, ticks=10, n_clients=5,
                                  device="cpu")
    assert wl.schedule() == ref.schedule() == sorted(events)
    assert (wl.n_requests, wl.total_bytes, wl.n_ticks, wl.n_clients) == \
        (ref.n_requests, ref.total_bytes, 10, 5)
    assert np.array_equal(wl.arrived.numpy(), np.asarray(ref.arrived))
    assert np.array_equal(wl.sizes.numpy(), np.asarray(ref.sizes))
    assert wl.sizes.dtype == torch.int32


@pytest.mark.parametrize("events", [[(10, 0, 1)], [(0, 5, 1)],
                                    [(0, 0, 1), (0, 0, 2)], [(0, 0, -1)]])
def test_workload_from_schedule_rejects_like_reference(events):
    with pytest.raises(ValueError) as ref_err:
        J.Workload.from_schedule(events, ticks=10, n_clients=5)
    with pytest.raises(ValueError) as port_err:
        T.Workload.from_schedule(events, ticks=10, n_clients=5, device="cpu")
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw", [
    dict(n_clients=0, arrival_rate=0.5),
    dict(n_clients=1, arrival_rate=1.5),
    dict(n_clients=1, arrival_rate=0.5, size_choices=()),
    dict(n_clients=1, arrival_rate=0.5, size_choices=(-1,)),
    dict(n_clients=1, arrival_rate=0.5, size_choices=(1, 2),
         size_probs=(1.0,)),
    dict(n_clients=1, arrival_rate=0.5, size_choices=(1, 2),
         size_probs=(0.9, 0.9)),
])
def test_workload_model_rejects_like_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        J.WorkloadModel(**kw)
    with pytest.raises(ValueError) as port_err:
        T.WorkloadModel(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_workload_model_deterministic_under_fixed_generator():
    m = T.WorkloadModel(n_clients=9, arrival_rate=0.4,
                        size_choices=(128, 512, 2048),
                        size_probs=(0.5, 0.25, 0.25))
    a = m.draw(torch.Generator().manual_seed(7), 50)
    b = m.draw(torch.Generator().manual_seed(7), 50)
    assert torch.equal(a.arrived, b.arrived) and torch.equal(a.sizes, b.sizes)
    c = m.draw(torch.Generator().manual_seed(8), 50)
    assert not torch.equal(a.arrived, c.arrived)
    arr, sz = a.arrived, a.sizes
    assert sz.dtype == torch.int32 and arr.dtype == torch.bool
    assert (sz[~arr] == 0).all()
    assert np.isin(sz[arr].numpy(), m.size_choices).all()
    assert 0 < a.n_requests < 50 * 9


def test_workload_model_rate_and_size_mix():
    """Arrival share and size mix of a large draw within 4 binomial
    standard deviations of the configured rates."""
    m = T.WorkloadModel(n_clients=400, arrival_rate=0.045,
                        size_choices=(128, 1024, 4096),
                        size_probs=(0.2, 0.5, 0.3))
    wl = m.draw(torch.Generator().manual_seed(0), 500)
    n = 400 * 500
    sd = (0.045 * 0.955 / n) ** 0.5
    assert abs(wl.n_requests / n - 0.045) < 4 * sd
    sizes = wl.sizes[wl.arrived]
    k = sizes.numel()
    for size, p in zip(m.size_choices, m.size_probs):
        share = float((sizes == size).sum()) / k
        assert abs(share - p) < 4 * (p * (1 - p) / k) ** 0.5, size
    uniform = T.WorkloadModel(n_clients=50, arrival_rate=1.0,
                              size_choices=(1, 2)).draw(
                                  torch.Generator().manual_seed(1), 40)
    share = float((uniform.sizes == 1).sum()) / 2000
    assert abs(share - 0.5) < 4 * (0.25 / 2000) ** 0.5


# -- PipelineConfig, route tables ----------------------------------------------

def gated_cfg(mod, G=2, D=5, **over):
    kw = dict(
        engine=mod.EngineConfig(
            groups=G, window=16, n_diss=D, n_seq=3, order_budget=4,
            merge_capacity=G * 256,
            recycling=mod.RecyclingConfig(watermark=8, id_stride=4096),
            gating=mod.GatingConfig()),
        n_clients=10, budget_bytes=2500, capacity=128, seq_capacity=64)
    kw.update(over)
    cls = J.PipelineConfig if mod is japi else T.PipelineConfig
    return cls(**kw)


@pytest.mark.parametrize("over,err", [
    ("ungated", "gated"),
    (dict(n_clients=0), "n_clients"),
    (dict(budget_bytes=EMPTY), "budget_bytes"),
    (dict(max_requests=0), "max_requests"),
    (dict(ack_lag=(1, 2)), "ack_lag"),
    (dict(hold_lag=(-1, 0, 0, 0, 0)), "hold_lag"),
    (dict(vote_lag=(0,) * 4), "vote_lag"),
    (dict(capacity=8), "capacity"),
    (dict(capacity=8192), "id stride"),
    (dict(seq_capacity=0), "seq_capacity"),
])
def test_pipeline_config_rejects_like_reference(over, err):
    msgs = []
    for mod in (japi, tapi):
        kw = over if isinstance(over, dict) else dict(engine=mod.EngineConfig(
            groups=2, window=16, n_diss=5, n_seq=3, order_budget=4,
            merge_capacity=64))
        with pytest.raises(ValueError, match=err) as e:
            gated_cfg(mod, **kw)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_pipeline_config_lag_defaults():
    cfg = gated_cfg(tapi)
    assert cfg.ack_lag == (0,) * 5 and cfg.hold_lag == (0,) * 5
    assert cfg.vote_lag == (0,) * 3
    assert cfg.n_lanes == 5 and cfg.lane_slots == 2
    assert cfg.id_stride == 4096
    ref = gated_cfg(japi)
    for got, want in zip(cfg.lane_clients(), ref.lane_clients()):
        assert np.array_equal(got, want)


def test_build_route_table_matches_reference():
    tables = (JE.EpochTable(((0, 1), (0,)), n_rows=2),
              TE.EpochTable(((0, 1), (0,)), n_rows=2))
    cfgs = [gated_cfg(mod, D=7, seq_capacity=40,
                      engine=mod.EngineConfig(
                          groups=2, window=16, n_diss=7, n_seq=3,
                          order_budget=4, merge_capacity=512,
                          recycling=mod.RecyclingConfig(8, 4096),
                          gating=mod.GatingConfig(), epochs=t))
            for mod, t in zip((japi, tapi), tables)]
    for epoch in (0, 1):
        want = J.build_route_table(cfgs[0], epoch)
        got = T.build_route_table(cfgs[1], epoch)
        assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(T.build_route_table(gated_cfg(tapi)),
                          J.build_route_table(gated_cfg(japi)))


# -- run_pipeline against the reference ----------------------------------------

LAGS = dict(ack_lag=(0, 1, 1, 2, 2), hold_lag=(0, 0, 1, 1, 2),
            vote_lag=(1, 1, 2))


def reference_run(jcfg, wl, drain_ticks):
    rt = jnp.asarray(J.build_route_table(jcfg))
    st, outs = J.run_pipeline(jcfg, J.init_pipeline(jcfg), wl.arrived,
                              wl.sizes, rt)
    ea, es = jnp.zeros((10,), bool), jnp.zeros((10,), jnp.int32)
    for _ in range(drain_ticks):
        st, _ = J.pipeline_tick_jit(jcfg, st, ea, es, rt)
    return st, outs


def port_run(tcfg, wl, drain_ticks, inplace=False):
    rt = torch.from_numpy(T.build_route_table(tcfg))
    st, outs = T.run_pipeline(tcfg, T.init_pipeline(tcfg, "cpu"),
                              wl.arrived, wl.sizes, rt, inplace=inplace)
    ea = torch.zeros((10,), dtype=torch.bool)
    es = torch.zeros((10,), dtype=torch.int32)
    for _ in range(drain_ticks):
        st, out = T.pipeline_tick(tcfg, st, ea, es, rt, inplace=inplace)
        assert set(out) == {"flushed", "admitted", "dropped", "overflowed"}
    return st, outs, rt


@pytest.fixture(scope="module")
def reference_drawn():
    """G=2, D=5: a workload the reference drew, its run and drain."""
    jcfg, tcfg = gated_cfg(japi, **LAGS), gated_cfg(tapi, **LAGS)
    jwl = J.WorkloadModel(n_clients=10, arrival_rate=0.5,
                          size_choices=(200, 900, 1800)).draw(
                              jax.random.PRNGKey(3), 30)
    jst, jouts = reference_run(jcfg, jwl, 24)
    return jcfg, tcfg, jwl, jst, jouts


def test_run_pipeline_matches_reference(reference_drawn):
    jcfg, tcfg, jwl, jst, jouts = reference_drawn
    wl = to_port(jwl)
    tst, touts, _ = port_run(tcfg, wl, 24)
    assert_tree_equal(port_tree(tst), ref_tree(jst))
    assert set(touts) == set(jouts)
    for k in jouts:
        assert np.array_equal(touts[k].numpy(), np.asarray(jouts[k])), k
    assert not bool(tst.overflowed) and int(touts["dropped"].sum()) == 0
    for got, want in zip(T.committed(tcfg, tst), J.committed(jcfg, jst)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_run_pipeline_in_place_equals_functional(reference_drawn):
    """The functional run leaves its input state as it was; the in-place
    run gives the same final state."""
    _, tcfg, jwl, _, _ = reference_drawn
    wl = to_port(jwl)
    rt = torch.from_numpy(T.build_route_table(tcfg))
    st0 = T.init_pipeline(tcfg, "cpu")
    half = T.run_pipeline(tcfg, st0, wl.arrived[:10], wl.sizes[:10], rt)[0]
    before = port_tree(half)
    a, _ = T.run_pipeline(tcfg, half, wl.arrived[10:], wl.sizes[10:], rt)
    assert_tree_equal(port_tree(half), before)
    b, _ = T.run_pipeline(tcfg, half, wl.arrived[10:], wl.sizes[10:], rt,
                          inplace=True)
    assert_tree_equal(port_tree(b), port_tree(a))


def test_plan_admissions_and_decode_match_reference(reference_drawn):
    jcfg, tcfg, jwl, jst, _ = reference_drawn
    wl = to_port(jwl)
    tst, _, rt = port_run(tcfg, wl, 24)
    want = J.plan_admissions(jcfg, jwl, np.asarray(rt))
    got = T.plan_admissions(tcfg, wl, rt)
    assert got == want
    assert T.plan_admissions(tcfg, wl, rt.numpy()) == want
    n = sum(len(v) for v in got.values())
    assert n == int(tst.admit_count.sum()) == int(tst.n_flushed.sum()) > 0
    codes, ticks = tst.bid_code.numpy(), tst.admit_tick.numpy()
    for g, rows in got.items():
        assert int(tst.admit_count[g]) == len(rows)
        for r in rows:
            assert codes[g, r["rank"]] == \
                r["lane"] * tcfg.seq_capacity + r["seq"]
            assert ticks[g, r["rank"]] == r["tick"]
    merged, _, com = T.committed(tcfg, tst)
    assert int(com) == n
    bids = T.decode_merged(tcfg, tst, merged, com)
    jm, _, jcom = J.committed(jcfg, jst)
    assert bids == J.decode_merged(jcfg, jst, jm, jcom)
    assert len(bids) == n == len(set(bids))


def test_decode_merged_refuses_unknown_ids(reference_drawn):
    _, tcfg, jwl, _, _ = reference_drawn
    st = T.init_pipeline(tcfg, "cpu")
    with pytest.raises(ValueError, match="never admitted"):
        T.decode_merged(tcfg, st, torch.tensor([5]), 1)
    with pytest.raises(ValueError, match="outside"):
        T.decode_merged(tcfg, st, torch.tensor([200]), 1)


def test_pipeline_tick_reports_flush_and_admit_counts():
    tcfg = gated_cfg(tapi)
    rt = torch.from_numpy(T.build_route_table(tcfg))
    arrived = torch.tensor([True] * 5 + [False] * 5)
    sizes = torch.where(arrived, 500, 0).to(torch.int32)
    st, out = T.pipeline_tick(tcfg, T.init_pipeline(tcfg, "cpu"), arrived,
                              sizes, rt)
    assert int(out["flushed"]) == 5 and int(out["admitted"]) == 5
    assert not bool(out["overflowed"]) and int(st.tick) == 1
    assert st.flushed_bytes.tolist() == [batch_bytes(1, 500)] * 5


def test_overflow_is_flagged_like_reference():
    """seq_capacity 2 over 4 ticks of traffic on every lane: both sides
    flag the overflow and agree on the state."""
    jcfg, tcfg = (gated_cfg(mod, seq_capacity=2) for mod in (japi, tapi))
    events = [(t, c, 300) for t in range(4) for c in range(10)]
    jwl = J.Workload.from_schedule(events, ticks=4, n_clients=10)
    jst, _ = J.run_pipeline(jcfg, J.init_pipeline(jcfg), jwl.arrived,
                            jwl.sizes, jnp.asarray(J.build_route_table(jcfg)))
    tst, _, _ = port_run(tcfg, to_port(jwl), 0)
    assert bool(tst.overflowed) and bool(jst.overflowed)
    assert_tree_equal(port_tree(tst), ref_tree(jst))


# -- cross-validation against the DES ------------------------------------------

def des_pipeline_cfg(G, D, *, table=None):
    """tests/test_pipeline_vs_des.py's pipeline_cfg with the port's
    classes."""
    return T.PipelineConfig(
        engine=tapi.EngineConfig(
            groups=G, window=8, n_diss=D, n_seq=3, order_budget=4,
            merge_capacity=G * 512,
            recycling=tapi.RecyclingConfig(watermark=4, id_stride=4096),
            gating=tapi.GatingConfig(stab_majority=D // 2 + 1,
                                     n_diss_partition=D),
            epochs=table),
        n_clients=2 * D, budget_bytes=4096, capacity=256, seq_capacity=64)


def drain(pcfg, st, rt, max_ticks=24):
    ea = torch.zeros((pcfg.n_clients,), dtype=torch.bool)
    es = torch.zeros((pcfg.n_clients,), dtype=torch.int32)
    for _ in range(max_ticks):
        st, _ = T.pipeline_tick(pcfg, st, ea, es, rt)
        if int(T.committed(pcfg, st)[2]) == int(st.admit_count.sum()):
            break
    return st


@pytest.mark.parametrize("G,D", [(1, 5), (2, 10), (4, 12)])
def test_closed_pipeline_matches_des(G, D):
    n_cycles = 12
    table = JE.EpochTable((tuple(range(G)),), n_rows=G)
    plan = greedy_cover_schedule(D, [tuple(range(G))] * n_cycles,
                                 [0] * n_cycles, table)
    jwl = make_workload(plan, n_cycles, D, 2 * D)
    wl = to_port(jwl)
    pcfg = des_pipeline_cfg(G, D)
    rt = torch.from_numpy(T.build_route_table(pcfg))
    st, outs = T.run_pipeline(pcfg, T.init_pipeline(pcfg, "cpu"),
                              wl.arrived, wl.sizes, rt)
    st = drain(pcfg, st, rt)
    assert not bool(st.overflowed) and int(outs["dropped"].sum()) == 0
    merged, _, com = T.committed(pcfg, st)
    assert int(st.admit_count.sum()) == len(plan) == int(com)
    order = T.decode_merged(pcfg, st, merged, com)
    _, des_order = run_pipeline_des(G, D, jwl,
                                    until=n_cycles * SKIP_PERIOD + 20)
    assert len(des_order) == len(plan)
    assert order == des_order


def test_closed_pipeline_matches_des_reconfig():
    """G=2, epoch 0 active (0, 1) → epoch 1 active (0,), switched at a
    quiescent boundary on both sides; row 1 is sealed by the flip."""
    G, D, k0, k1 = 2, 10, 6, 6
    plan = greedy_cover_schedule(
        D, [(0, 1)] * k0 + [(0,)] * k1, [0] * k0 + [1] * k1,
        JE.EpochTable(((0, 1), (0,)), n_rows=G))
    jwl = make_workload(plan, k0 + k1, D, 2 * D)
    wl = to_port(jwl)
    pcfg = des_pipeline_cfg(G, D, table=TE.EpochTable(((0, 1), (0,)),
                                                      n_rows=G))
    rt0 = torch.from_numpy(T.build_route_table(pcfg, epoch=0))
    rt1 = torch.from_numpy(T.build_route_table(pcfg, epoch=1))
    st, o1 = T.run_pipeline(pcfg, T.init_pipeline(pcfg, "cpu"),
                            wl.arrived[:k0], wl.sizes[:k0], rt0)
    st = drain(pcfg, st, rt0)
    pre_merged, _, pre_com = T.committed(pcfg, st)
    before = port_tree(st)
    st2, report = T.reconfigure_pipeline(pcfg, st, 0, 1)
    assert_tree_equal(port_tree(st), before)
    assert report["moved"] == 0 and report["removed"] == (1,)
    core = st2.engine.core
    assert int(core.rs.retired[1]) == int(core.rs.q.next_instance[1])
    st2, o2 = T.run_pipeline(pcfg, st2, wl.arrived[k0:], wl.sizes[k0:], rt1)
    st2 = drain(pcfg, st2, rt1)
    assert not bool(st2.overflowed)
    assert int(o1["dropped"].sum()) == int(o2["dropped"].sum()) == 0
    merged, _, com = T.committed(pcfg, st2)
    assert int(st2.admit_count.sum()) == len(plan) == int(com)
    assert merged[:int(pre_com)].tolist() == \
        pre_merged[:int(pre_com)].tolist()
    order = T.decode_merged(pcfg, st2, merged, com)
    t_r = k0 * SKIP_PERIOD + 2.5
    _, des_order = run_pipeline_des(G, D, jwl, reconfig=((t_r, (0,)),),
                                    until=(k0 + k1) * SKIP_PERIOD + 20)
    assert order == des_order


def test_reconfigure_pipeline_refuses_in_flight_moves():
    """A grow with admitted-but-unordered batches that change owner: the
    reference and the port both refuse, with the same message."""
    msgs = []
    for mod, E, P in ((japi, JE, J), (tapi, TE, T)):
        cfg = gated_cfg(mod, ack_lag=(5,) * 5, engine=mod.EngineConfig(
            groups=3, window=16, n_diss=5, n_seq=3, order_budget=4,
            merge_capacity=512,
            recycling=mod.RecyclingConfig(watermark=8, id_stride=4096),
            gating=mod.GatingConfig(),
            epochs=E.EpochTable(((0, 1), (0, 1, 2)), n_rows=3)))
        events = [(0, c, 300) for c in range(10)]
        if P is J:
            wl = J.Workload.from_schedule(events, ticks=2, n_clients=10)
            st = J.init_pipeline(cfg)
            rt = jnp.asarray(J.build_route_table(cfg))
        else:
            wl = T.Workload.from_schedule(events, ticks=2, n_clients=10,
                                          device="cpu")
            st = T.init_pipeline(cfg, "cpu")
            rt = torch.from_numpy(T.build_route_table(cfg))
        st, _ = P.run_pipeline(cfg, st, wl.arrived, wl.sizes, rt)
        with pytest.raises(ValueError, match="moved") as err:
            P.reconfigure_pipeline(cfg, st, 0, 1)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
