"""The port's adaptive tick batching (repro_torch.engine.adaptive) against
repro.engine.adaptive on the CPU, bit for bit: merged log, count,
committed length, the whole final state and the queue, for all four
families and over drawn K / threshold / policy / lengths; against the
port's own drain-padded lock-step run; plan_rounds for each policy; the
queue (enqueue, backlog, a full ring's dropped) and its conversion; the
Engine facade; run_adaptive stopped before quiescence; the pipeline's
subtick mode (with and without an epoch flip) against the JAX pipeline
and against the port's lock-step pipeline; in-place against functional;
and the launch counts 2·ΣR (quorum) and ΣR (stability)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import pipeline as JP  # noqa: E402
from repro.engine import adaptive as jad  # noqa: E402
from repro.engine import api as japi  # noqa: E402
from repro.engine import epochs as JE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import pipeline as TP  # noqa: E402
from repro_torch.core import tilesim  # noqa: E402
from repro_torch.dissem import engine as tdissem  # noqa: E402
from repro_torch.engine import adaptive as tad  # noqa: E402
from repro_torch.engine import api as tapi  # noqa: E402
from repro_torch.engine import epochs as TE  # noqa: E402
from repro_torch.engine import merge as tmerge  # noqa: E402

G, W, D, S, B = 3, 8, 5, 3, 2
T0 = 10            # queue capacity / most tiles of one group
E = W              # drain slack: zero ticks to empty assignable backlog
FAMILIES = ("plain", "gated", "recycled", "gated_recycled")


def make_cfgs(fam, K=4, policy="backlog", thr=1, **over):
    """(reference EngineConfig, port EngineConfig) of
    tests/test_adaptive_batching.py's make_cfg."""
    out = []
    for api, ad in ((japi, jad), (tapi, tad)):
        kw = dict(groups=G, window=W, n_diss=D, n_seq=S, order_budget=B,
                  merge_capacity=512,
                  adaptive=ad.AdaptiveConfig(max_tiles_per_tick=K,
                                             policy=policy, threshold=thr,
                                             queue_capacity=T0))
        if "recycled" in fam:
            kw["recycling"] = api.RecyclingConfig(watermark=W - 2,
                                                  id_stride=1 << 16)
        if "gated" in fam:
            kw["gating"] = api.GatingConfig()
        kw.update(over)
        out.append(api.EngineConfig(**kw))
    assert out[0].family == out[1].family == fam
    return out


def rand_traffic(cfg, lens, seed):
    """uint32 [T0, G, W, words] tiles of the reference suite's
    rand_traffic (same draws), zero past each group's length."""
    rng = np.random.default_rng(seed)
    gat = cfg.gating is not None
    wp = ((cfg.gating.n_diss_partition + 31) // 32) if gat else 0

    def mk(words, density):
        a = rng.random((T0, G, W, words * 32)) < density
        bits = np.zeros((T0, G, W, words), np.uint32)
        for b in range(words * 32):
            bits[..., b // 32] |= (a[..., b].astype(np.uint32) << (b % 32))
        for g in range(G):
            bits[lens[g]:, g] = 0
        return bits

    acks = mk((D + 31) // 32, 0.25)
    votes = mk((S + 31) // 32, 0.5)
    return acks, votes, mk(wp, 0.3) if gat else None


def pad(x, e=E):
    return None if x is None else np.concatenate(
        [x, np.zeros((e,) + x.shape[1:], x.dtype)])


def to_ref(x):
    return None if x is None else jnp.asarray(x)


def to_port(x):
    return None if x is None else convert.bits_from_numpy(x, "cpu")


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


def reference_adaptive(jcfg, tiles, lens, n_passes=T0 + E):
    st = japi.create_state(jcfg)
    q = jad.queue_from_arrays(jcfg, *map(to_ref, tiles),
                              lengths=jnp.asarray(lens, jnp.int32))
    st, q, merged, cnt, com = jad.run_adaptive(jcfg, st, q,
                                               n_passes=n_passes)
    return st, q, np.asarray(merged)[:int(cnt)], int(com)


def port_adaptive(tcfg, tiles, lens, n_passes=T0 + E, inplace=False):
    st = tapi.create_state(tcfg, "cpu")
    q = tad.queue_from_arrays(tcfg, *map(to_port, tiles), lengths=lens)
    st, q, merged, cnt, com = tad.run_adaptive(tcfg, st, q,
                                               n_passes=n_passes,
                                               inplace=inplace)
    return st, q, merged[:int(cnt)].numpy(), int(com)


def port_lockstep(tcfg, tiles):
    st = tapi.create_state(tcfg, "cpu")
    st, merged, cnt, com = tapi.run(tcfg, st, *(to_port(pad(x))
                                                 for x in tiles))
    return merged[:int(cnt)].numpy(), int(com)


def check_against_both(jcfg, tcfg, tiles, lens):
    """Port adaptive = JAX adaptive (merged, committed, state, queue) and
    = the port's drain-padded lock-step run (merged, committed)."""
    jst, jq, jm, jcom = reference_adaptive(jcfg, tiles, lens)
    tst, tq, tm, tcom = port_adaptive(tcfg, tiles, lens)
    assert np.array_equal(tm, jm) and tcom == jcom
    assert_tree_equal(convert.engine_state_to_numpy(tst), ref_tree(jst))
    assert_tree_equal(convert.queue_to_numpy(tq), ref_tree(jq), "queue")
    assert int((tq.tail - tq.head).sum()) == 0, "queue not drained"
    lm, lcom = port_lockstep(tcfg, tiles)
    assert np.array_equal(tm, lm) and tcom == lcom
    return tm


@pytest.mark.parametrize("fam", FAMILIES)
def test_adaptive_bit_identical_all_families(fam):
    """The reference suite's skewed scenario in every family: the port
    equals the JAX package and its own lock-step run, bit for bit."""
    jcfg, tcfg = make_cfgs(fam)
    lens = [T0, 3, 6]
    tiles = rand_traffic(tcfg, lens, seed=0)
    assert len(check_against_both(jcfg, tcfg, tiles, lens)) > 0


@pytest.mark.parametrize("case", range(8))
def test_any_partition_bit_identical(case):
    """Drawn family, K, threshold, policy and lengths (K=1 is pure
    lock-step; recycles fire mid-run): bit-identical to the reference
    and to the port's lock-step run."""
    rng = np.random.default_rng(1000 + case)
    fam = FAMILIES[case % 4]
    K = int(rng.choice([1, 2, 4]))
    thr = int(rng.choice([1, 2]))
    policy = str(rng.choice(tad.POLICIES))
    lens = rng.integers(1, T0 + 1, G).tolist()
    jcfg, tcfg = make_cfgs(fam, K=K, policy=policy, thr=thr)
    tiles = rand_traffic(tcfg, lens, seed=int(rng.integers(2**31)))
    check_against_both(jcfg, tcfg, tiles, lens)


@pytest.mark.parametrize("policy", tad.POLICIES)
def test_plan_rounds_matches_reference(policy):
    """plan_rounds on a mid-run state of the gated-recycled family equals
    the reference's, for each policy."""
    jcfg, tcfg = make_cfgs("gated_recycled", policy=policy)
    lens = [T0, 2, 5]
    tiles = rand_traffic(tcfg, lens, seed=3)
    jst, jq, _, _ = reference_adaptive(jcfg, tiles, lens, n_passes=2)
    tst, tq, _, _ = port_adaptive(tcfg, tiles, lens, n_passes=2)
    for got, want in zip(tad.plan_rounds(tcfg, tst, tq),
                         jad.plan_rounds(jcfg, jst, jq)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in ((tad.undecided_depth(tad._quorum(tcfg, tst.core)),
                       jad.undecided_depth(jad._quorum(jcfg, jst.core))),
                      (tad._state_lag(tcfg, tst.core, tst.dissem, policy),
                       jad._state_lag(jcfg, jst.core, jst.dissem, policy))):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_plan_rounds_policy():
    """R scales with the lag spread, caps at K, is 1 under uniform load
    and 0 only at quiescence; k = min(R, backlog)."""
    _, cfg = make_cfgs("plain", K=4, thr=1)
    st = tapi.create_state(cfg, "cpu")
    acks, votes, _ = map(to_port, rand_traffic(cfg, [T0, 2, 2], seed=1))
    q = tad.queue_from_arrays(cfg, acks, votes, lengths=[T0, 2, 2])
    R, k = tad.plan_rounds(cfg, st, q)
    assert int(R) == 4 and k.tolist() == [4, 2, 2]
    q_u = tad.queue_from_arrays(cfg, acks, votes, lengths=[3, 3, 3])
    R_u, k_u = tad.plan_rounds(cfg, st, q_u)
    assert int(R_u) == 1 and k_u.tolist() == [1, 1, 1]
    R_e, _ = tad.plan_rounds(cfg, st, tad.init_queue(cfg, device="cpu"))
    assert int(R_e) == 0


@pytest.mark.parametrize("inplace", [False, True])
def test_queue_enqueue_backlog_dropped(inplace):
    """enqueue with a mask and into a full ring: backlog, dropped and the
    rings equal the reference's."""
    jcfg, tcfg = make_cfgs("gated")
    rng = np.random.default_rng(4)
    jq = jad.init_queue(jcfg, capacity=2)
    tq = tad.init_queue(tcfg, capacity=2, device="cpu")
    for mask in (None, [True, False, True], None):
        tiles = [rng.integers(0, 2**32, (G, W, 1), dtype=np.uint32)
                 for _ in range(3)]
        jq = jad.enqueue(jq, *map(to_ref, tiles),
                         mask=None if mask is None else jnp.asarray(mask))
        before = convert.queue_to_numpy(tq)
        new = tad.enqueue(tq, *map(to_port, tiles),
                          mask=None if mask is None else torch.tensor(mask),
                          inplace=inplace)
        if not inplace:
            assert_tree_equal(convert.queue_to_numpy(tq), before, "input")
        tq = new
        assert_tree_equal(convert.queue_to_numpy(tq), ref_tree(jq), "queue")
    assert tad.backlog(tq).tolist() == [2, 2, 2]
    assert tq.dropped.tolist() == [1, 0, 1]


def test_queue_refusals_match_reference():
    jcfg, tcfg = make_cfgs("gated")
    a, v = (np.zeros((T0, G, W, 1), np.uint32) for _ in range(2))
    msgs = []
    for ad, cfg, conv, q in (
            (jad, jcfg, to_ref, jad.init_queue(jcfg)),
            (tad, tcfg, to_port, tad.init_queue(tcfg, device="cpu"))):
        errs = []
        for call in (lambda: ad.enqueue(q, conv(a[0]), conv(v[0])),
                     lambda: ad.queue_from_arrays(cfg, conv(a), conv(v))):
            with pytest.raises(ValueError, match="hold") as e:
                call()
            errs.append(str(e.value))
        msgs.append(errs)
    assert msgs[1] == msgs[0]
    ungated = make_cfgs("plain")[1]
    for fn in (lambda: tad.init_queue(make_cfgs("plain", adaptive=None)[1],
                                      device="cpu"),
               lambda: tad.adaptive_pass(
                   ungated, tapi.create_state(ungated, "cpu"),
                   tad.init_queue(tcfg, device="cpu"))):
        with pytest.raises(ValueError):
            fn()


@pytest.mark.parametrize("kw", [
    dict(max_tiles_per_tick=0), dict(max_tiles_per_tick=2, policy="nope"),
    dict(max_tiles_per_tick=2, threshold=0),
    dict(max_tiles_per_tick=2, queue_capacity=0)])
def test_adaptive_config_rejects_like_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        jad.AdaptiveConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        tad.AdaptiveConfig(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_engine_config_takes_only_adaptive_config():
    msgs = []
    for api in (japi, tapi):
        with pytest.raises(ValueError, match="AdaptiveConfig") as e:
            api.EngineConfig(groups=2, window=8, n_diss=5, n_seq=3,
                             order_budget=2, merge_capacity=64,
                             adaptive=object())
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    a, b = (make_cfgs("gated")[1] for _ in range(2))
    assert a == b and hash(a) == hash(b)


def test_queue_conversion_round_trip():
    """A reference queue carried across equals the port's own
    queue_from_arrays; wrong shapes are refused."""
    jcfg, tcfg = make_cfgs("gated_recycled")
    tiles = rand_traffic(tcfg, [T0, 4, 7], seed=5)
    jq = jad.queue_from_arrays(jcfg, *map(to_ref, tiles),
                               lengths=jnp.asarray([T0, 4, 7], jnp.int32))
    got = convert.queue_from_numpy(tcfg, ref_tree(jq), "cpu")
    want = tad.queue_from_arrays(tcfg, *map(to_port, tiles),
                                 lengths=[T0, 4, 7])
    assert_tree_equal(convert.queue_to_numpy(got),
                      convert.queue_to_numpy(want))
    bad = dict(ref_tree(jq), holds=None)
    with pytest.raises(ValueError, match="holds"):
        convert.queue_from_numpy(tcfg, bad, "cpu")


def test_all_skip_round_entries():
    """An all-inactive round (assigned masked to -1) writes SKIP only."""
    assigned = torch.full((G, W), -1, dtype=torch.int32)
    sids = torch.arange(G * W, dtype=torch.int32).view(G, W)
    entries, n, dropped = tmerge.round_entries(assigned, sids, B)
    assert (entries == tmerge.SKIP).all() and entries.shape == (G, B)
    assert n.tolist() == [0] * G and dropped.tolist() == [0] * G


def test_engine_facade_enqueue_adaptive_pass():
    """Engine.enqueue + Engine.adaptive_pass against the reference's
    facade (every pass's outputs, the final state and queue), and
    against Engine.run on the drain-padded arrays."""
    jcfg, tcfg = make_cfgs("gated", K=3, policy="unstable")
    lens = [T0, 4, 7]
    tiles = rand_traffic(tcfg, lens, seed=2)
    ref_eng = tapi.Engine.create(tcfg, device="cpu")
    m_ref, c_ref, com_ref = ref_eng.run(*(to_port(pad(x)) for x in tiles))

    jeng = japi.Engine.create(jcfg)
    eng = tapi.Engine.create(tcfg, device="cpu")
    assert eng.queue is None
    for t in range(T0):
        mask = [t < n for n in lens]
        jeng.enqueue(*(to_ref(x[t]) for x in tiles), mask=jnp.asarray(mask))
        eng.enqueue(*(to_port(x[t]) for x in tiles), mask=torch.tensor(mask))
    rounds = []
    for _ in range(T0 + E):
        jout, out = jeng.adaptive_pass(), eng.adaptive_pass()
        for k in ("rounds", "consumed", "dropped"):
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
        rounds.append(int(out["rounds"]))
    assert rounds[-1] == 0          # quiesced
    assert_tree_equal(convert.engine_state_to_numpy(eng.state),
                      ref_tree(jeng.state))
    assert_tree_equal(convert.queue_to_numpy(eng.queue), ref_tree(jeng.queue))
    m, c, com = eng.committed()
    assert int(c) == int(c_ref) and int(com) == int(com_ref)
    assert torch.equal(m[:int(c)], m_ref[:int(c_ref)])
    with pytest.raises(ValueError, match="adaptive"):
        tapi.Engine.create(make_cfgs("gated", adaptive=None)[1],
                           device="cpu").adaptive_pass()


@pytest.mark.parametrize("fam", ["plain", "gated_recycled"])
def test_run_adaptive_before_quiescence(fam):
    """run_adaptive cut after 2 passes (the queue not yet drained)
    equals the reference's 2-pass scan: merged, committed, state,
    queue."""
    jcfg, tcfg = make_cfgs(fam, K=2, policy="backlog")
    lens = [T0, 1, 5]
    tiles = rand_traffic(tcfg, lens, seed=6)
    jst, jq, jm, jcom = reference_adaptive(jcfg, tiles, lens, n_passes=2)
    tst, tq, tm, tcom = port_adaptive(tcfg, tiles, lens, n_passes=2)
    assert np.array_equal(tm, jm) and tcom == jcom
    assert int((tq.tail - tq.head).sum()) > 0
    assert_tree_equal(convert.engine_state_to_numpy(tst), ref_tree(jst))
    assert_tree_equal(convert.queue_to_numpy(tq), ref_tree(jq), "queue")


@pytest.mark.parametrize("fam", FAMILIES)
def test_adaptive_pass_in_place_equals_functional(fam):
    """A functional pass leaves its inputs as they were; an in-place pass
    gives the same state and queue (the port's counterpart of
    tests/test_donation.py::test_adaptive_pass_donation_safe)."""
    _, cfg = make_cfgs(fam, K=3)
    lens = [T0, 3, 6]
    tiles = [to_port(x) for x in rand_traffic(cfg, lens, seed=7)]
    st = tapi.create_state(cfg, "cpu")
    q = tad.queue_from_arrays(cfg, *tiles, lengths=lens)
    for _ in range(2):              # a mid-run state, not a fresh one
        st, q, _ = tad.adaptive_pass(cfg, st, q)
    before = (convert.engine_state_to_numpy(st), convert.queue_to_numpy(q))
    a, qa, oa = tad.adaptive_pass(cfg, st, q)
    assert_tree_equal(convert.engine_state_to_numpy(st), before[0])
    assert_tree_equal(convert.queue_to_numpy(q), before[1], "queue")
    b, qb, ob = tad.adaptive_pass(cfg, st, q, inplace=True)

    def leaves(x):
        if isinstance(x, tuple):
            for v in x:
                yield from leaves(v)
        elif x is not None:
            yield x
    # the in-place pass wrote the engine state into its own buffers
    assert all(n is o for n, o in zip(leaves((b.core, b.dissem)),
                                      leaves((st.core, st.dissem))))
    assert_tree_equal(convert.engine_state_to_numpy(b),
                      convert.engine_state_to_numpy(a))
    assert_tree_equal(convert.queue_to_numpy(qb), convert.queue_to_numpy(qa))
    assert int(oa["rounds"]) == int(ob["rounds"]) > 1


@pytest.mark.parametrize("fam", ["gated", "gated_recycled", "recycled"])
def test_launches_are_two_and_one_per_round(monkeypatch, fam):
    """Each round calls the quorum pass twice and (gated) the stability
    pass once: 2·ΣR and ΣR over a run, whatever R each pass takes."""
    calls = {"quorum": 0, "stability": 0}
    quorum, stability = (tilesim.quorum_update_grouped,
                         tdissem.stability_update_grouped)

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(tilesim, "quorum_update_grouped",
                        counted("quorum", quorum))
    monkeypatch.setattr(tdissem, "stability_update_grouped",
                        counted("stability", stability))
    _, cfg = make_cfgs(fam, K=4)
    lens = [T0, 2, 5]
    tiles = [to_port(x) for x in rand_traffic(cfg, lens, seed=8)]
    eng = tapi.Engine.create(cfg, device="cpu")
    eng.queue = tad.queue_from_arrays(cfg, *tiles, lengths=lens)
    total = 0
    while (r := int(eng.adaptive_pass()["rounds"])) > 0:
        total += r
    assert total > T0 // 2
    assert calls == {"quorum": 2 * total,
                     "stability": total if cfg.gating is not None else 0}


# -- the pipeline's subtick mode ----------------------------------------------

PIPE_LAGS = dict(ack_lag=(0, 1, 1, 2, 2), hold_lag=(0, 0, 1, 1, 2),
                 vote_lag=(1, 2, 2))


def pipe_cfgs(adaptive_k, table=None, groups=2):
    """(reference, port) PipelineConfig of the reference suite's
    test_pipeline_adaptive_matches_lockstep (``adaptive_k`` None →
    lock-step)."""
    out = []
    for api, ad, P, E_ in ((japi, jad, JP, JE), (tapi, tad, TP, TE)):
        out.append(P.PipelineConfig(
            engine=api.EngineConfig(
                groups=groups, window=16, n_diss=5, n_seq=3, order_budget=4,
                merge_capacity=groups * 2048,
                recycling=api.RecyclingConfig(watermark=8, id_stride=4096),
                gating=api.GatingConfig(),
                epochs=None if table is None else E_.EpochTable(*table),
                adaptive=None if adaptive_k is None else ad.AdaptiveConfig(
                    max_tiles_per_tick=adaptive_k, policy="unstable")),
            n_clients=10, budget_bytes=2500, capacity=128,
            seq_capacity=64, **PIPE_LAGS))
    return out


@pytest.fixture(scope="module")
def drawn_workload():
    """The reference suite's workload: 25 ticks drawn with PRNGKey(7),
    then 15 quiet ticks."""
    T, quiesce = 40, 15
    wl = JP.WorkloadModel(n_clients=10, arrival_rate=0.6,
                          size_choices=(100, 400)).draw(
                              jax.random.PRNGKey(7), T)
    arrived = np.concatenate([np.asarray(wl.arrived[:T - quiesce]),
                              np.zeros((quiesce, 10), bool)])
    sizes = np.concatenate([np.asarray(wl.sizes[:T - quiesce]),
                            np.zeros((quiesce, 10), np.int32)])
    return arrived, sizes


def pipe_tree(state):
    out = {}
    for f, v in state._asdict().items():
        out[f] = convert.engine_state_to_numpy(v) if f == "engine" \
            else pipe_tree(v) if isinstance(v, tuple) else v.numpy()
    return out


def run_both_pipelines(adaptive_k, arrived, sizes):
    jcfg, tcfg = pipe_cfgs(adaptive_k)
    jst, jo = JP.run_pipeline(jcfg, JP.init_pipeline(jcfg),
                              jnp.asarray(arrived), jnp.asarray(sizes),
                              jnp.asarray(JP.build_route_table(jcfg)))
    tst, to = TP.run_pipeline(tcfg, TP.init_pipeline(tcfg, "cpu"),
                              torch.from_numpy(arrived),
                              torch.from_numpy(sizes),
                              torch.from_numpy(TP.build_route_table(tcfg)))
    return (jcfg, jst, jo), (tcfg, tst, to)


def test_pipeline_subtick_matches_reference_and_lockstep(drawn_workload):
    """The subtick mode equals the JAX pipeline's bit for bit (every state
    field, per-tick summaries, merged log), and against the port's
    lock-step pipeline it drains to the same admitted count, the same
    bid multiset and the same per-lane suborders."""
    arrived, sizes = drawn_workload
    (jcfg, jst, jo), (tcfg, tst, to) = run_both_pipelines(3, arrived,
                                                          sizes)
    assert_tree_equal(pipe_tree(tst), ref_tree(jst))
    for k in ("flushed", "admitted", "dropped"):
        assert np.array_equal(to[k].numpy(), np.asarray(jo[k])), k
    assert to["rounds"].max() > 1 and to["rounds"].min() >= 1
    for got, want in zip(TP.committed(tcfg, tst), JP.committed(jcfg, jst)):
        assert np.array_equal(got.numpy(), np.asarray(want))

    results = {}
    for name, k in (("lockstep", None), ("adaptive", 3)):
        cfg = pipe_cfgs(k)[1]
        st, outs = TP.run_pipeline(
            cfg, TP.init_pipeline(cfg, "cpu"), torch.from_numpy(arrived),
            torch.from_numpy(sizes),
            torch.from_numpy(TP.build_route_table(cfg)))
        assert int(outs["dropped"].sum()) == 0 and not bool(st.overflowed)
        merged, cnt, com = TP.committed(cfg, st)
        results[name] = (int(outs["admitted"].sum()), int(cnt), int(com),
                         TP.decode_merged(cfg, st, merged, com))
    adm_l, cnt_l, com_l, bids_l = results["lockstep"]
    adm_a, cnt_a, com_a, bids_a = results["adaptive"]
    assert adm_l == adm_a > 0
    assert cnt_l == adm_l == com_l and cnt_a == adm_a == com_a
    assert sorted(bids_l) == sorted(bids_a)
    for lane in {b[0] for b in bids_l}:
        sub_l = [b for b in bids_l if b[0] == lane]
        sub_a = [b for b in bids_a if b[0] == lane]
        assert sub_l == sub_a == sorted(sub_l, key=lambda b: b[1])


def test_pipeline_subtick_in_place_equals_functional(drawn_workload):
    arrived, sizes = drawn_workload
    cfg = pipe_cfgs(3)[1]
    rt = torch.from_numpy(TP.build_route_table(cfg))
    a, s = torch.from_numpy(arrived), torch.from_numpy(sizes)
    half, _ = TP.run_pipeline(cfg, TP.init_pipeline(cfg, "cpu"), a[:12],
                              s[:12], rt)
    before = pipe_tree(half)
    x, ox = TP.run_pipeline(cfg, half, a[12:], s[12:], rt)
    assert_tree_equal(pipe_tree(half), before)
    y, oy = TP.run_pipeline(cfg, half, a[12:], s[12:], rt, inplace=True)
    assert_tree_equal(pipe_tree(y), pipe_tree(x))
    assert torch.equal(ox["rounds"], oy["rounds"])


def test_pipeline_subtick_epoch_flip_matches_reference(drawn_workload):
    """G=3 subtick pipeline: segment, drain, flip (0, 1, 2) → (0, 1),
    segment, drain, on both sides; every state field and the merged log
    equal, the flip seals row 2, and everything admitted commits."""
    arrived, sizes = drawn_workload
    table = (((0, 1, 2), (0, 1)), 3)
    jcfg, tcfg = pipe_cfgs(3, table=table, groups=3)
    quiet = np.zeros((12, 10), bool), np.zeros((12, 10), np.int32)
    segs = [(arrived[:14], sizes[:14]), quiet,
            (arrived[14:25], sizes[14:25]), quiet]
    jst, tst = JP.init_pipeline(jcfg), TP.init_pipeline(tcfg, "cpu")
    for i, (a, s) in enumerate(segs):
        if i == 2:
            jst, jrep = JP.reconfigure_pipeline(jcfg, jst, 0, 1)
            tst, trep = TP.reconfigure_pipeline(tcfg, tst, 0, 1)
            assert trep["moved"] == jrep["moved"] == 0
            assert trep["removed"] == tuple(jrep["removed"]) == (2,)
        e = int(i >= 2)
        jst, _ = JP.run_pipeline(jcfg, jst, jnp.asarray(a), jnp.asarray(s),
                                 jnp.asarray(JP.build_route_table(jcfg, e)))
        tst, to = TP.run_pipeline(
            tcfg, tst, torch.from_numpy(a), torch.from_numpy(s),
            torch.from_numpy(TP.build_route_table(tcfg, e)))
        assert int(to["dropped"].sum()) == 0
        assert_tree_equal(pipe_tree(tst), ref_tree(jst), f"segment {i}")
    merged, cnt, com = TP.committed(tcfg, tst)
    for got, want in zip((merged, cnt, com), JP.committed(jcfg, jst)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    rs = tst.engine.core.rs
    assert int(rs.retired[2]) == int(rs.q.next_instance[2])
    assert int(com) == int(tst.admit_count.sum()) > 0
    assert not bool(tst.overflowed)


def test_pipeline_subtick_reference_orders_unadmitted_ids():
    """A fault of the reference, not of the port (ROADMAP queue 3): when
    a recycle in one round of a subtick pass remaps slots, the reference
    re-absorbs the tick's tiles by position in the later rounds, so a
    fresh, never-admitted id inherits a surviving slot's bits and is
    ordered. At G=2, W=32, watermark 16, 20 clients with 1000-byte
    budgets, the reference merges more ids than it admitted and cannot
    decode them; the port re-addresses the tiles to the live slot map,
    commits exactly what it admitted, and decodes to the lock-step
    pipeline's bids, each in the same group, each lane's batches in
    admission order within a group."""
    nc, T_on, T = 20, 20, 60
    rng = np.random.default_rng(1)
    arrived = np.concatenate([rng.random((T_on, nc)) < 0.5,
                              np.zeros((T - T_on, nc), bool)])
    sizes = np.where(arrived, rng.choice([100, 400], (T, nc)),
                     0).astype(np.int32)

    def cfgs(k):
        out = []
        for api, ad, P in ((japi, jad, JP), (tapi, tad, TP)):
            out.append(P.PipelineConfig(
                engine=api.EngineConfig(
                    groups=2, window=32, n_diss=5, n_seq=3, order_budget=4,
                    merge_capacity=2 * 4096,
                    recycling=api.RecyclingConfig(watermark=16,
                                                  id_stride=4096),
                    gating=api.GatingConfig(),
                    adaptive=None if k is None else ad.AdaptiveConfig(
                        max_tiles_per_tick=k, policy="unstable")),
                n_clients=nc, budget_bytes=1000, capacity=512,
                seq_capacity=128, **PIPE_LAGS))
        return out

    jcfg, tcfg = cfgs(4)
    jst, _ = JP.run_pipeline(jcfg, JP.init_pipeline(jcfg),
                             jnp.asarray(arrived), jnp.asarray(sizes),
                             jnp.asarray(JP.build_route_table(jcfg)))
    _, jcount, _ = JP.committed(jcfg, jst)
    assert int(jcount) > int(jst.admit_count.sum())
    with pytest.raises(ValueError, match="never admitted"):
        JP.decode_merged(jcfg, jst, *JP.committed(jcfg, jst)[::2])

    results, trees = [], []
    for cfg, inplace in ((tcfg, True), (cfgs(None)[1], False),
                         (tcfg, False)):
        st, outs = TP.run_pipeline(
            cfg, TP.init_pipeline(cfg, "cpu"), torch.from_numpy(arrived),
            torch.from_numpy(sizes),
            torch.from_numpy(TP.build_route_table(cfg)), inplace=inplace)
        if cfg is tcfg:
            trees.append(pipe_tree(st))
            if not inplace:
                continue
        merged, count, com = TP.committed(cfg, st)
        assert int(count) == int(com) == int(st.admit_count.sum()) > 0
        assert int(outs["dropped"].sum()) == 0 and not bool(st.overflowed)
        bids = TP.decode_merged(cfg, st, merged, com)
        ids = merged[:int(com)]
        results.append((bids, (ids[ids >= 0] // cfg.id_stride).tolist()))
    (bids_a, groups_a), (bids_l, groups_l) = results
    assert sorted(bids_a) == sorted(bids_l)
    # within a group, each lane's batches are ordered in admission order
    # in both modes; across groups the two modes interleave differently
    # (a lagging group's extra rounds order its batches earlier)
    for bids, groups in results:
        sub = {}
        for (lane, seq), g in zip(bids, groups):
            sub.setdefault((lane, g), []).append(seq)
        assert all(v == sorted(v) for v in sub.values())
    assert dict(zip(bids_a, groups_a)) == dict(zip(bids_l, groups_l))
    assert_tree_equal(trees[0], trees[1], "in place")
