"""The port's captured loops (repro_torch.engine.graphs) on the CPU.

CUDA graphs exist only on the card, so here each loop runs its step body
eagerly on the same static buffers (``graph=False``): what a replay
computes, and the CPU's own lock-step ``Engine.run`` and ``run_pipeline``.
Held against the JAX package bit for bit (merged log, count, committed
length, the whole final state, uint32 bitsets as uint32): ``Engine.run``
of all four families (the reference's ``api.run``, which runs the
family's ``run_*_ticks_merged`` scan); a second run stepping the same
loop; a state changed between runs by ``tick``, ``recycle`` or
``reconfigure``; ``run_pipeline`` across a 4 → 3 row flip; the fixed-K
adaptive pass and its loop (``graphs.engine_adaptive``) under skewed and
uniform traffic for every lag policy. The K-round pass equals the port's
eager R-round pass, an R = 0 pass is a no-op, and ``capture=True``
raises wherever it cannot capture."""
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
from repro_torch.engine import adaptive as tad  # noqa: E402
from repro_torch.engine import api as tapi  # noqa: E402
from repro_torch.engine import epochs as TE  # noqa: E402
from repro_torch.engine import graphs  # noqa: E402

G, W, D, SQ, B, T = 4, 32, 5, 3, 4, 14
STRIDE = 4096
FAMILIES = ["plain", "recycled", "gated", "gated_recycled"]


def configs(fam, *, epochs=False, adaptive=None, capacity=None):
    """(reference EngineConfig, port EngineConfig) of one family; with
    ``epochs``, the 4 → 3 row table; ``adaptive`` = (K, policy)."""
    out = []
    for api, ad, E in ((japi, jad, JE), (tapi, tad, TE)):
        kw = dict(groups=G, window=W, n_diss=D, n_seq=SQ, order_budget=B,
                  merge_capacity=capacity or 4 * T * B)
        if "recycled" in fam:
            kw["recycling"] = api.RecyclingConfig(watermark=W // 2,
                                                  id_stride=STRIDE)
        if "gated" in fam:
            kw["gating"] = api.GatingConfig(stab_majority=3)
        if epochs:
            kw["epochs"] = E.EpochTable(((0, 1, 2, 3), (0, 1, 2)), n_rows=G)
        if adaptive is not None:
            K, policy = adaptive
            kw["adaptive"] = ad.AdaptiveConfig(
                max_tiles_per_tick=K, policy=policy, queue_capacity=T)
        out.append(api.EngineConfig(**kw))
    assert out[0].family == out[1].family == fam
    return out


def tiles(seed, fam, lens=None):
    """uint32 [T, G, W, 1] acks, votes and (gated) holds; zero past each
    group's length when ``lens`` is given."""
    rng = np.random.default_rng(seed)
    out = [((rng.random((T, G, W, 1)) < p) * np.uint32(m)).astype(np.uint32)
           for p, m in ((0.7, 0x1F), (0.6, 0x7), (0.8, 0x1F))]
    if lens is not None:
        for x in out:
            for g, n in enumerate(lens):
                x[n:, g] = 0
    return out if "gated" in fam else out[:2] + [None]


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


def assert_results_equal(port, ref):
    """(merged, count, committed) of both sides."""
    assert int(port[1]) == int(ref[1]) and int(port[2]) == int(ref[2])
    assert np.array_equal(port[0].numpy(), np.asarray(ref[0]))


def engine_tree(state):
    return convert.engine_state_to_numpy(state)


def same_tensors(a, b) -> bool:
    return all(x is y for x, y in zip(graphs.leaves(a), graphs.leaves(b)))


# -- Engine.run ---------------------------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_captured_run_matches_reference(fam):
    """Engine.run through the loop of the tick equals the reference's
    fused run; the loop's static buffers are the engine's state."""
    jc, tc = configs(fam)
    acks, votes, holds = tiles(FAMILIES.index(fam), fam)
    js, *jres = japi.run(jc, japi.create_state(jc), to_ref(acks),
                         to_ref(votes), to_ref(holds))
    eng = tapi.Engine.create(tc, device="cpu")
    res = eng.run(to_port(acks), to_port(votes), to_port(holds))
    assert_results_equal(res, jres)
    assert_tree_equal(engine_tree(eng.state), ref_tree(js))
    assert int(res[2]) > 0
    loop, = eng._loops.values()
    assert same_tensors(loop.state, eng.state)
    assert loop.replays == T and int(loop.dropped) == 0


@pytest.mark.parametrize("fam", FAMILIES)
def test_second_run_replays_the_same_loop(fam):
    """Two runs on one engine: one loop, stepped 2T times; the result
    equals the reference's two runs on its carried state."""
    jc, tc = configs(fam)
    acks, votes, holds = tiles(10 + FAMILIES.index(fam), fam)
    half = T // 2
    js = japi.create_state(jc)
    eng = tapi.Engine.create(tc, device="cpu")
    for sl in (slice(0, half), slice(half, T)):
        js, *jres = japi.run(jc, js, *(None if x is None else to_ref(x[sl])
                                       for x in (acks, votes, holds)))
        res = eng.run(*(None if x is None else to_port(x[sl])
                        for x in (acks, votes, holds)))
        assert_results_equal(res, jres)
    loop, = eng._loops.values()
    assert loop.replays == T
    assert_tree_equal(engine_tree(eng.state), ref_tree(js))


def _between(fam, how):
    """(reference step, port step) applied between two runs."""
    if how == "tick":
        def ref(jc, js, t):
            return japi.tick(jc, js, *t)[0]

        def port(eng, t):
            eng.tick(*t)
    elif how == "recycle":
        def ref(jc, js, t):
            return japi.recycle(jc, js)[0]

        def port(eng, t):
            eng.recycle()
    else:
        def ref(jc, js, t):
            return japi.reconfigure(jc, js, 0, 1)[0]

        def port(eng, t):
            eng.reconfigure(1)
    return ref, port


BETWEEN = [(f, h) for f in FAMILIES for h in ("tick", "recycle",
                                              "reconfigure")
           if not (h == "recycle" and "recycled" not in f)
           and not (h == "reconfigure" and f == "gated")]


@pytest.mark.parametrize("fam,how", BETWEEN)
def test_state_changed_between_runs_is_seen(fam, how):
    """A tick, recycle or reconfigure between two runs replaces state
    leaves outside the loop: the next run copies them into its static
    buffers and equals the reference's sequence, bit for bit, as does
    the functional api.run's engine."""
    jc, tc = configs(fam, epochs=how == "reconfigure")
    acks, votes, holds = tiles(20 + FAMILIES.index(fam), fam)
    if how == "reconfigure":
        # row 3, which the flip removes, gets no traffic (it is drained),
        # and the other rows keep unadmitted slots for re-homed ids
        for x in (acks, votes, holds):
            if x is not None:
                x[:, 3] = 0
                x[:, :, W // 2:] = 0
    half = T // 2
    extra = [None if x is None else x[half] for x in (acks, votes, holds)]
    ref_step, port_step = _between(fam, how)
    js = japi.create_state(jc)
    js, *_ = japi.run(jc, js, *(None if x is None else to_ref(x[:half])
                                for x in (acks, votes, holds)))
    js = ref_step(jc, js, [to_ref(x) for x in extra])
    js, *jres = japi.run(jc, js, *(None if x is None else to_ref(x[half:])
                                   for x in (acks, votes, holds)))
    eng = tapi.Engine.create(tc, device="cpu")

    def seqs(sl):
        return [None if x is None else to_port(x[sl])
                for x in (acks, votes, holds)]
    eng.run(*seqs(slice(0, half)))
    port_step(eng, [to_port(x) for x in extra])
    loop, = eng._loops.values()
    assert not same_tensors(loop.state, eng.state)
    res = eng.run(*seqs(slice(half, T)))
    assert_results_equal(res, jres)
    assert_tree_equal(engine_tree(eng.state), ref_tree(js))
    assert same_tensors(loop.state, eng.state)
    # the functional api.run (the family's run_*_ticks_merged) agrees
    base = tapi.Engine(tc, tapi.run(tc, tapi.create_state(tc, "cpu"),
                                    *seqs(slice(0, half)))[0])
    port_step(base, [to_port(x) for x in extra])
    fst, *fres = tapi.run(tc, base.state, *seqs(slice(half, T)))
    assert_results_equal(fres, jres)
    assert_tree_equal(engine_tree(fst), ref_tree(js))


def test_capture_true_raises_where_it_cannot_capture():
    """CUDA graphs do not exist on the CPU; the subtick pipeline stays
    eager; the default is eager on the CPU."""
    _, tc = configs("gated_recycled", adaptive=(4, "backlog"))
    with pytest.raises(ValueError, match="CUDA device"):
        tapi.Engine.create(tc, device="cpu", capture=True)
    eng = tapi.Engine.create(tc, device="cpu")
    assert eng.capture is False
    assert tapi.Engine.create(tc, device="cpu", capture=False).capture \
        is False
    with pytest.raises(ValueError, match="CUDA"):
        graphs.CapturedLoop(graphs.engine_body(tc), eng.state, graph=True)
    q = tad.init_queue(tc, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tad.run_adaptive(tc, eng.state, q, n_passes=1, capture=True)
    pcfg = pipeline_cfg(TP, tapi, TE)
    st = TP.init_pipeline(pcfg, "cpu")
    a = torch.zeros((2, pcfg.n_clients), dtype=torch.bool)
    s = torch.zeros((2, pcfg.n_clients), dtype=torch.int32)
    rt = torch.from_numpy(TP.build_route_table(pcfg))
    with pytest.raises(ValueError, match="CUDA device"):
        TP.run_pipeline(pcfg, st, a, s, rt, capture=True)
    sub = pipeline_cfg(TP, tapi, TE, adaptive=tad.AdaptiveConfig(2))
    with pytest.raises(ValueError, match="subtick"):
        TP.run_pipeline(sub, TP.init_pipeline(sub, "cpu"), a, s, rt,
                        capture=True)


def test_loop_refuses_changed_shapes():
    """A state of other shapes is not loaded into a loop, and a step that
    changes a leaf's shape raises."""
    _, tc = configs("plain")
    eng = tapi.Engine.create(tc, device="cpu")
    acks, votes, _ = tiles(0, "plain")
    eng.run(to_port(acks), to_port(votes))
    loop, = eng._loops.values()
    _, other = configs("plain", capacity=8 * T * B)
    with pytest.raises(ValueError, match="shapes"):
        loop.load(tapi.create_state(other, "cpu"))

    def grows(state, tiles, consts):
        return state._replace(merge=state.merge._replace(
            watermarks=torch.zeros((G + 1,), dtype=torch.int32))), \
            {"dropped": torch.zeros((), dtype=torch.int32)}
    bad = graphs.CapturedLoop(grows, tapi.create_state(tc, "cpu"),
                              graph=False)
    with pytest.raises(ValueError, match="changed a state leaf"):
        bad.step()


def test_write_back_reads_every_source_before_writing():
    """A step whose new leaves are each other's old buffers (a swap)
    writes both right: a source that is a static buffer is copied
    first."""
    a, b = torch.arange(4), torch.arange(4, 8)
    graphs.write_back([a, b], [b, a])
    assert a.tolist() == [4, 5, 6, 7] and b.tolist() == [0, 1, 2, 3]
    c = torch.arange(3)
    graphs.write_back([c], [c])            # the same buffer: no copy
    assert c.tolist() == [0, 1, 2]


def test_loop_owns_aliased_leaves():
    """A state two of whose leaves are one tensor gets its own buffer for
    the second, so each leaf's step lands in a buffer of its own."""
    x = torch.arange(4)

    def body(state, tiles, consts):
        a, b = state
        return (a + 1, b + 10), {"dropped": torch.zeros((), dtype=torch.int32)}
    loop = graphs.CapturedLoop(body, (x, x), graph=False)
    assert loop.state[0] is x and loop.state[1] is not x
    loop.step()
    assert loop.state[0].tolist() == [1, 2, 3, 4]
    assert loop.state[1].tolist() == [10, 11, 12, 13]


# -- the pipeline -------------------------------------------------------------

def pipeline_cfg(P, api, E, **over):
    return P.PipelineConfig(
        engine=api.EngineConfig(
            groups=G, window=16, n_diss=5, n_seq=3, order_budget=4,
            merge_capacity=G * 256,
            recycling=api.RecyclingConfig(watermark=8, id_stride=4096),
            gating=api.GatingConfig(),
            epochs=E.EpochTable(((0, 1, 2, 3), (0, 1, 2)), n_rows=G),
            **over),
        n_clients=10, budget_bytes=2500, ack_lag=(0, 1, 1, 2, 2),
        hold_lag=(0, 0, 1, 1, 2), vote_lag=(1, 1, 2), capacity=128,
        seq_capacity=64)


def ticked_pipeline(cfg, state, arrived, sizes, rt):
    """The pipeline ticked one pipeline_tick at a time: what run_pipeline
    computes, its summaries stacked."""
    outs = []
    for a, s in zip(arrived, sizes):
        state, out = TP.pipeline_tick(cfg, state, a, s, rt)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs])
                   for k in ("flushed", "admitted", "dropped")}


def pipeline_tree(state):
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        out[f] = (engine_tree(v) if f == "engine" else pipeline_tree(v)
                  if isinstance(v, tuple) else v.numpy())
    return out


@pytest.mark.parametrize("inplace", [False, True])
def test_captured_pipeline_across_flip_matches_reference(inplace):
    """Segment A at epoch 0, a drain, the 4 → 3 row flip, segment B at
    epoch 1, a drain: the captured runs (their route table copied into
    the loop's buffer) equal the reference's run, summaries included;
    both segments step the one loop kept in the caller's dict."""
    jcfg, tcfg = pipeline_cfg(JP, japi, JE), pipeline_cfg(TP, tapi, TE)
    rng = np.random.default_rng(2)
    arrived = rng.random((24, 10)) < 0.4
    sizes = np.where(arrived, rng.choice([200, 900, 1800], (24, 10)),
                     0).astype(np.int32)
    ja, js_ = jnp.asarray(arrived), jnp.asarray(sizes)
    ta, ts_ = torch.from_numpy(arrived), torch.from_numpy(sizes)
    rts = [TP.build_route_table(tcfg, e) for e in (0, 1)]
    jq = (jnp.zeros((10,), bool), jnp.zeros((10,), jnp.int32))
    tq = (torch.zeros((10,), dtype=torch.bool),
          torch.zeros((10,), dtype=torch.int32))
    jst, tst = JP.init_pipeline(jcfg), TP.init_pipeline(tcfg, "cpu")
    loops = {}
    for epoch, sl in ((0, slice(0, 12)), (1, slice(12, 24))):
        if epoch:
            jst, jrep = JP.reconfigure_pipeline(jcfg, jst, 0, 1)
            tst, trep = TP.reconfigure_pipeline(tcfg, tst, 0, 1)
            assert trep["moved"] == jrep["moved"] == 0
        jrt, trt = jnp.asarray(rts[epoch]), torch.from_numpy(rts[epoch])
        jst, jouts = JP.run_pipeline(jcfg, jst, ja[sl], js_[sl], jrt)
        tst, touts = TP.run_pipeline(tcfg, tst, ta[sl], ts_[sl], trt,
                                     inplace=inplace, loops=loops)
        for k in jouts:
            assert np.array_equal(touts[k].numpy(), np.asarray(jouts[k])), k
        for _ in range(12):
            jst, _ = JP.pipeline_tick_jit(jcfg, jst, *jq, jrt)
            tst, _ = TP.pipeline_tick(tcfg, tst, *tq, trt, inplace=inplace)
        assert_tree_equal(pipeline_tree(tst), ref_tree(jst))
    merged, count, com = TP.committed(tcfg, tst)
    for got, want in zip((merged, count, com), JP.committed(jcfg, jst)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(com) == int(tst.admit_count.sum()) > 0
    # one loop: segment B's run stepped the loop of segment A (the same
    # length), its new table copied in
    loop, = loops.values()
    assert loop.replays == 24


def test_captured_pipeline_leaves_input_alone():
    """Without ``inplace`` the caller's state is not written; with it the
    result lands in the caller's tensors."""
    tcfg = pipeline_cfg(TP, tapi, TE)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.random((8, 10)) < 0.5)
    s = torch.where(a, 900, 0).to(torch.int32)
    rt = torch.from_numpy(TP.build_route_table(tcfg))
    st = TP.init_pipeline(tcfg, "cpu")
    before = pipeline_tree(st)
    out, _ = TP.run_pipeline(tcfg, st, a, s, rt)
    assert_tree_equal(pipeline_tree(st), before)
    want, _ = ticked_pipeline(tcfg, TP.init_pipeline(tcfg, "cpu"), a, s, rt)
    assert_tree_equal(pipeline_tree(out), pipeline_tree(want))
    back, _ = TP.run_pipeline(tcfg, st, a, s, rt, inplace=True)
    assert back is st and same_tensors(back, st)
    assert_tree_equal(pipeline_tree(st), pipeline_tree(want))


def test_captured_pipeline_loop_serves_shorter_runs():
    """A loop kept for a run of T ticks serves any run of at most T (its
    summaries sliced to the run); a longer run builds a new loop in its
    place. Every run equals the one ticked by pipeline_tick, and a kept
    loop's buffers are not handed out without ``inplace``."""
    tcfg = pipeline_cfg(TP, tapi, TE)
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.random((12, 10)) < 0.5)
    s = torch.where(a, 900, 0).to(torch.int32)
    rt = torch.from_numpy(TP.build_route_table(tcfg))
    loops = {}
    seen = []
    for T in (8, 5, 12):
        got = TP.run_pipeline(tcfg, TP.init_pipeline(tcfg, "cpu"), a[:T],
                              s[:T], rt, loops=loops)
        want = ticked_pipeline(tcfg, TP.init_pipeline(tcfg, "cpu"), a[:T],
                               s[:T], rt)
        assert_tree_equal(pipeline_tree(got[0]), pipeline_tree(want[0]))
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), (T, k)
        loop, = loops.values()
        assert not same_tensors(got[0], loop.state)
        seen.append(loop)
    assert seen[1] is seen[0] and seen[2] is not seen[0]
    assert seen[0].length == 8 and seen[2].length == 12


# -- adaptive -----------------------------------------------------------------

SCENARIOS = {"skew": [T, T // 4, T // 4, T // 4], "uniform": [T // 2] * G}


@pytest.mark.parametrize("policy", tad.POLICIES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_captured_adaptive_matches_reference(scenario, policy):
    """The gated-recycled engine: passes of the fixed-K pass's loop (the
    captured Engine.adaptive_pass's, graphs.engine_adaptive) until R = 0
    give every R, the state and the queue of the reference's passes; the
    loop stepped n_passes past quiescence with no host read (the captured
    run_adaptive's) equals the reference's run_adaptive."""
    lens = SCENARIOS[scenario]
    jc, tc = configs("gated_recycled", adaptive=(4, policy),
                     capacity=8 * T * B)
    acks, votes, holds = tiles(40 + tad.POLICIES.index(policy), "gated",
                               lens)
    jst = japi.create_state(jc)
    jq = jad.queue_from_arrays(jc, to_ref(acks), to_ref(votes),
                               to_ref(holds),
                               lengths=jnp.asarray(lens, jnp.int32))
    eng = tapi.Engine.create(tc, device="cpu")
    eng.queue = tad.queue_from_arrays(tc, to_port(acks), to_port(votes),
                                      to_port(holds), lengths=lens)
    rounds = []
    ref_pass = jax.jit(jad.adaptive_pass, static_argnames=("cfg",))
    for _ in range(4 * T):
        jst, jq, jout = ref_pass(jc, jst, jq)
        out = graphs.engine_adaptive(eng)
        for k in ("rounds", "consumed", "dropped"):
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
        rounds.append(int(out["rounds"]))
        if rounds[-1] == 0:
            break
    assert rounds[-1] == 0 and max(rounds) >= 1
    assert_tree_equal(engine_tree(eng.state), ref_tree(jst))
    assert_tree_equal(convert.queue_to_numpy(eng.queue), ref_tree(jq),
                      "queue")
    # n passes with no host read
    n = len(rounds) + 3
    jst2, jq2, *jres = jad.run_adaptive(
        jc, japi.create_state(jc), jad.queue_from_arrays(
            jc, to_ref(acks), to_ref(votes), to_ref(holds),
            lengths=jnp.asarray(lens, jnp.int32)), n_passes=n)
    eng2 = tapi.Engine.create(tc, device="cpu")
    eng2.queue = tad.queue_from_arrays(tc, to_port(acks), to_port(votes),
                                       to_port(holds), lengths=lens)
    tres = graphs.engine_adaptive(eng2, n)
    assert_results_equal(tres, jres)
    assert_tree_equal(engine_tree(eng2.state), ref_tree(jst2))
    assert_tree_equal(convert.queue_to_numpy(eng2.queue), ref_tree(jq2),
                      "queue")
    assert int(tres[2]) > 0


@pytest.mark.parametrize("policy", tad.POLICIES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_fixed_pass_equals_eager_pass(fam, policy):
    """adaptive_pass(fixed=True), K rounds masked by j < R, equals the
    eager R-round pass after every pass, R = 0 passes included (a no-op);
    its loop stepped with no host read (the captured Engine.run_adaptive's)
    equals the eager facade's run_adaptive."""
    _, tc = configs(fam, adaptive=(4, policy), capacity=8 * T * B)
    lens = SCENARIOS["skew"]
    acks, votes, holds = tiles(50 + FAMILIES.index(fam), fam, lens)

    def fresh():
        return (tapi.create_state(tc, "cpu"), tad.queue_from_arrays(
            tc, to_port(acks), to_port(votes), to_port(holds),
            lengths=lens))
    (se, qe), (sf, qf) = fresh(), fresh()
    seen = []
    while seen.count(0) < 2:
        se, qe, oe = tad.adaptive_pass(tc, se, qe)
        sf, qf, of = tad.adaptive_pass(tc, sf, qf, fixed=True)
        for k in oe:
            assert torch.equal(oe[k], of[k]), k
        assert_tree_equal(engine_tree(sf), engine_tree(se))
        assert_tree_equal(convert.queue_to_numpy(qf),
                          convert.queue_to_numpy(qe), "queue")
        seen.append(int(oe["rounds"]))
        assert len(seen) <= 4 * T
    # under backlog the skew runs both R = K and 0 < R < K passes
    assert policy != "backlog" or (4 in seen and set(seen) & {1, 2, 3})
    eager = tapi.Engine.create(tc, device="cpu")
    looped = tapi.Engine.create(tc, device="cpu")
    for e in (eager, looped):
        e.queue = fresh()[1]
    want = eager.run_adaptive(len(seen))
    got = graphs.engine_adaptive(looped, len(seen))
    assert_results_equal(got, want)
    assert_tree_equal(engine_tree(looped.state), engine_tree(eager.state))


def test_adaptive_state_changed_between_passes_is_seen():
    """An enqueue and an eager tick between passes of the fixed-K loop
    reach its buffers: the passes equal the eager facade's."""
    _, tc = configs("gated_recycled", adaptive=(4, "backlog"),
                    capacity=8 * T * B)
    acks, votes, holds = tiles(60, "gated", [T // 2] * G)
    tile = [to_port(x[0]) for x in (acks, votes, holds)]
    results = []
    for looped in (False, True):
        eng = tapi.Engine.create(tc, device="cpu")
        rounds = []

        def passes(n):
            for _ in range(n):
                out = graphs.engine_adaptive(eng) if looped \
                    else eng.adaptive_pass()
                rounds.append(int(out["rounds"]))
        for t in range(3):
            eng.enqueue(*(to_port(x[t]) for x in (acks, votes, holds)))
        passes(2)
        eng.tick(tile[0], tile[1], tile[2])
        for t in range(3, 6):
            eng.enqueue(*(to_port(x[t]) for x in (acks, votes, holds)))
        passes(5)
        results.append((rounds, engine_tree(eng.state),
                        convert.queue_to_numpy(eng.queue)))
    (r0, s0, q0), (r1, s1, q1) = results
    assert r1 == r0 and sum(r0) > 0
    assert_tree_equal(s1, s0)
    assert_tree_equal(q1, q0, "queue")
