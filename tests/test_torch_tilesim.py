"""repro_torch.core.tilesim against repro.core.jaxsim, bit for bit.

The port writes the group axis out ([G, W, ...]); the reference's
single-window functions are vmapped over G here to give the same
layout. Inputs come from a numpy seed; bitsets are compared through
their uint32 view."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import jaxsim  # noqa: E402
from repro_torch.convert import bits_from_numpy  # noqa: E402
from repro_torch.core import tilesim  # noqa: E402

G, W, D, S = 3, 24, 37, 5
DM, SM = D // 2 + 1, S // 2 + 1
BUDGETS = [None, 1, 4]


def to_np(x):
    """Port bitset tensor → its uint32 words."""
    return x.cpu().numpy().view(np.uint32)


def assert_same(port, ref):
    """Port NamedTuple/tensor equals the reference's, field by field."""
    if isinstance(port, tuple):
        assert type(port).__name__ == type(ref).__name__
        for f in port._fields:
            assert_same(getattr(port, f), getattr(ref, f))
        return
    r = np.asarray(ref)
    p = port.cpu().numpy()
    if r.dtype == np.uint32:               # bitsets: compare uint32 views
        p = p.view(np.uint32)
    assert p.dtype == r.dtype and p.shape == r.shape, (p.dtype, r.dtype)
    assert np.array_equal(p, r), (p, r)


def ref_state(st):
    """Port QuorumState → the reference's (leading-G) QuorumState."""
    return jaxsim.QuorumState(
        jnp.asarray(to_np(st.ack_bits)), jnp.asarray(to_np(st.vote_bits)),
        *(jnp.asarray(x.numpy()) for x in st[2:]))


def traffic(seed, ticks, p_ack=0.35, p_vote=0.5):
    rng = np.random.default_rng(seed)
    acks = rng.random((ticks, G, W, D)) < p_ack
    votes = rng.random((ticks, G, W, S)) < p_vote
    return acks, votes


def test_init_state_matches():
    got = tilesim.init_state(G, W, D, S, "cpu")
    single = jaxsim.init_state(W, D, S)
    want = jax.tree.map(lambda x: jnp.broadcast_to(x, (G,) + x.shape),
                        single)
    assert_same(got, want)


@pytest.mark.parametrize("d", [1, 31, 32, 33, 64, 65, 100])
def test_pack_tile_and_popcount_match(d):
    rng = np.random.default_rng(d)
    acks = rng.random((G, W, d)) < 0.5
    acks[0, 0] = True                     # all-ones words (bit 31 set)
    packed = tilesim.pack_tile(torch.from_numpy(acks))
    want = jax.vmap(jaxsim.pack_tile)(jnp.asarray(acks))
    assert np.array_equal(to_np(packed), np.asarray(want))
    assert np.array_equal(tilesim.popcount_rows(packed).numpy(),
                          np.asarray(jax.vmap(jaxsim.popcount_rows)(want)))


@pytest.mark.parametrize("order_budget", BUDGETS)
def test_tick_steps_match_each_function(order_budget):
    """Every packed core, step by step over several ticks: absorb acks,
    assign, absorb votes, the fused tick, and the admitted mask."""
    acks, votes = traffic(11, 6)
    st = tilesim.init_state(G, W, D, S, "cpu")
    ref = ref_state(st)
    for a, v in zip(acks, votes):
        pa, pv = tilesim.pack_tile(torch.from_numpy(a)), \
            tilesim.pack_tile(torch.from_numpy(v))
        ja, jv = jnp.asarray(to_np(pa)), jnp.asarray(to_np(pv))
        s1 = tilesim.absorb_acks_packed(st, pa, DM)
        r1 = jax.vmap(lambda s, u: jaxsim.absorb_acks_packed(s, u, DM))(
            ref, ja)
        assert_same(s1, r1)
        s2, asg = tilesim.assign_instances_core(s1, order_budget)
        r2, rasg = jax.vmap(
            lambda s: jaxsim.assign_instances_core(s, order_budget))(r1)
        assert_same(s2, r2)
        assert_same(asg, rasg)
        s3, newly = tilesim.absorb_votes_packed(s2, pv, SM)
        r3, rnewly = jax.vmap(
            lambda s, u: jaxsim.absorb_votes_packed(s, u, SM))(r2, jv)
        assert_same(s3, r3)
        assert_same(newly, rnewly)
        st, out = tilesim.engine_tick_packed(
            st, pa, pv, diss_majority=DM, seq_majority=SM,
            order_budget=order_budget)
        ref, rout = jax.vmap(lambda s, x, y: jaxsim.engine_tick_packed(
            s, x, y, diss_majority=DM, seq_majority=SM,
            order_budget=order_budget))(ref, ja, jv)
        assert_same(st, ref)
        for k in rout:
            assert_same(out[k], rout[k])
        assert_same(tilesim.admitted_mask(st), jaxsim.admitted_mask(ref))
    assert int(st.next_instance.sum()) > 0


@pytest.mark.parametrize("order_budget", BUDGETS)
def test_run_ticks_matches(order_budget):
    acks, votes = traffic(12, 5)
    st, outs = tilesim.run_ticks(
        tilesim.init_state(G, W, D, S, "cpu"), torch.from_numpy(acks),
        torch.from_numpy(votes), diss_majority=DM, seq_majority=SM,
        order_budget=order_budget)
    for g in range(G):
        rst, routs = jaxsim.run_ticks(
            jaxsim.init_state(W, D, S), jnp.asarray(acks[:, g]),
            jnp.asarray(votes[:, g]), diss_majority=DM, seq_majority=SM,
            order_budget=order_budget)
        assert_same(tilesim.QuorumState(*(x[g] for x in st)), rst)
        for k in routs:
            assert np.array_equal(outs[k][:, g].numpy(),
                                  np.asarray(routs[k]))


@pytest.mark.parametrize("seed", range(6))
def test_randomized_compaction_matches(seed):
    """Random traffic with random per-group ``enable`` masks through
    compaction_plan / compact_and_refill_packed / apply_compaction,
    recycling after every tick so retired bases and shifted instances
    accumulate."""
    rng = np.random.default_rng(100 + seed)
    acks, votes = traffic(200 + seed, 10, p_ack=0.5, p_vote=0.6)
    stride = 1 << 12
    st = tilesim.init_state(G, W, D, S, "cpu")
    ids = torch.arange(G, dtype=torch.int32)[:, None] * stride \
        + torch.arange(W, dtype=torch.int32)[None, :]
    retired = torch.zeros((G,), dtype=torch.int32)
    base = torch.arange(G, dtype=torch.int32) * stride
    budget = int(rng.integers(1, 8))
    n_retired = 0
    for t, (a, v) in enumerate(zip(acks, votes)):
        st, _ = tilesim.engine_tick_packed(
            st, tilesim.pack_tile(torch.from_numpy(a)),
            tilesim.pack_tile(torch.from_numpy(v)), diss_majority=DM,
            seq_majority=SM, order_budget=budget)
        enable_np = None if t % 4 == 3 else rng.random(G) < 0.6
        enable = None if enable_np is None else torch.from_numpy(enable_np)
        ref = ref_state(st)
        rret, rids, rbase = (jnp.asarray(x.numpy()) for x in
                             (retired, ids, base))
        plan = tilesim.compaction_plan(st, retired, enable)
        if enable is None:
            rplan = jax.vmap(jaxsim.compaction_plan)(ref, rret)
        else:
            rplan = jax.vmap(jaxsim.compaction_plan)(
                ref, rret, jnp.asarray(enable_np))
        assert_same(plan, rplan)
        fill = int(rng.integers(-3, 3))
        assert_same(tilesim.apply_compaction(plan, st.instance, fill),
                    jax.vmap(lambda p, f: jaxsim.apply_compaction(
                        p, f, fill))(rplan, ref.instance))
        args = (st, ids, retired, base) + (() if enable is None
                                           else (enable,))
        st, ids, retired, n_ret = tilesim.compact_and_refill_packed(*args)
        rargs = (ref, rids, rret, rbase) + (() if enable is None
                                            else (jnp.asarray(enable_np),))
        ref, rids, rret, rn = jax.vmap(jaxsim.compact_and_refill_packed)(
            *rargs)
        assert_same(st, ref)
        assert_same(ids, rids)
        assert_same(retired, rret)
        assert_same(n_ret, rn)
        n_retired += int(n_ret.sum())
    assert n_retired > 0


def test_compaction_shares_plan_with_aux_bitsets():
    """A precomputed plan moves an aux bitset field exactly as the
    reference moves it (the gated engine's hold bitsets)."""
    acks, votes = traffic(300, 4, p_ack=0.6, p_vote=0.8)
    st = tilesim.init_state(G, W, D, S, "cpu")
    for a, v in zip(acks, votes):
        st, _ = tilesim.engine_tick_packed(
            st, tilesim.pack_tile(torch.from_numpy(a)),
            tilesim.pack_tile(torch.from_numpy(v)), diss_majority=DM,
            seq_majority=SM)
    aux = np.random.default_rng(3).integers(0, 2**32, (G, W, 3),
                                            dtype=np.uint32)
    retired = torch.zeros((G,), dtype=torch.int32)
    plan = tilesim.compaction_plan(st, retired)
    got = tilesim.apply_compaction(plan, bits_from_numpy(aux, "cpu"), 0)
    rplan = jax.vmap(jaxsim.compaction_plan)(ref_state(st),
                                             jnp.zeros((G,), jnp.int32))
    want = jax.vmap(lambda p, f: jaxsim.apply_compaction(
        p, f, jnp.uint32(0)))(rplan, jnp.asarray(aux))
    assert_same(got, want)
    assert int(plan.adv.sum()) > 0
