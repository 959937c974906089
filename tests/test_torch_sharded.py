"""repro_torch.engine.sharded against repro.engine.sharded, bit for bit,
for the family functions the facade does not reach directly: the
unmerged tick scan, the gated tick's outputs, the gated recycle pass
with either ``fresh_stable``, and the validation and no-drop checks."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.engine import sharded as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.engine import sharded as TS  # noqa: E402

G, W, D, SQ, T = 2, 16, 5, 3, 10
DM, SM, STAB, B = 3, 2, 3, 3
STRIDE = 4096


def tiles(seed):
    rng = np.random.default_rng(seed)
    acks = ((rng.random((T, G, W, 1)) < 0.7) * np.uint32(0x1F))
    votes = ((rng.random((T, G, W, 1)) < 0.6) * np.uint32(0x7))
    holds = ((rng.random((T, G, W, 1)) < 0.5) * np.uint32(0x1F))
    return [x.astype(np.uint32) for x in (acks, votes, holds)]


def port(x):
    return convert.bits_from_numpy(x, "cpu")


def ref_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_equal(port_state, ref_state):
    got = convert.engine_state_to_numpy(port_state)
    want = ref_np(ref_state)

    def walk(g, w, path):
        if isinstance(g, dict):
            for f in g:
                walk(g[f], getattr(w, f), f"{path}.{f}")
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), path
    walk(got, want, type(port_state).__name__)


@pytest.mark.parametrize("order_budget", [None, 1, 4])
def test_run_sharded_ticks_matches(order_budget):
    acks, votes, _ = tiles(0)
    st, outs = TS.run_sharded_ticks(
        TS.init_sharded(G, W, D, SQ, "cpu"), port(acks), port(votes),
        diss_majority=DM, seq_majority=SM, order_budget=order_budget)
    rst, routs = JS.run_sharded_ticks(
        JS.init_sharded(G, W, D, SQ), jnp.asarray(acks), jnp.asarray(votes),
        diss_majority=DM, seq_majority=SM, order_budget=order_budget)
    assert_tree_equal(st, rst)
    for k in routs:
        assert np.array_equal(outs[k].numpy(), np.asarray(routs[k])), k


def test_gated_tick_outputs_match():
    acks, votes, holds = tiles(1)
    st, d = TS.init_sharded(G, W, D, SQ, "cpu"), \
        TS.init_dissem(G, W, D, device="cpu")
    rst, rd = JS.init_sharded(G, W, D, SQ), JS.init_dissem(G, W, D)
    for t in range(T):
        st, d, out = TS.gated_tick(
            st, d, port(acks[t]), port(holds[t]), port(votes[t]),
            diss_majority=DM, seq_majority=SM, stab_majority=STAB,
            order_budget=B)
        rst, rd, rout = JS.gated_tick(
            rst, rd, jnp.asarray(acks[t]), jnp.asarray(holds[t]),
            jnp.asarray(votes[t]), diss_majority=DM, seq_majority=SM,
            stab_majority=STAB, order_budget=B)
        assert set(out) == set(rout)
        for k in rout:
            assert np.array_equal(out[k].numpy(), np.asarray(rout[k])), k
    assert_tree_equal(st, rst)
    assert_tree_equal(d, rd)


@pytest.mark.parametrize("fresh_stable", [False, True])
@pytest.mark.parametrize("watermark", [4, W])
def test_gated_recycle_groups_matches(fresh_stable, watermark):
    """Tick without recycling, then one explicit gated recycle pass: the
    shared plan must move quorum and dissemination windows as the
    reference does, and reborn slots get ``fresh_stable``."""
    acks, votes, holds = tiles(2)
    gs = TS.init_gated_recycled(G, W, D, SQ, id_stride=STRIDE, device="cpu")
    rgs = JS.init_gated_recycled(G, W, D, SQ, id_stride=STRIDE)
    for t in range(T):
        q, d, _ = TS.gated_tick(
            gs.rs.q, gs.d, port(acks[t]), port(holds[t]), port(votes[t]),
            diss_majority=DM, seq_majority=SM, stab_majority=STAB,
            order_budget=B)
        gs = TS.GatedRecycleState(rs=gs.rs._replace(q=q), d=d)
        rq, rd, _ = JS.gated_tick(
            rgs.rs.q, rgs.d, jnp.asarray(acks[t]), jnp.asarray(holds[t]),
            jnp.asarray(votes[t]), diss_majority=DM, seq_majority=SM,
            stab_majority=STAB, order_budget=B)
        rgs = JS.GatedRecycleState(rs=rgs.rs._replace(q=rq), d=rd)
    gs, n = TS.gated_recycle_groups(gs, watermark=watermark,
                                    id_stride=STRIDE,
                                    fresh_stable=fresh_stable)
    rgs, rn = JS.gated_recycle_groups(rgs, watermark=watermark,
                                      id_stride=STRIDE,
                                      fresh_stable=fresh_stable)
    assert np.array_equal(n.numpy(), np.asarray(rn))
    assert_tree_equal(gs, rgs)
    if watermark == W:
        assert int(n.sum()) > 0


def test_validation_messages_match():
    with pytest.raises(ValueError) as ref:
        JS.init_recycled(2, W, D, SQ)
    with pytest.raises(ValueError) as got:
        TS.init_recycled(2, W, D, SQ, device="cpu")
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        JS._resolve_max_entries(2, 3)
    with pytest.raises(ValueError) as got:
        TS._resolve_max_entries(2, 3)
    assert str(got.value) == str(ref.value)
    assert TS._resolve_max_entries(None, 3) == 3


def test_assert_no_dropped_raises_on_truncation():
    TS._assert_no_dropped(torch.tensor(0, dtype=torch.int32))
    with pytest.raises(AssertionError, match="truncated"):
        TS._assert_no_dropped(torch.tensor(2, dtype=torch.int32))
