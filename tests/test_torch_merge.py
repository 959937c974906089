"""repro_torch.engine.merge against repro.engine.merge and oracle_merge,
bit for bit: appends with capacity overflow, watermark counts (int32-max
guard included), merged prefix, entry extraction with dropped counts,
fixed-width rounds, and the commit gate with and without a retired
base."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.engine import merge as JM  # noqa: E402
from repro_torch.engine import merge as TM  # noqa: E402


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(a)


def assert_same(port, ref):
    p, r = port.numpy(), np.asarray(ref)
    assert p.dtype == r.dtype and p.shape == r.shape, (p.dtype, r.dtype)
    assert np.array_equal(p, r), (p, r)


def assert_merge_same(ps, rs):
    for f in TM.MergeState._fields:
        assert_same(getattr(ps, f), getattr(rs, f))


def test_constants_match():
    assert (TM.SKIP, TM.PAD, TM.RECONFIG) == (JM.SKIP, JM.PAD, JM.RECONFIG)


def random_log(seed, G, L, rounds, K):
    """Append ``rounds`` random entry rows (ids, SKIP and RECONFIG mixed)
    to both merges; capacity L small enough to overflow."""
    rng = np.random.default_rng(seed)
    ps, rs = TM.init_merge(G, L, "cpu"), JM.init_merge(G, L)
    assert_merge_same(ps, rs)
    for _ in range(rounds):
        entries = rng.integers(-3, 1000, (G, K)).astype(np.int32)
        counts = rng.integers(0, K + 1, (G,)).astype(np.int32)
        ps = TM.append_entries(ps, t(entries), t(counts))
        rs = JM.append_entries(rs, j(entries), j(counts))
        assert_merge_same(ps, rs)
    return ps, rs


@pytest.mark.parametrize("seed,G,L,rounds,K", [
    (0, 1, 16, 5, 3), (1, 2, 12, 6, 4), (2, 4, 8, 8, 2), (3, 3, 40, 4, 5)])
def test_append_merge_and_overflow_match(seed, G, L, rounds, K):
    ps, rs = random_log(seed, G, L, rounds, K)
    out, cnt = TM.merged_prefix(ps)
    rout, rcnt = JM.merged_prefix(rs)
    assert_same(out, rout)
    assert_same(cnt, rcnt)
    assert_same(TM.mergeable_counts(ps.watermarks),
                JM.mergeable_counts(rs.watermarks))
    # oracle: the stored logs up to each watermark, while nothing overflowed
    if int(ps.overflowed.sum()) == 0:
        logs = [ps.logs[g, :int(ps.watermarks[g])].tolist()
                for g in range(G)]
        assert out[:int(cnt)].tolist() == TM.oracle_merge(logs) \
            == JM.oracle_merge(logs)


def test_overflow_is_counted():
    ps, rs = random_log(5, 2, 4, 6, 3)
    assert int(ps.overflowed.sum()) > 0
    assert_merge_same(ps, rs)


@pytest.mark.parametrize("wm", [
    [0], [5], [3, 1, 4, 1, 5], [2**31 - 1, 2**31 - 1],
    [2**31 - 1, 0, 2**31 - 2], [7, 7, 7, 6]])
def test_mergeable_counts_int32_guard(wm):
    w = np.asarray(wm, np.int32)
    assert_same(TM.mergeable_counts(t(w)), JM.mergeable_counts(j(w)))


@pytest.mark.parametrize("max_entries", [1, 3, 8])
def test_entries_from_assigned_matches(max_entries):
    rng = np.random.default_rng(max_entries)
    G, W = 3, 20
    assigned = np.where(rng.random((G, W)) < 0.3,
                        rng.integers(0, 50, (G, W)), -1).astype(np.int32)
    ids = rng.integers(0, 10_000, (G, W)).astype(np.int32)
    got = TM.entries_from_assigned(t(assigned), t(ids), max_entries)
    want = JM.entries_from_assigned(j(assigned), j(ids), max_entries)
    for g, w in zip(got, want):
        assert_same(g, w)
    got = TM.round_entries(t(assigned), t(ids), max_entries)
    want = JM.round_entries(j(assigned), j(ids), max_entries)
    for g, w in zip(got, want):
        assert_same(g, w)
    if max_entries == 1:
        assert int(got[2].sum()) > 0           # the dropped path is hit


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("with_base", [False, True])
def test_committed_prefix_len_matches(seed, with_base):
    rng = np.random.default_rng(10 + seed)
    G, L, K = 3, 24, 4
    ps, rs = TM.init_merge(G, L, "cpu"), JM.init_merge(G, L)
    nxt = 0
    for _ in range(5):
        counts = rng.integers(0, K + 1, (G,)).astype(np.int32)
        entries = np.where(rng.random((G, K)) < 0.7,
                           np.arange(nxt, nxt + G * K).reshape(G, K),
                           TM.SKIP).astype(np.int32)
        nxt += G * K
        ps = TM.append_entries(ps, t(entries), t(counts))
        rs = JM.append_entries(rs, j(entries), j(counts))
    C = 16
    dec = rng.random((G, C)) < 0.8
    base = rng.integers(0, 6, (G,)).astype(np.int32) if with_base else None
    got = TM.committed_prefix_len(ps, t(dec),
                                  None if base is None else t(base))
    want = JM.committed_prefix_len(rs, j(dec),
                                   None if base is None else j(base))
    assert_same(got, want)
    all_dec = np.ones((G, C), bool)
    assert_same(TM.committed_prefix_len(ps, t(all_dec)),
                JM.merged_prefix(rs)[1])


def test_skip_rounds_never_emit():
    """All-SKIP and RECONFIG rounds hold positions but add nothing."""
    G = 2
    ps = TM.init_merge(G, 8, "cpu")
    rows = [[[1], [2]], [[TM.SKIP], [TM.SKIP]], [[3], [TM.RECONFIG]]]
    for r in rows:
        ps = TM.append_entries(ps, t(np.asarray(r, np.int32)),
                               t(np.ones(G, np.int32)))
    out, cnt = TM.merged_prefix(ps)
    assert out[:int(cnt)].tolist() == [1, 2, 3] \
        == TM.oracle_merge([[1, TM.SKIP, 3], [2, TM.SKIP, TM.RECONFIG]])
