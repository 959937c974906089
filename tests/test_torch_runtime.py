"""The port's runtime (repro_torch.runtime: the trainer state machine,
quorum-committed checkpoints, the ordered data feed, membership and
straggler bookkeeping) against the JAX package's, on the CPU.

Digests are compared as equal hex strings, and checkpoints restore leaf
for leaf (``np.array_equal`` on the native bytes) in both directions:
the guarantees here are bitwise, so nothing is held to a tolerance.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import invariants as jinv  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro.runtime import membership as jmem  # noqa: E402
from repro.runtime import straggler as jstrag  # noqa: E402
from repro.runtime.statemachine import tree_digest as jdigest  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import invariants  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime import membership, straggler  # noqa: E402
from repro_torch.runtime.data import (OrderedDataFeed,  # noqa: E402
                                      ShardedBatchSource)
from repro_torch.runtime.statemachine import (  # noqa: E402
    Command, MergedCommandLog, TrainerStateMachine, tree_digest)
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

LR = 1e-3


def _pair(arch, kind, dtype):
    """The reference's smoke train state in ``dtype`` (bf16 or f32) and
    the port's copy of it."""
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    jcfg = jregistry.get_smoke(arch).replace(dtype=jdt)
    cfg = registry.get_smoke(arch).replace(dtype=tdt)
    jstate, _ = JTR.make_state(jcfg, JO.OptConfig(kind=kind, lr=LR),
                               key=jax.random.PRNGKey(3))
    # a non-zero optimizer state and step, so that every leaf is hashed
    jstate["opt"] = jax.tree.map(lambda a: a + 0.25, jstate["opt"])
    jstate["step"] = jnp.int32(7)
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         cfg, "cpu")
    return jstate, state, cfg


def _same(a, b) -> bool:
    """Leaf for leaf equal, native bytes (bf16 as its 2-byte pattern)."""
    fa, fb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(fa) == len(fb) and all(
        np.asarray(x).dtype.itemsize == np.asarray(y).dtype.itemsize
        and np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for x, y in zip(fa, fb))


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-3b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("kind,dtype", [("adamw", "bf16"),
                                        ("adafactor", "bf16"),
                                        ("adamw", "f32")])
def test_tree_digest_equals_reference(arch, kind, dtype):
    jstate, state, _ = _pair(arch, kind, dtype)
    assert tree_digest(state["params"]) == jdigest(jstate["params"])
    assert tree_digest(state) == jdigest(jstate)
    assert _same(convert.train_state_to_numpy(state),
                 jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_checkpoints_restore_across_packages(kind, tmp_path):
    """A bf16 state saved by the port restores in the reference, and one
    saved by the reference restores in the port, leaf for leaf."""
    jstate, state, cfg = _pair("yi-6b", kind, "bf16")
    m = ckpt.save_sharded(state, str(tmp_path / "port"), 7)
    jm = jckpt.save_sharded(jstate, str(tmp_path / "jax"), 7)
    assert m["committed"] and jm["committed"]
    assert m["digest"] == jm["digest"] and m["n_leaves"] == jm["n_leaves"]
    fresh_j, _ = JTR.make_state(
        jregistry.get_smoke("yi-6b"), JO.OptConfig(kind=kind),
        key=jax.random.PRNGKey(9))
    restored_j, _ = jckpt.restore_sharded(fresh_j, str(tmp_path / "port"))
    assert _same(jax.tree.map(np.asarray, restored_j),
                 jax.tree.map(np.asarray, jstate))
    fresh = TR.make_state(cfg, O.OptConfig(kind=kind),
                          torch.Generator().manual_seed(9), "cpu")
    restored, man = ckpt.restore_sharded(fresh, str(tmp_path / "jax"))
    assert restored is fresh and man["step"] == 7
    assert _same(convert.train_state_to_numpy(restored),
                 jax.tree.map(np.asarray, jstate))
    assert tree_digest(restored["params"]) == jm["digest"]


def _small_state():
    cfg = registry.get_smoke("yi-6b")
    opt = O.OptConfig(kind="adamw", lr=LR)
    return cfg, opt, TR.make_state(cfg, opt, torch.Generator().manual_seed(1),
                                   "cpu")


def test_minority_write_failure_still_commits(tmp_path):
    _, _, state = _small_state()
    m = ckpt.save_sharded(state, str(tmp_path), 0, n_shards=5,
                          fail_shards={1, 3})      # 3/5 acks = majority
    assert m["committed"]
    _, _, fresh = _small_state()
    with torch.no_grad():
        for p in fresh["params"].parameters():
            p.zero_()
    restored, _ = ckpt.restore_sharded(fresh, str(tmp_path))
    assert tree_digest(restored["params"]) == tree_digest(state["params"])


def test_majority_write_failure_does_not_commit(tmp_path):
    _, _, state = _small_state()
    m = ckpt.save_sharded(state, str(tmp_path), 0, n_shards=5,
                          fail_shards={0, 1, 2})
    assert not m["committed"]
    assert ckpt.latest_committed_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_sharded(state, str(tmp_path))


def test_restore_picks_latest_committed(tmp_path):
    cfg, opt, state = _small_state()
    step = TR.make_train_step(cfg, opt, global_batch=2)
    ckpt.save_sharded(state, str(tmp_path), 1, n_shards=4)
    state, _ = step(state, {"tokens": torch.zeros((2, 16), dtype=torch.long)})
    ckpt.save_sharded(state, str(tmp_path), 2, n_shards=4)
    m = ckpt.save_sharded(state, str(tmp_path), 3, n_shards=4,
                          fail_shards={0, 1, 2})     # torn: no quorum
    assert not m["committed"]
    assert ckpt.latest_committed_step(str(tmp_path)) == 2
    assert jckpt.latest_committed_step(str(tmp_path)) == 2
    _, man = ckpt.restore_sharded(_small_state()[2], str(tmp_path))
    assert man["step"] == 2


# -- the replicated trainer ---------------------------------------------------

DECIDED = [(0, 0, Command("STEP", "b_0")), (1, 0, Command("NOOP")),
           (0, 1, Command("STEP", "b_1")), (1, 1, Command("STEP", "b_2")),
           (0, 2, Command("CKPT", 3)), (1, 2, Command("STEP", "b_3"))]


def test_merged_log_is_the_same_in_any_interleaving():
    logs = []
    for order in (DECIDED, DECIDED[::-1], DECIDED[1::2] + DECIDED[::2]):
        log = MergedCommandLog(2)
        for g, i, cmd in order:
            log.feed(g, i, cmd)
        assert log.audit() == []
        logs.append((log.merged, log.merged_groups))
    assert logs[0] == logs[1] == logs[2]
    assert len(logs[0][0]) == len(DECIDED)
    with pytest.raises(AssertionError, match="ordering safety"):
        log.feed(0, 0, Command("STEP", "other"))


def test_pods_end_equal_and_a_restored_pod_catches_up(tmp_path):
    """Two pods apply one log fed in two interleavings and end on equal
    digests; a pod restored from the CKPT command's checkpoint (one node
    failed) replays the rest of the log and ends on the same digest."""
    cfg, opt, _ = _small_state()
    step = TR.make_train_step(cfg, opt, microbatches=2, global_batch=2)
    source = ShardedBatchSource(cfg.vocab, 2, 16, seed=4, device="cpu")
    store = {f"b_{i}": source.batch(i) for i in range(4)}

    def on_ckpt(sm, n):
        m = ckpt.save_sharded(sm.state, str(tmp_path), n,
                              fail_shards={1})
        assert m["committed"]

    pods = []
    for order in (DECIDED, DECIDED[::-1]):
        sm = TrainerStateMachine("pod", step, _small_state()[2], store,
                                 on_ckpt=on_ckpt)
        log = MergedCommandLog(2, apply=sm.apply)
        for g, i, cmd in order:
            log.feed(g, i, cmd)
        assert sm.step == 4 and len(sm.metrics_log) == 4
        pods.append(sm)
    assert pods[0].digest() == pods[1].digest()
    assert pods[0].applied == pods[1].applied
    restored, man = ckpt.restore_sharded(_small_state()[2], str(tmp_path))
    assert int(restored["step"]) == 3 == man["step"]
    late = TrainerStateMachine("late", step, restored, store)
    merged = pods[0].applied
    cut = merged.index(("CKPT", 3))
    for enc in merged[cut + 1:]:         # the rest of the log
        late.apply(Command.decode(enc))
    assert late.step == 4
    assert late.digest() == pods[0].digest()


def test_statemachine_scale_and_noop():
    cfg, opt, state = _small_state()
    sm = TrainerStateMachine("p", TR.make_train_step(cfg, opt,
                                                     global_batch=2),
                             state, {})
    sm.apply(Command("SCALE", 3))
    sm.apply(Command("NOOP"))
    assert sm.n_pods == 3 and sm.step == 0
    assert sm.applied == [("SCALE", 3), ("NOOP", None)]


# -- data feed ----------------------------------------------------------------

def test_ordered_data_feed_is_exactly_once():
    src = ShardedBatchSource(vocab=50, global_batch=2, seq_len=8, seed=1,
                             device="cpu")
    feed = OrderedDataFeed(src)
    for bid in ("b_0", "b_1", "b_0", "b_2", "b_1"):
        feed.offer(bid)
    taken = []
    while (item := feed.take()) is not None:
        taken.append(item)
    assert [bid for bid, _ in taken] == ["b_0", "b_1", "b_2"]
    assert all(torch.equal(b["tokens"], src.batch(i)["tokens"])
               for i, (_, b) in enumerate(taken))
    assert feed.take() is None and feed.position == 3
    again = OrderedDataFeed(src)                    # a restarted pod
    for bid in ("b_0", "b_1", "b_2"):
        again.offer(bid)
    again.fast_forward(2)
    bid, b = again.take()
    assert bid == "b_2" and torch.equal(b["tokens"], taken[2][1]["tokens"])


def test_batch_source_is_a_function_of_seed_and_index():
    src = ShardedBatchSource(vocab=1000, global_batch=3, seq_len=16, seed=2,
                             device="cpu")
    a, b = src.batch(5)["tokens"], src.batch(5)["tokens"]
    assert torch.equal(a, b) and a.shape == (3, 16)
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    assert not torch.equal(a, src.batch(6)["tokens"])
    other = ShardedBatchSource(vocab=1000, global_batch=3, seq_len=16,
                               seed=3, device="cpu")
    assert not torch.equal(a, other.batch(5)["tokens"])


# -- the copies of JAX-free modules -------------------------------------------

def test_invariants_copy_matches_reference():
    orders = [[1, 2, 3], [10, 20]]
    for merged in ([1, 10, 2, 20, 3], [1, 2, 10, 3], [2, 1], [1, 99],
                   [1, 10, 2, 20, 3, 30]):
        assert invariants.check_legal_interleaving(merged, orders) \
            == jinv.check_legal_interleaving(merged, orders)
    seqs = {"a": [1, 2, 3], "b": [1, 2], "c": [1, 3]}
    assert invariants.audit(seqs, {1, 2}).violations \
        == jinv.audit(seqs, {1, 2}).violations


def test_membership_and_straggler_copies_match_reference():
    for mod in (membership, jmem):
        log = mod.OrderingGroupLog((0, 1), n_rows=3)
        log.apply_scale((0, 1, 2), at=5.0)
        assert log.current_epoch == 1 and log.epoch_at(6.0) == 1
        assert log.reconfig_schedule() == ((5.0, (0, 1, 2)),)
        assert log.table().active == ((0, 1), (0, 1, 2))
        mlog = mod.MembershipLog(["p1", "p0"])
        mlog.apply_scale(["p0", "p1", "p2"], step=10)
        assert mlog.view_at_step(9).pods == ("p0", "p1")
        assert mlog.current.reshard_plan(4) == {0: "p0", 1: "p1", 2: "p2",
                                                3: "p0"}
    states = []
    for mod in (straggler, jstrag):
        mon = mod.StragglerMonitor()
        states.append([mon.observe(t, "p", 0, 10) for t in
                       (0.0, 100.0, 250.0, 900.0)]
                      + [mon.healthy_majority(["p", "q", "r"])])
    assert states[0] == states[1] == ["lagging", "lagging", "resend",
                                      "failed", True]
