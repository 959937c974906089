"""The port's Engine facade (repro_torch.engine.api) against
repro.engine.api, bit for bit, for all four families: merged log, count,
committed and the whole final state (through engine_state_to_numpy),
for the fused run and the host-driven tick; state carried across from a
reference run; in-place ≡ functional; EngineConfig validation with the
reference's messages; and the device contract of create_state."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.engine import api as japi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.engine import api as tapi  # noqa: E402

W, D, SQ, B, T = 16, 5, 3, 4, 12
DM, SM, STAB = 3, 2, 3
STRIDE = 4096
FAMILIES = ["plain", "recycled", "gated", "gated_recycled"]


def configs(fam, G, **over):
    """(reference EngineConfig, port EngineConfig) of one family."""
    out = []
    for mod in (japi, tapi):
        kw = dict(groups=G, window=W, n_diss=D, n_seq=SQ, order_budget=B,
                  merge_capacity=T * B, diss_majority=DM, seq_majority=SM)
        if "recycled" in fam:
            kw["recycling"] = mod.RecyclingConfig(watermark=W // 2,
                                                  id_stride=STRIDE)
        if "gated" in fam:
            kw["gating"] = mod.GatingConfig(stab_majority=STAB)
        kw.update(over)
        out.append(mod.EngineConfig(**kw))
    assert out[0].family == out[1].family == fam
    return out


def tiles(seed, G, fam):
    """uint32 [T, G, W, 1] acks, votes and (gated families) holds."""
    rng = np.random.default_rng(seed)
    acks = ((rng.random((T, G, W, 1)) < 0.7) * np.uint32(0x1F))
    votes = ((rng.random((T, G, W, 1)) < 0.6) * np.uint32(0x7))
    holds = ((rng.random((T, G, W, 1)) < 0.8) * np.uint32(0x1F)) \
        if "gated" in fam else None
    return [None if x is None else x.astype(np.uint32)
            for x in (acks, votes, holds)]


def to_ref(x):
    return None if x is None else jnp.asarray(x)


def to_port(x):
    return None if x is None else convert.bits_from_numpy(x, "cpu")


def ref_tree(tree):
    """Reference state → nested dicts of numpy arrays."""
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


# ---------------------------------------------------------------------------
# run and tick parity, all four families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("fam", FAMILIES)
def test_run_parity(fam, G):
    jc, tc = configs(fam, G)
    acks, votes, holds = tiles(FAMILIES.index(fam) + 10 * G, G, fam)
    js, *jres = japi.run(jc, japi.create_state(jc), to_ref(acks),
                         to_ref(votes), to_ref(holds))
    ts, *tres = tapi.run(tc, tapi.create_state(tc, "cpu"), to_port(acks),
                         to_port(votes), to_port(holds))
    assert_results_equal(tres, jres)
    assert_tree_equal(convert.engine_state_to_numpy(ts), ref_tree(js))
    assert int(tres[1]) > 0 and int(tres[2]) > 0


@pytest.mark.parametrize("fam", FAMILIES)
def test_tick_loop_parity(fam):
    G = 2
    jc, tc = configs(fam, G)
    acks, votes, holds = tiles(20 + FAMILIES.index(fam), G, fam)
    js, ts = japi.create_state(jc), tapi.create_state(tc, "cpu")
    for t in range(T):
        h = None if holds is None else holds[t]
        js, jout = japi.tick(jc, js, to_ref(acks[t]), to_ref(votes[t]),
                             to_ref(h))
        ts, tout = tapi.tick(tc, ts, to_port(acks[t]), to_port(votes[t]),
                             to_port(h))
        assert set(tout) == set(jout)
        for k in jout:
            assert np.array_equal(tout[k].numpy(), np.asarray(jout[k])), k
    assert_tree_equal(convert.engine_state_to_numpy(ts), ref_tree(js))
    assert_results_equal(tapi.committed_prefix(tc, ts),
                         japi.committed_prefix(jc, js))
    assert np.array_equal(tapi.slot_ids(ts).numpy(),
                          np.asarray(japi.slot_ids(js)))


@pytest.mark.parametrize("fam", FAMILIES)
def test_state_carried_across_from_reference(fam):
    """The reference ticks N times; its state crosses to the port through
    engine_state_from_numpy; both finish the run and agree."""
    G, N = 2, 5
    jc, tc = configs(fam, G)
    acks, votes, holds = tiles(30 + FAMILIES.index(fam), G, fam)
    js = japi.create_state(jc)
    for t in range(N):
        js, _ = japi.tick(jc, js, to_ref(acks[t]), to_ref(votes[t]),
                          None if holds is None else to_ref(holds[t]))
    ts = convert.engine_state_from_numpy(tc, ref_tree(js), "cpu")
    assert_tree_equal(convert.engine_state_to_numpy(ts), ref_tree(js))
    rest = [None if x is None else x[N:] for x in (acks, votes, holds)]
    js, *jres = japi.run(jc, js, *map(to_ref, rest))
    ts, *tres = tapi.run(tc, ts, *map(to_port, rest))
    assert_results_equal(tres, jres)
    assert_tree_equal(convert.engine_state_to_numpy(ts), ref_tree(js))
    assert int(tres[2]) > 0


@pytest.mark.parametrize("fam", FAMILIES)
def test_inplace_engine_equals_functional(fam):
    """Engine advances its state in place (the counterpart of buffer
    donation); the functional layer modifies no input. Both agree."""
    G = 2
    _, tc = configs(fam, G)
    acks, votes, holds = map(to_port, tiles(40 + FAMILIES.index(fam), G,
                                            fam))
    st0 = tapi.create_state(tc, "cpu")
    before = convert.engine_state_to_numpy(st0)
    st, *res = tapi.run(tc, st0, acks, votes, holds)
    assert_tree_equal(convert.engine_state_to_numpy(st0), before)
    eng = tapi.Engine.create(tc, device="cpu")
    bits0 = eng.state.core if fam in ("plain", "gated") \
        else (eng.state.core.q if fam == "recycled" else eng.state.core.rs.q)
    eres = eng.run(acks[:-1], votes[:-1],
                   None if holds is None else holds[:-1])
    assert int(eres[1]) > 0
    eng.tick(acks[-1], votes[-1], None if holds is None else holds[-1])
    assert_tree_equal(convert.engine_state_to_numpy(eng.state),
                      convert.engine_state_to_numpy(st))
    assert_results_equal(eng.committed(), res)
    if fam in ("plain", "gated"):       # no recycling: same buffers, mutated
        assert eng.state.core.ack_bits.data_ptr() == \
            bits0.ack_bits.data_ptr()
    assert fam in repr(eng)


def test_recycle_facade_matches_reference():
    jc, tc = (mod.EngineConfig(
        groups=2, window=W, n_diss=D, n_seq=SQ, order_budget=B,
        merge_capacity=T * B,
        recycling=mod.RecyclingConfig(watermark=W, id_stride=STRIDE))
        for mod in (japi, tapi))
    acks, votes, _ = tiles(6, 2, "recycled")
    js, ts = japi.create_state(jc), tapi.create_state(tc, "cpu")
    for t in range(T):
        js, _ = japi.tick(jc, js, to_ref(acks[t]), to_ref(votes[t]))
        ts, _ = tapi.tick(tc, ts, to_port(acks[t]), to_port(votes[t]))
    js, jn = japi.recycle(jc, js)
    ts, tn = tapi.recycle(tc, ts)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert_tree_equal(convert.engine_state_to_numpy(ts), ref_tree(js))


# ---------------------------------------------------------------------------
# EngineConfig validation: same rules, same messages
# ---------------------------------------------------------------------------

def both_kw(**over):
    kw = dict(groups=2, window=W, n_diss=D, n_seq=SQ, order_budget=B,
              merge_capacity=64)
    kw.update(over)
    return kw


def sub(mod, kw):
    """Build the sub-configs of ``kw`` from ``mod``'s classes."""
    out = dict(kw)
    for k, cls in (("recycling", "RecyclingConfig"),
                   ("gating", "GatingConfig")):
        if k in out:
            out[k] = getattr(mod, cls)(**out[k])
    return out


@pytest.mark.parametrize("kw", [
    dict(groups=0), dict(window=0), dict(n_diss=0), dict(order_budget=0),
    dict(merge_capacity=0), dict(diss_majority=D + 1),
    dict(seq_majority=0), dict(max_entries=B - 1),
    dict(recycling=dict(watermark=0, id_stride=STRIDE)),
    dict(recycling=dict(watermark=4)),
    dict(recycling=dict(watermark=4, id_stride=W - 1)),
    dict(gating=dict(stab_majority=D + 1)),
    dict(gating=dict(n_diss_partition=0)),
])
def test_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        japi.EngineConfig(**sub(japi, both_kw(**kw)))
    with pytest.raises(ValueError) as port_err:
        tapi.EngineConfig(**sub(tapi, both_kw(**kw)))
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw", [
    dict(), dict(groups=1, recycling=dict(watermark=4)),
    dict(gating=dict()), dict(max_entries=9, diss_majority=1),
    dict(gating=dict(n_diss_partition=2, pre_stable=True)),
])
def test_config_normalization_matches_reference(kw):
    ref = japi.EngineConfig(**sub(japi, both_kw(**kw)))
    port = tapi.EngineConfig(**sub(tapi, both_kw(**kw)))
    for f in ("groups", "window", "n_diss", "n_seq", "order_budget",
              "merge_capacity", "diss_majority", "seq_majority",
              "max_entries"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("recycling", "gating"):
        r, p = getattr(ref, f), getattr(port, f)
        assert (r is None) == (p is None)
        if r is not None:
            assert vars(p) == vars(r)
    assert port.family == ref.family


@pytest.mark.parametrize("field", ["mesh"])
def test_unported_config_fields_raise(field):
    """No field is left unported: ``mesh``, the last one, validates as
    the reference does (ValueError for a value of the wrong type), where
    it raised NotImplementedError before it was ported."""
    for mod in (japi, tapi):
        with pytest.raises(ValueError, match="must be a MeshConfig, got "
                           "object"):
            mod.EngineConfig(**both_kw(**{field: object()}))


def test_holds_required_iff_gated():
    acks, votes, holds = map(to_port, tiles(8, 2, "gated"))
    plain = tapi.EngineConfig(**both_kw())
    gated = tapi.EngineConfig(**both_kw(gating=tapi.GatingConfig()))
    with pytest.raises(ValueError, match="hold"):
        tapi.tick(plain, tapi.create_state(plain, "cpu"), acks[0],
                  votes[0], holds[0])
    with pytest.raises(ValueError, match="hold"):
        tapi.tick(gated, tapi.create_state(gated, "cpu"), acks[0],
                  votes[0])


def test_recycle_requires_recycling():
    cfg = tapi.EngineConfig(**both_kw())
    with pytest.raises(ValueError, match="recycl"):
        tapi.recycle(cfg, tapi.create_state(cfg, "cpu"))


def test_config_is_hashable():
    a = tapi.EngineConfig(**both_kw(gating=tapi.GatingConfig()))
    b = tapi.EngineConfig(**both_kw(gating=tapi.GatingConfig()))
    assert a == b and hash(a) == hash(b)
    assert a != tapi.EngineConfig(**both_kw())


# ---------------------------------------------------------------------------
# devices and conversion
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_gpu(monkeypatch):
    """No device given means cuda; without a card that raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tapi.EngineConfig(**both_kw())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.create_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.Engine.create(cfg)
    assert tapi.Engine.create(cfg, device="cpu").state.merge.logs.is_cpu


def test_from_numpy_checks_shapes_and_accepts_family_states():
    jc, tc = configs("gated_recycled", 2)
    js = ref_tree(japi.create_state(jc))
    core = convert.engine_state_from_numpy(tc, js["core"], "cpu")
    assert type(core).__name__ == "GatedRecycleState"
    rs = convert.engine_state_from_numpy(tc, js["core"]["rs"], "cpu")
    assert type(rs).__name__ == "RecycleState"
    _, wider = configs("gated_recycled", 2, window=2 * W)
    with pytest.raises(ValueError, match="expected"):
        convert.engine_state_from_numpy(wider, js, "cpu")
    with pytest.raises(ValueError, match="recognized"):
        convert.engine_state_from_numpy(tc, {"nope": 1}, "cpu")
