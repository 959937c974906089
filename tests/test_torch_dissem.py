"""repro_torch.dissem.engine against repro.dissem.engine, bit for bit:
the hold absorb on the stability kernel's plain version, the stacked
stability schedule, and the read-side helpers (unpack_tile, stable_ids,
admitted mask, unstable backlog)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.dissem import engine as JD  # noqa: E402
from repro_torch.convert import bits_from_numpy, bits_to_numpy  # noqa: E402
from repro_torch.dissem import engine as TD  # noqa: E402

G, W, N = 3, 20, 70
MAJ = N // 2 + 1


def holds(seed, ticks):
    """uint32 [T, G, W, WORDS] hold tiles at density 1/8 (an id takes a
    few ticks to stabilize), with the bits past N in the last word
    cleared."""
    rng = np.random.default_rng(seed)
    shape = (ticks, G, W, (N + 31) // 32)
    h = rng.integers(0, 2**32, shape, dtype=np.uint32)
    for _ in range(2):
        h &= rng.integers(0, 2**32, shape, dtype=np.uint32)
    h[..., -1] &= np.uint32((1 << (N % 32)) - 1)
    return h


def assert_state_equal(port, ref):
    assert np.array_equal(bits_to_numpy(port.hold_bits),
                          np.asarray(ref.hold_bits))
    assert np.array_equal(port.stable.numpy(), np.asarray(ref.stable))


@pytest.mark.parametrize("pre_stable", [False, True])
def test_init_dissem_matches(pre_stable):
    assert_state_equal(TD.init_dissem(G, W, N, pre_stable=pre_stable,
                                      device="cpu"),
                       JD.init_dissem(G, W, N, pre_stable=pre_stable))


def test_stability_ticks_match_step_by_step():
    h = holds(0, 5)
    st = TD.init_dissem(G, W, N, device="cpu")
    ref = JD.init_dissem(G, W, N)
    for t in range(len(h)):
        st, out = TD.stability_tick(st, bits_from_numpy(h[t], "cpu"),
                                    majority=MAJ)
        ref, rout = JD.stability_tick(ref, jnp.asarray(h[t]), majority=MAJ)
        assert_state_equal(st, ref)
        for k in rout:
            assert np.array_equal(out[k].numpy(), np.asarray(rout[k])), k
        assert out["newly_per_group"].tolist() == \
            out["newly_stable"].sum(1).tolist()
        assert np.array_equal(TD.dissem_admitted_mask(st).numpy(),
                              np.asarray(JD.dissem_admitted_mask(ref)))
        assert np.array_equal(TD.unstable_backlog(st).numpy(),
                              np.asarray(JD.unstable_backlog(ref)))
    assert bool(st.stable.any()) and not bool(st.stable.all())


def test_run_stability_ticks_matches_schedule():
    h = holds(1, 8)
    st, outs = TD.run_stability_ticks(TD.init_dissem(G, W, N, device="cpu"),
                                      bits_from_numpy(h, "cpu"),
                                      majority=MAJ)
    ref, routs = JD.run_stability_ticks(JD.init_dissem(G, W, N),
                                        jnp.asarray(h), majority=MAJ)
    assert_state_equal(st, ref)
    for k in routs:
        assert np.array_equal(outs[k].numpy(), np.asarray(routs[k])), k


@pytest.mark.parametrize("n", [1, 31, 32, 33, 70])
def test_unpack_tile_matches_and_inverts_pack(n):
    rng = np.random.default_rng(n)
    words = (n + 31) // 32
    packed = rng.integers(0, 2**32, (G, W, words), dtype=np.uint32)
    packed[0, 0] = 0xFFFFFFFF                  # bit 31 set
    got = TD.unpack_tile(bits_from_numpy(packed, "cpu"), n)
    want = JD.unpack_tile(jnp.asarray(packed), n)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_stable_ids_matches():
    h = holds(2, 3)
    st, _ = TD.run_stability_ticks(TD.init_dissem(G, W, N, device="cpu"),
                                   bits_from_numpy(h, "cpu"), majority=MAJ)
    ids = np.arange(G * W, dtype=np.int32).reshape(G, W) * 7
    want = JD.stable_ids(JD.DissemState(
        hold_bits=jnp.asarray(bits_to_numpy(st.hold_bits)),
        stable=jnp.asarray(st.stable.numpy())), jnp.asarray(ids))
    assert np.array_equal(TD.stable_ids(st, torch.from_numpy(ids)).numpy(),
                          np.asarray(want))
