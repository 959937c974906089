"""The port's dissemination bandwidth accounting (repro_torch.dissem.
bandwidth) against repro.dissem.bandwidth on the CPU: per_node_bytes on
random hold states (unused slots included), uniform_traffic,
partition_size and replication_bytes_per_node, and the closed-form
asserts of benchmarks/run.py's bench_dissem at 20 and at 1000
disseminators, with the holds absorbed by the port's stability_tick."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.dissem import bandwidth as JB  # noqa: E402
from repro.dissem import engine as JD  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import dissem as dissem_pkg  # noqa: E402
from repro_torch.core.network import batch_bytes  # noqa: E402
from repro_torch.dissem import bandwidth as TB  # noqa: E402
from repro_torch.dissem import engine as TD  # noqa: E402


@pytest.mark.parametrize("G,W,n", [(1, 16, 5), (3, 24, 33), (2, 40, 64)])
def test_per_node_bytes_matches_reference(G, W, n):
    """Random holds absorbed on both sides, ragged owners, a third of the
    slots unused: the same in- and out-bytes per node."""
    rng = np.random.default_rng(G * 100 + n)
    words = (n + 31) // 32
    bits = rng.integers(0, 2**32, (G, W, words), dtype=np.uint32)
    if n % 32:
        bits[..., -1] &= np.uint32((1 << (n % 32)) - 1)
    owner = rng.integers(0, n, (G, W)).astype(np.int32)
    nbytes = np.where(rng.random((G, W)) < 0.33, 0,
                      rng.integers(100, 9000, (G, W))).astype(np.int64)
    maj = n // 2 + 1
    jst, _ = JD.stability_tick(JD.init_dissem(G, W, n), jnp.asarray(bits),
                               majority=maj)
    tst, _ = TD.stability_tick(TD.init_dissem(G, W, n, device="cpu"),
                               convert.bits_from_numpy(bits, "cpu"),
                               majority=maj)
    want = JB.per_node_bytes(jst, owner, nbytes, n)
    got = TB.per_node_bytes(tst, owner, nbytes, n)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and np.array_equal(g, w)
    assert got[0].sum() > 0


@pytest.mark.parametrize("G,W,n", [(1, 20, 20), (4, 500, 250), (2, 64, 33)])
def test_uniform_traffic_matches_reference(G, W, n):
    if W % n:
        msgs = []
        for mod in (JB, TB):
            with pytest.raises(ValueError, match="multiple") as e:
                mod.uniform_traffic(G, W, n, batch_nbytes=100)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
        return
    for got, want in zip(TB.uniform_traffic(G, W, n, batch_nbytes=8292),
                         JB.uniform_traffic(G, W, n, batch_nbytes=8292)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_partition_size_and_closed_form_match_reference():
    for m, G in ((20, 1), (20, 4), (1000, 4), (1000, 8)):
        assert TB.partition_size(m, G) == JB.partition_size(m, G)
    msgs = []
    for mod in (JB, TB):
        with pytest.raises(ValueError, match="ragged") as e:
            mod.partition_size(1000, 3)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    for k, q, mp in ((8, 1024, 250), (1, 1, 1), (2.5, 100, 20),
                     (8, 1024, 1000)):
        assert TB.replication_bytes_per_node(k, q, mp) == \
            JB.replication_bytes_per_node(k, q, mp)
    assert TB.ACK_BYTES == JB.ACK_BYTES == 68
    assert dissem_pkg.per_node_bytes is TB.per_node_bytes


@pytest.mark.parametrize("m_total,batches", [(20, 640), (1000, 2000)])
def test_bench_dissem_closed_forms(m_total, batches):
    """bench_dissem's cross-check at equal total load: per-node bytes of
    the absorbed uniform traffic equal slots-per-node times the closed
    form, and partitioning cuts per-node in-bytes by about G."""
    K, Q = 8, 1024
    nbytes = batch_bytes(K, Q)
    base_in = None
    for G in (1, 2, 4):
        mp = TB.partition_size(m_total, G)
        Wg = batches // G
        packed, owner, nb = TB.uniform_traffic(G, Wg, mp, batch_nbytes=nbytes)
        st, out = TD.stability_tick(TD.init_dissem(G, Wg, mp, device="cpu"),
                                    convert.bits_from_numpy(packed, "cpu"),
                                    majority=mp // 2 + 1)
        assert bool(st.stable.all()) and int(out["newly_per_group"].sum()) \
            == G * Wg
        in_b, out_b = TB.per_node_bytes(st, owner, nb, mp)
        cf = TB.replication_bytes_per_node(K, Q, mp)
        slots_per_node = Wg // mp
        assert (in_b == slots_per_node * cf["in"]).all()
        assert (out_b == slots_per_node * cf["out"]).all()
        node_in = int(in_b.max())
        base_in = node_in if G == 1 else base_in
        assert node_in < base_in or G == 1
        assert base_in / node_in == pytest.approx(G, rel=0.01)
