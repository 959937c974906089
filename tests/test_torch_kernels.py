"""Port kernels (repro_torch.kernels) against the Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version bit for bit against the Pallas function in interpret mode,
at the shapes of tests/test_kernels.py, plus the stability kernel's
per-group ``newly`` count, the wrappers' input checks, and in-place ≡
out-of-place. The CUDA kernels themselves are
checked in tests/test_torch_gpu.py."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dissem import stability_update_grouped as pl_stability  # noqa: E402
from repro.kernels.quorum import quorum_update as pl_quorum  # noqa: E402
from repro.kernels.quorum import quorum_update_grouped as pl_grouped  # noqa: E402
from repro_torch.convert import bits_from_numpy, bits_to_numpy  # noqa: E402
from repro_torch.core.tilesim import pack_tile  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dissem as kd  # noqa: E402
from repro_torch.kernels import quorum as kq  # noqa: E402

EDGE_SHAPES = [(2, 12, 32), (3, 20, 33), (1, 7, 31), (2, 36, 65), (4, 10, 1),
               (2, 24, 64)]


def _inputs(seed, shape, p_stable=0.3):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, shape, dtype=np.uint32)
    upd = rng.integers(0, 2**32, shape, dtype=np.uint32)
    stable = rng.random(shape[:-1]) < p_stable
    return bits, upd, stable


def _port(bits, upd, stable, device="cpu"):
    return (bits_from_numpy(bits, device), bits_from_numpy(upd, device),
            torch.from_numpy(stable).to(device))


def _assert_outputs_equal(got, want):
    """Port outputs (bitsets first) bit-equal to reference outputs."""
    assert np.array_equal(bits_to_numpy(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.cpu().numpy(), np.asarray(w))


@pytest.mark.parametrize("W,D", [(64, 33), (256, 100), (512, 1000)])
def test_quorum_plain_matches_pallas_single_group(W, D):
    words = (D + 31) // 32
    bits, upd, stable = _inputs(W + D, (W, words), 0.2)
    maj = D // 2 + 1
    want = pl_quorum(jnp.asarray(bits), jnp.asarray(upd),
                     jnp.asarray(stable), majority=maj, block_w=64,
                     interpret=True)
    got = kq.quorum_update(*_port(bits, upd, stable), majority=maj)
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("seed,d", [(0, 1), (7, 17), (99, 32), (123, 64),
                                    (500, 101), (999, 200)])
def test_quorum_threshold_property(seed, d):
    """stable ⇔ popcount ≥ majority over the unpacked ack matrix."""
    rng = np.random.default_rng(seed)
    W = 64
    acks = rng.random((1, W, d)) < rng.random()
    packed = pack_tile(torch.from_numpy(acks))
    _, counts, stable = kq.quorum_update_grouped(
        torch.zeros_like(packed), packed,
        torch.zeros((1, W), dtype=torch.bool), majority=d // 2 + 1)
    assert np.array_equal(counts.numpy(), acks.sum(-1))
    assert np.array_equal(stable.numpy(), acks.sum(-1) >= d // 2 + 1)


@pytest.mark.parametrize("G,W,D", EDGE_SHAPES)
def test_quorum_plain_matches_pallas_grouped_edge_shapes(G, W, D):
    words = (D + 31) // 32
    bits, upd, stable = _inputs(G * 1000 + W * 10 + D, (G, W, words))
    maj = D // 2 + 1
    want = pl_grouped(jnp.asarray(bits), jnp.asarray(upd),
                      jnp.asarray(stable), majority=maj, interpret=True)
    got = kq.quorum_update_grouped(*_port(bits, upd, stable), majority=maj)
    _assert_outputs_equal(got, want)


def test_quorum_plain_matches_pallas_odd_window():
    W, D = 40, 100
    bits, upd, _ = _inputs(40, (W, 4))
    stable = np.zeros((W,), bool)
    want = pl_quorum(jnp.asarray(bits), jnp.asarray(upd),
                     jnp.asarray(stable), majority=D // 2 + 1, block_w=16,
                     interpret=True)
    got = kq.quorum_update(*_port(bits, upd, stable), majority=D // 2 + 1)
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("G,W,D", EDGE_SHAPES + [(4, 64, 70)])
def test_stability_plain_matches_pallas_with_newly(G, W, D):
    words = (D + 31) // 32
    bits, upd, stable = _inputs(G + W + D, (G, W, words))
    # sparse words so that some rows stay below the majority
    bits &= np.random.default_rng(1).integers(0, 2**32, bits.shape,
                                              dtype=np.uint32)
    upd &= np.random.default_rng(2).integers(0, 2**32, upd.shape,
                                             dtype=np.uint32)
    maj = D // 2 + 1
    want = pl_stability(jnp.asarray(bits), jnp.asarray(upd),
                        jnp.asarray(stable), majority=maj, interpret=True)
    got = kd.stability_update_grouped(*_port(bits, upd, stable),
                                      majority=maj)
    _assert_outputs_equal(got, want)
    assert int(got[3].sum()) == int((got[2] & ~torch.from_numpy(stable))
                                    .sum())


@pytest.mark.parametrize("word", [0xFFFFFFFF, 0x80000000, 0x80000001,
                                  0x7FFFFFFF])
def test_popcount_counts_bit_31(word):
    """Words with bit 31 set are negative int32s; the count must not see
    the arithmetic shift's sign fill (saturated tiles are all-ones)."""
    a = np.full((2, 3, 5), word, np.uint32)
    want = 5 * bin(word).count("1")
    assert (kq.popcount_rows(bits_from_numpy(a, "cpu")) == want).all()


@pytest.mark.parametrize("kernel", ["quorum", "stability"])
def test_inplace_equals_out_of_place(kernel):
    fn = kq.quorum_update_grouped if kernel == "quorum" \
        else kd.stability_update_grouped
    bits, upd, stable = _port(*_inputs(5, (3, 20, 2)))
    ref = fn(bits.clone(), upd, stable, majority=33)
    buf = bits.clone()
    got = fn(buf, upd, stable, majority=33, inplace=True)
    assert got[0].data_ptr() == buf.data_ptr()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_wrappers_reject_bad_inputs():
    bits, upd, stable = _port(*_inputs(6, (2, 8, 2)))
    for fn in (kq.quorum_update_grouped, kd.stability_update_grouped):
        with pytest.raises(TypeError, match="int32"):
            fn(bits.long(), upd, stable, majority=1)
        with pytest.raises(TypeError, match="bool"):
            fn(bits, upd, stable.int(), majority=1)
        with pytest.raises(ValueError, match="rank"):
            fn(bits, upd[:, :4], stable, majority=1)
        with pytest.raises(ValueError, match="contiguous"):
            fn(bits.transpose(0, 1), upd.transpose(0, 1),
               stable.T.contiguous(), majority=1)
        with pytest.raises(ValueError, match="devices"):
            fn(bits, upd.to("meta"), stable, majority=1)
    with pytest.raises(ValueError, match="rank"):
        kq.quorum_update(bits, upd, stable, majority=1)


def test_wrappers_have_no_fallback_device():
    """Only a CPU tensor takes the plain version; any other device must
    launch or raise (here: the meta device raises)."""
    bits, upd, stable = (t.to("meta") for t in _port(*_inputs(7, (1, 4, 1))))
    for fn in (kq.quorum_update_grouped, kd.stability_update_grouped):
        with pytest.raises(ValueError, match="device"):
            fn(bits, upd, stable, majority=1)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_library_path_is_keyed_by_source_hash():
    p = _build.library_path("quorum.cu")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("quorum-")
    assert p != _build.library_path("dissem.cu")
