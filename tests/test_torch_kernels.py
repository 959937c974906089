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


# -- the CUDA kernels' launch plan and index map, emulated in numpy ----------

# the engine's ack, vote and hold tiles (1000 disseminators, 16 sequencers,
# a 250-disseminator partition) with the window cut from 2048 to 64
ENGINE_SHAPES_W64 = [(4, 64, 1000), (4, 64, 16), (4, 64, 250)]
# where the lane mapping switches: 2, 3, 4, 5, 9, 33 and 64 words; W = 1
# and W = 129; G = 9, a count of clusters that fills no power of two;
# W = 0 (newly must still be written)
MAPPING_SHAPES = [(2, 5, 64), (2, 6, 96), (3, 9, 128), (1, 1, 160),
                  (2, 129, 288), (9, 17, 1056), (2, 3, 2048), (2, 0, 32)]


@pytest.mark.parametrize("G,W,words,aligned,clustered,want", [
    (4, 2048, 32, True, False, (4, 8, 32, 1, 256)),      # ack
    (4, 2048, 1, True, False, (1, 1, 256, 1, 32)),       # vote
    (4, 2048, 8, True, True, (4, 2, 128, 8, 32)),        # hold
    (4, 2048, 32, False, False, (1, 32, 8, 1, 1024)),    # misaligned ack
    (4, 2048, 8, False, True, (1, 8, 32, 8, 32)),        # misaligned hold
    (1, 7, 1, True, True, (1, 1, 256, 1, 1)),            # W = 7: C = 1
    (1, 7, 1, True, False, (1, 1, 256, 1, 1)),
    (9, 129, 3, True, True, (1, 4, 64, 4, 36)),          # 3 row blocks
    (9, 129, 3, True, False, (1, 4, 64, 1, 19)),
    (2, 36, 65 // 32 + 1, True, True, (1, 4, 64, 1, 2)),
    (3, 9, 4, True, False, (4, 1, 256, 1, 1)),
    (3, 9, 5, True, False, (1, 8, 32, 1, 1)),
    (2, 129, 9, True, True, (1, 16, 16, 8, 16)),
    (9, 17, 33, True, True, (1, 32, 8, 4, 36)),
    (2, 3, 64, True, True, (4, 16, 16, 1, 2)),
    (2, 0, 32, True, True, (4, 8, 32, 1, 2)),            # W = 0
    (2, 8, 0, True, False, (4, 1, 256, 1, 1)),           # no words
])
def test_launch_plan(G, W, words, aligned, clustered, want):
    assert tuple(kq.launch_plan(G, W, words, aligned,
                                clustered=clustered)) == want


def test_launch_plan_covers_every_row():
    """Over many tiles: a segment covers its row's vectors (or is a whole
    warp), segments tile a block, the grid covers the rows, and a
    cluster covers its group's row blocks (or is the portable 8)."""
    rng = np.random.default_rng(3)
    for _ in range(500):
        G, W, words = (int(x) for x in rng.integers(1, [12, 3000, 70]))
        for aligned in (True, False):
            for clustered in (False, True):
                p = kq.launch_plan(G, W, words, aligned, clustered=clustered)
                assert p.vec == (4 if aligned and words % 4 == 0 else 1)
                assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
                assert p.lanes * p.vec >= words or p.lanes == 32
                assert p.lanes == 1 or (p.lanes // 2) * p.vec < words
                assert p.lanes * p.rows_per_block == kq.THREADS
                if clustered:
                    assert p.cluster & (p.cluster - 1) == 0
                    assert p.cluster <= kq.MAX_CLUSTER
                    assert p.grid == G * p.cluster
                    assert (p.cluster * p.rows_per_block >= W
                            or p.cluster == kq.MAX_CLUSTER)
                else:
                    assert p.cluster == 1
                    assert (p.grid - 1) * p.rows_per_block < G * W \
                        <= p.grid * p.rows_per_block


def test_tile_plan_takes_4_byte_loads_on_a_storage_offset():
    base = torch.zeros(4 * 64 * 8 + 1, dtype=torch.int32)
    aligned, shifted = base[:-1].view(4, 64, 8), base[1:].view(4, 64, 8)
    *ptrs, plan = kq.tile_plan(aligned, aligned, aligned, clustered=True)
    assert ptrs == [aligned.data_ptr()] * 3 and plan.vec == 4
    for args in ((shifted, aligned, aligned), (aligned, shifted, aligned),
                 (aligned, aligned, shifted)):
        *_, plan = kq.tile_plan(*args, clustered=True)
        assert plan == kq.launch_plan(4, 64, 8, False, clustered=True)
        assert (plan.vec, plan.lanes) == (1, 8)


def _popc(x):
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8)
                         .reshape(*x.shape, 4), axis=-1).sum(-1, dtype=np.int64)


def _row_pass(plan, bits, upd, out, touched, row, seg, live, words):
    """The segment loop of ``row_pass``: lane ``seg`` of the row's segment
    takes vectors seg, seg + L, ...; each vector is ``plan.vec`` words.
    Returns each thread's popcount; marks each word written."""
    count = np.zeros(row.shape, np.int64)
    vecs = words // plan.vec
    k = 0
    while True:
        v = seg + k * plan.lanes
        act = live & (v < vecs)
        if not act.any():
            return count
        r, vv = row[act], v[act]
        for j in range(plan.vec):
            w = vv * plan.vec + j
            x = bits[r, w] | upd[r, w]
            out[r, w] = x
            touched[r, w] += 1
            count[act] += _popc(x)
        k += 1


def _shuffle_sum(count, lanes):
    """__shfl_xor_sync over offsets L/2 ... 1, along the last axis (thread
    index); every partner lies in the same warp."""
    tid = np.arange(count.shape[-1])
    off = lanes // 2
    while off:
        assert ((tid ^ off) // 32 == tid // 32).all()
        count = count + count[..., tid ^ off]
        off //= 2
    return count


def _emulate(kind, plan, bits, upd, stable, majority):
    """numpy emulation of ``quorum_kernel`` (kind "quorum": one grid over
    all rows) or ``stability_kernel`` (kind "stability": one cluster of
    ``plan.cluster`` blocks per group, each block striding over the
    group's rows, the block sums read by the cluster's rank 0). Returns
    the outputs plus how often each word and each row was written."""
    G, W, words = bits.shape
    rows = G * W
    fb, fu, fs = bits.reshape(rows, words), upd.reshape(rows, words), \
        stable.reshape(rows)
    out = np.zeros_like(fb)
    touched = np.zeros((rows, words), np.int64)
    counts = np.zeros(rows, np.int32)
    now = np.zeros(rows, bool)
    writes = np.zeros(rows, np.int64)
    lg = plan.lanes.bit_length() - 1
    rpb = plan.rows_per_block

    def store(row, seg, live, count):
        lead = live & (seg == 0)
        r = row[lead]
        np.add.at(writes, r, 1)
        counts[r] = count[lead]
        now[r] = fs[r] | (count[lead] >= majority)
        return lead

    if kind == "quorum":
        tid = np.arange(plan.grid * kq.THREADS)
        row, seg = tid >> lg, tid & (plan.lanes - 1)
        live = row < rows
        count = _row_pass(plan, fb, fu, out, touched, np.where(live, row, 0),
                          seg, live, words)
        store(row, seg, live, _shuffle_sum(count, plan.lanes))
        newly = None
    else:
        C = plan.cluster
        blk = np.arange(plan.grid)[:, None]
        t = np.arange(kq.THREADS)[None, :]
        g, rank = blk // C, blk % C
        seg_row, seg = t >> lg, t & (plan.lanes - 1)
        mine = np.zeros((plan.grid, kq.THREADS), np.int64)
        it = 0
        while True:                 # the block-uniform stride loop
            first = (rank + it * C) * rpb
            if not (first < W).any():
                break
            w = first + seg_row
            live = np.broadcast_to((first < W) & (w < W),
                                   (plan.grid, kq.THREADS))
            row = np.broadcast_to(np.where(live, g * W + w, 0), live.shape)
            count = _row_pass(plan, fb, fu, out, touched, row,
                              np.broadcast_to(seg, live.shape), live, words)
            count = _shuffle_sum(count, plan.lanes)
            lead = store(row, np.broadcast_to(seg, live.shape), live, count)
            mine += lead & now[row] & ~fs[row]
            it += 1
        block_sum = mine.reshape(plan.grid, kq.THREADS // 32, 32).sum((1, 2))
        newly = np.zeros(G, np.int64)
        newly_writes = np.zeros(G, np.int64)
        for b in range(plan.grid):
            if b % C == 0:           # rank 0 reads its cluster's C sums
                newly[b // C] = block_sum[b:b + C].sum()
                newly_writes[b // C] += 1
        assert (newly_writes == 1).all()
        newly = newly.astype(np.int32)
    return (out.reshape(G, W, words), counts.reshape(G, W),
            now.reshape(G, W), newly, touched, writes)


def _emulation_inputs(G, W, D):
    words = (D + 31) // 32
    bits, upd, stable = _inputs(G * 7 + W * 3 + D, (G, W, words))
    # sparse words so that some rows stay below the majority
    bits &= np.random.default_rng(1).integers(0, 2**32, bits.shape,
                                              dtype=np.uint32)
    upd &= np.random.default_rng(2).integers(0, 2**32, upd.shape,
                                             dtype=np.uint32)
    return bits, upd, stable, D // 2 + 1


def _check_emulation(G, W, D, aligned, kind):
    bits, upd, stable, maj = _emulation_inputs(G, W, D)
    plan = kq.launch_plan(G, W, bits.shape[-1], aligned,
                          clustered=kind == "stability")
    *got, touched, writes = _emulate(kind, plan, bits, upd, stable, maj)
    assert (touched == 1).all(), "a word was not covered exactly once"
    assert (writes == 1).all(), "a row has not exactly one writer"
    plain = (kq.quorum_update_grouped_plain if kind == "quorum"
             else kd.stability_update_grouped_plain)
    want = plain(*_port(bits, upd, stable), majority=maj)
    _assert_arrays_equal(got, [bits_to_numpy(want[0]),
                               *(w.numpy() for w in want[1:])])
    return got


def _assert_arrays_equal(got, want):
    """Emulated outputs bit-equal to ``want`` (numpy, bitsets as uint32),
    as many as ``want`` has."""
    for g, w in zip(got, want, strict=False):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind", ["quorum", "stability"])
@pytest.mark.parametrize("G,W,D,aligned", [
    *((*s, True) for s in EDGE_SHAPES + ENGINE_SHAPES_W64),
    (4, 64, 1000, False), (4, 64, 250, False)])
def test_emulated_kernels_match_plain_and_pallas(kind, G, W, D, aligned):
    """The kernels' index map covers every word once, gives every row one
    writer, and yields the plain version's and the Pallas kernel's outputs
    (interpret mode), ``newly`` included, bit for bit."""
    got = _check_emulation(G, W, D, aligned, kind)
    bits, upd, stable, maj = _emulation_inputs(G, W, D)
    pallas = pl_grouped if kind == "quorum" else pl_stability
    want = pallas(jnp.asarray(bits), jnp.asarray(upd), jnp.asarray(stable),
                  majority=maj, interpret=True)
    assert len(want) == (3 if kind == "quorum" else 4)
    _assert_arrays_equal(got, want)


@pytest.mark.parametrize("kind", ["quorum", "stability"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("G,W,D", MAPPING_SHAPES)
def test_emulated_kernels_match_plain_where_mapping_switches(kind, aligned,
                                                            G, W, D):
    _check_emulation(G, W, D, aligned, kind)
