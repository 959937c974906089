"""The port on a CUDA card: each CUDA kernel against its plain version
(the engine kernels bit-exact, in place and out of place; the model
kernels within the tolerances of tests/test_kernels.py; the flash
backward kernel within the same tolerances relative to the gradient's
size, and byte-equal across two launches; the WKV6 backward kernel
against its plain backward, byte-equal across two launches), launches
counted, the entry
points' default device, a small engine run (captured in a CUDA graph
and eager, against the CPU, and a replay after a state change), the
pipeline and adaptive passes captured and eager, the smoke models' serving
path and train step on the card against the same runs on the CPU, the
MoE (llama4's smoke config) on the card against the CPU under the
flip-aware routing rule, hymba's smoke config (the forward behind its
meta tokens, the captured decode past the ring's wrap, a train
step) on the card against the CPU, its train step in deterministic mode and its
checkpointed gradients against un-checkpointed ones, two trainer
pods on the card ending bitwise equal, and deepseek-v3's smoke config
(the MLA prefill at its depth and top-8 routing against the CPU under
the flip-aware rule, the captured absorbed decode against eager steps).
Every test is marked ``gpu`` and skips without a card.

This file imports only torch, numpy and repro_torch, so it also runs on
a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch import convert  # noqa: E402
from repro_torch.engine import api  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import dissem as kd  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import quorum as kq  # noqa: E402
from repro_torch.kernels import rwkv6_scan as kw  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime.statemachine import (  # noqa: E402
    Command, MergedCommandLog, TrainerStateMachine)
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

pytestmark = pytest.mark.gpu
FAMILIES = ["plain", "recycled", "gated", "gated_recycled"]


@pytest.fixture(scope="module", autouse=True)
def _cublas_workspace():
    """The cuBLAS setting that the trainer's deterministic mode asks for,
    set before this module's first matrix product on the card."""
    was = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    TR.set_cublas_workspace()
    yield
    if was is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(seed, shape, dev):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, shape, dtype=np.uint32)
    upd = rng.integers(0, 2**32, shape, dtype=np.uint32)
    stable = rng.random(shape[:-1]) < 0.3
    return (convert.bits_from_numpy(bits, dev),
            convert.bits_from_numpy(upd, dev), torch.from_numpy(stable).to(dev))


def misaligned(t):
    """A contiguous copy of ``t`` whose storage starts one int32 past a
    16-byte boundary (the kernels then load 4 bytes a lane)."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    assert t.numel() == 0 or view.data_ptr() % 16 == 4
    return view


# the edge shapes of tests/test_kernels.py, the engine's ack tile, and
# where the lane mapping switches: 2, 3, 4, 5, 9, 33 and 64 words, W = 1
# and W = 129, G = 9 clusters, W = 0
@pytest.mark.parametrize("G,W,D", [(2, 12, 32), (3, 20, 33), (1, 7, 31),
                                   (2, 36, 65), (4, 10, 1), (2, 24, 64),
                                   (4, 2048, 1000), (2, 5, 64), (2, 6, 96),
                                   (3, 9, 128), (1, 1, 160), (2, 129, 288),
                                   (9, 17, 1056), (2, 3, 2048),
                                   (9, 2048, 250), (2, 0, 32)])
@pytest.mark.parametrize("offset", ["aligned", "misaligned"])
def test_kernels_match_plain(cuda, G, W, D, offset):
    args = inputs(G + W + D, (G, W, (D + 31) // 32), cuda)
    if offset == "misaligned":
        args = (misaligned(args[0]), misaligned(args[1]), args[2])
    maj = D // 2 + 1
    for kernel, fn, plain in (
            (kq.KERNEL, kq.quorum_update_grouped,
             kq.quorum_update_grouped_plain),
            (kd.KERNEL, kd.stability_update_grouped,
             kd.stability_update_grouped_plain)):
        want = plain(*args, majority=maj)
        before = kernel.launches
        got = fn(*args, majority=maj)
        assert kernel.launches == before + 1
        buf = misaligned(args[0]) if offset == "misaligned" \
            else args[0].clone()
        got_in = fn(buf, *args[1:], majority=maj, inplace=True)
        assert got_in[0].data_ptr() == buf.data_ptr()
        for g, g_in, w in zip(got, got_in, want):
            assert torch.equal(g, w) and torch.equal(g_in, w)
    if G == 1:
        got = kq.quorum_update(args[0][0], args[1][0], args[2][0],
                               majority=maj)
        want = kq.quorum_update_grouped_plain(*args, majority=maj)
        for g, w in zip(got, want):
            assert torch.equal(g, w[0])


def test_stability_call_is_one_device_op(cuda):
    """``newly`` comes from the cluster reduction, written once: a call
    enqueues its kernel and nothing else (no fill, no memset)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = inputs(3, (4, 2048, 8), cuda)
    kd.stability_update_grouped(*args, majority=126)    # build, warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            kd.stability_update_grouped(*args, majority=126)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 10 and all("stability_kernel" in n for n in names)


@pytest.mark.parametrize("fam", FAMILIES)
def test_engine_on_card_matches_cpu(cuda, fam):
    """Entry points default to cuda; a small run there equals the CPU's,
    with 2 quorum launches per tick and 1 stability launch per gated
    tick."""
    G, W, T = 2, 16, 12
    cfg = api.EngineConfig(
        groups=G, window=W, n_diss=5, n_seq=3, order_budget=4,
        merge_capacity=T * 4,
        recycling=api.RecyclingConfig(watermark=W // 2, id_stride=4096)
        if "recycled" in fam else None,
        gating=api.GatingConfig(stab_majority=3) if "gated" in fam else None)
    rng = np.random.default_rng(FAMILIES.index(fam))
    tiles = [((rng.random((T, G, W, 1)) < p) * np.uint32(m)).astype(np.uint32)
             for p, m in ((0.7, 0x1F), (0.6, 0x7), (0.8, 0x1F))]
    if cfg.gating is None:
        tiles = tiles[:2]
    state = api.create_state(cfg)

    def leaves(x):
        if isinstance(x, tuple):
            for v in x:
                yield from leaves(v)
        elif x is not None:
            yield x
    assert all(t.is_cuda for t in leaves(state))
    before = (kq.KERNEL.launches, kd.KERNEL.launches)
    st, *res = api.run(cfg, state, *(convert.bits_from_numpy(x, cuda)
                                     for x in tiles))
    torch.cuda.synchronize()
    assert (kq.KERNEL.launches - before[0], kd.KERNEL.launches - before[1]) \
        == (2 * T, T if cfg.gating is not None else 0)
    cst, *cres = api.run(cfg, api.create_state(cfg, "cpu"),
                         *(convert.bits_from_numpy(x, "cpu") for x in tiles))
    assert [int(x) for x in res[1:]] == [int(x) for x in cres[1:]]
    assert torch.equal(res[0].cpu(), cres[0])
    got, want = (convert.engine_state_to_numpy(s) for s in (st, cst))

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        return (a is None and b is None) or np.array_equal(a, b)
    assert same(got, want)


def small_engine(fam, **over):
    G, W = 2, 16
    return api.EngineConfig(
        groups=G, window=W, n_diss=5, n_seq=3, order_budget=4,
        merge_capacity=64 * 4,
        recycling=api.RecyclingConfig(watermark=W // 2, id_stride=4096)
        if "recycled" in fam else None,
        gating=api.GatingConfig(stab_majority=3) if "gated" in fam else None,
        **over)


def small_tiles(cfg, seed, T):
    rng = np.random.default_rng(seed)
    G, W = cfg.groups, cfg.window
    tiles = [((rng.random((T, G, W, 1)) < p) * np.uint32(m)).astype(
        np.uint32) for p, m in ((0.7, 0x1F), (0.6, 0x7), (0.8, 0x1F))]
    return tiles if cfg.gating is not None else tiles[:2]


@pytest.mark.parametrize("fam", FAMILIES)
def test_captured_engine_on_card_matches_eager_and_cpu(cuda, fam):
    """Engine.run captured (the default on the card) equals the eager
    card run and the CPU run (merged log, count, committed, the whole
    state); a second run replays the same graph with no host launch."""
    from repro_torch.engine import graphs
    cfg = small_engine(fam)
    tiles = small_tiles(cfg, 40 + FAMILIES.index(fam), 24)
    runs = []
    for dev, capture in (("cpu", None), (cuda, False), (cuda, None)):
        eng = api.Engine.create(cfg, device=dev, capture=capture)
        assert eng.capture == (dev == cuda and capture is None)
        seqs = [convert.bits_from_numpy(x, dev) for x in tiles]
        out = [eng.run(*(x[:12] for x in seqs))]
        before = (kq.KERNEL.launches, kd.KERNEL.launches)
        out.append(eng.run(*(x[12:] for x in seqs)))
        if eng.capture:
            assert (kq.KERNEL.launches, kd.KERNEL.launches) == before
            loop, = eng._loops.values()
            assert loop.replays == 24
            assert all(a is b for a, b in zip(graphs.leaves(loop.state),
                                               graphs.leaves(eng.state)))
        runs.append(([(r[0].cpu(), int(r[1]), int(r[2])) for r in out],
                     convert.engine_state_to_numpy(eng.state)))
    (r0, s0), *rest = runs
    for r, st in rest:
        assert trees_equal(st, s0)
        for (m, c, k), (m0, c0, k0) in zip(r, r0):
            assert torch.equal(m, m0) and (c, k) == (c0, k0)
    assert r0[-1][2] > 0


@pytest.mark.parametrize("how", ["recycle", "tick"])
def test_replay_after_state_change_matches_eager(cuda, how):
    """A recycle or an eager tick between two captured runs on the card
    replaces state leaves outside the graph; the next replay sees them
    and equals the eager engine's same sequence."""
    cfg = small_engine("gated_recycled")
    tiles = [convert.bits_from_numpy(x, cuda)
             for x in small_tiles(cfg, 7, 25)]
    results = []
    for capture in (False, None):
        eng = api.Engine.create(cfg, device=cuda, capture=capture)
        eng.run(*(x[:12] for x in tiles))
        if how == "recycle":
            eng.recycle()
        else:
            eng.tick(*(x[12] for x in tiles))
        res = eng.run(*(x[13:] for x in tiles))
        results.append(((res[0].cpu(), int(res[1]), int(res[2])),
                        convert.engine_state_to_numpy(eng.state)))
    ((m0, *c0), s0), ((m1, *c1), s1) = results
    assert torch.equal(m1, m0) and c1 == c0 and trees_equal(s1, s0)


def test_meshed_engine_on_card_matches_unmeshed_and_cpu(cuda, tmp_path):
    """A meshed Engine.run over NCCL at world size 1 (rank 0 on cuda:0)
    equals the unmeshed card run and the CPU run: merged log, count,
    committed length and the gathered state; launches exactly 2T and
    T."""
    import torch.distributed as dist
    from datetime import timedelta
    from repro_torch.engine import meshed
    G, W, T = 4, 16, 12
    base = api.EngineConfig(
        groups=G, window=W, n_diss=5, n_seq=3, order_budget=4,
        merge_capacity=T * 4,
        recycling=api.RecyclingConfig(watermark=W // 2, id_stride=4096),
        gating=api.GatingConfig(stab_majority=3))
    cfg = dataclasses.replace(base, mesh=api.MeshConfig())
    rng = np.random.default_rng(7)
    tiles = [((rng.random((T, G, W, 1)) < p) * np.uint32(m)).astype(np.uint32)
             for p, m in ((0.7, 0x1F), (0.6, 0x7), (0.8, 0x1F))]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        assert meshed.mesh_for(cfg).backend == "nccl"
        before = (kq.KERNEL.launches, kd.KERNEL.launches)
        st, *res = api.run(cfg, api.create_state(cfg), *(
            convert.bits_from_numpy(x, cuda) for x in tiles))
        torch.cuda.synchronize()
        launches = (kq.KERNEL.launches - before[0],
                    kd.KERNEL.launches - before[1])
        got = convert.engine_state_to_numpy(st, cfg)
    finally:
        dist.destroy_process_group()
    assert st.merge.logs.device == torch.device("cuda", 0)
    assert launches == (2 * T, T)
    for dev in (cuda, "cpu"):
        ust, *ures = api.run(base, api.create_state(base, dev), *(
            convert.bits_from_numpy(x, dev) for x in tiles))
        assert [int(x) for x in res[1:]] == [int(x) for x in ures[1:]]
        assert torch.equal(res[0].cpu(), ures[0].cpu())
        assert trees_equal(got, convert.engine_state_to_numpy(ust))
    assert int(res[2]) > 0


FLASH_CASES = [
    (2, 128, 128, 4, 4, 32, 32, True, -1), (2, 256, 256, 8, 4, 64, 64, True,
                                            100),
    (2, 128, 128, 4, 2, 48, 32, True, -1), (2, 100, 130, 4, 2, 64, 48, True,
                                            -1),
    (2, 128, 128, 4, 2, 32, 32, False, 40), (1, 300, 300, 8, 1, 128, 128,
                                             True, -1),
    (2, 1000, 1000, 8, 2, 128, 128, True, -1),      # ragged, long
    (2, 130, 100, 4, 4, 32, 32, True, -1),          # Sq > Skv
    (2, 77, 77, 4, 2, 64, 64, True, 30),            # ragged window
    (2, 128, 128, 4, 2, 32, 32, False, -1),         # non-causal
    (2, 200, 200, 4, 2, 64, 64, False, 50),         # non-causal window
    (1, 256, 256, 16, 2, 128, 128, True, -1),       # G = 8
    (2, 1024, 1024, 40, 8, 128, 128, True, -1),     # qwen3-14b, G = 5
    (4, 1024, 1024, 40, 8, 128, 128, True, -1),     # llama4 prefill, G = 5
    (1, 4096, 4096, 40, 8, 128, 128, True, -1),     # its train microbatch
    (1, 256, 256, 40, 8, 128, 128, True, -1),       # its f32 checks
    (4, 1024, 1024, 28, 4, 128, 128, True, -1),     # qwen2-vl-7b, G = 7
    (1, 4096, 4096, 28, 4, 128, 128, True, -1),     # its train microbatch
    (4, 192, 192, 28, 4, 128, 128, True, -1),       # its f32 check
    (4, 1152, 1152, 25, 5, 64, 64, True, 1024),     # hymba prefill, window
    (1, 4224, 4224, 25, 5, 64, 64, True, 1024),     # its train microbatch
    (1, 1228, 1228, 25, 5, 64, 64, True, 1024),     # its f32 check
    (4, 1500, 1500, 12, 12, 64, 64, False, -1),     # whisper encoder, G = 1
    (4, 1024, 1500, 12, 12, 64, 64, False, -1),     # its cross, Sq < Skv
    (2, 4096, 1500, 12, 12, 64, 64, False, -1),     # its train cross
    (2, 4096, 4096, 12, 12, 64, 64, True, -1),      # its train decoder
    (1, 256, 1500, 12, 12, 64, 64, False, -1),      # its f32 check
    # q/k width 192 with v width 128 (deepseek-v3's MLA prefill) and a
    # padded q/k width under 192
    (2, 100, 130, 4, 2, 192, 128, True, -1),        # ragged, G = 2
    (2, 256, 300, 8, 4, 192, 128, True, 100),       # window, Sq < Skv
    (2, 256, 300, 8, 4, 192, 128, False, -1),       # bidirectional
    (2, 256, 300, 8, 4, 176, 96, False, -1),
    (2, 256, 300, 8, 4, 176, 96, True, 100),
    (1, 256, 256, 128, 128, 192, 128, True, -1),    # MLA f32 check, G = 1
    (4, 1024, 1024, 128, 128, 192, 128, True, -1)]  # MLA serve prefill
# f32 only: h and hv not multiples of 4 (the bf16 kernel takes multiples
# of 16), q/k/v 4 bytes past a 16-byte boundary (the 4-byte copy path),
# a long non-causal case
F32_CASES = [(2, 200, 300, 4, 2, 50, 36, True, -1, "aligned"),
             (2, 130, 170, 3, 1, 7, 5, False, 40, "aligned"),
             (2, 256, 256, 8, 2, 128, 128, True, -1, "misaligned"),
             (2, 100, 130, 4, 2, 64, 48, True, 40, "misaligned"),
             (1, 2048, 2048, 8, 2, 128, 128, False, -1, "aligned"),
             (2, 100, 130, 4, 2, 190, 126, True, -1, "misaligned"),
             (2, 100, 130, 4, 2, 130, 100, True, -1, "aligned")]


@pytest.mark.parametrize("B,Sq,Skv,H,K,h,hv,causal,window,offset,dtype", [
    *[(*c, "aligned", dt) for c in FLASH_CASES
      for dt in ("float32", "bfloat16")],
    *[(*c, "float32") for c in F32_CASES]])
def test_flash_kernel_matches_plain(cuda, B, Sq, Skv, H, K, h, hv, causal,
                                    window, offset, dtype):
    """bf16 goes through the tensor-core kernel, f32 through the CUDA-core
    one; each dtype advances its own kernel's count and not the other."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(Sq + H + h)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt)
               for s in ((B, Sq, H, h), (B, Skv, K, h), (B, Skv, K, hv)))
    if offset == "misaligned":
        q, k, v = misaligned(q), misaligned(k), misaligned(v)
    mine, other = ((kf.KERNEL_BF16, kf.KERNEL) if dt == torch.bfloat16
                   else (kf.KERNEL, kf.KERNEL_BF16))
    before = (mine.launches, other.launches)
    got = kf.flash_attention(q, k, v, causal=causal, window=window)
    assert (mine.launches, other.launches) == (before[0] + 1, before[1])
    want = kf.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dt == torch.float32 else 2e-2
    assert got.dtype == dt
    assert float((got.float() - want.float()).abs().max()) < tol


def test_flash_bf16_rejects_other_head_widths(cuda):
    q = torch.zeros((1, 64, 2, 40), dtype=torch.bfloat16, device=cuda)
    before = (kf.KERNEL.launches, kf.KERNEL_BF16.launches)
    with pytest.raises(ValueError, match="multiples of 16"):
        kf.flash_attention(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros((1, 64, 2, 192), dtype=torch.bfloat16, device=cuda)
    v = torch.zeros((1, 64, 2, 144), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        kf.flash_attention(q, q, v)                  # hv 144 > 128
    assert (kf.KERNEL.launches, kf.KERNEL_BF16.launches) == before


@pytest.mark.parametrize("h,hv", [(193, 128), (192, 129), (256, 64),
                                  (64, 144)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_rejects_widths_past_192_and_128(cuda, h, hv, dtype):
    """A q/k width above 192 or a v width above 128 raises, forward and
    backward, in either dtype, and launches nothing."""
    dt = getattr(torch, dtype)
    q = torch.zeros((1, 64, 2, h), dtype=dt, device=cuda)
    v = torch.zeros((1, 64, 2, hv), dtype=dt, device=cuda)
    counts = (kf.KERNEL, kf.KERNEL_BF16, kf.KERNEL_BWD, kf.KERNEL_BWD_BF16)
    before = [c.launches for c in counts]
    with pytest.raises(ValueError, match="up to"):
        kf.flash_attention(q, q, v)
    with pytest.raises(ValueError, match="up to"):
        kf.flash_attention_bwd(q, q, v, v, v, lse=torch.zeros(
            (1, 2, 64), device=cuda))
    assert [c.launches for c in counts] == before


@pytest.mark.parametrize("B,S,H,hd,w_std", [
    (2, 64, 2, 32, 1.0), (2, 128, 4, 64, 1.0), (2, 64, 1, 128, 1.0),
    (2, 256, 4, 64, 0.3), (1, 37, 2, 32, 3.0),
    (1, 4096, 8, 64, 1.0),          # 128 chunks: the scan's longest run
    (2, 1, 2, 32, 1.0),             # one token
    (2, 31, 2, 64, 1.0), (2, 33, 2, 64, 1.0),   # a chunk of 32, +- 1
    (1, 512, 4, 128, 1.0)])         # the widest head the kernel takes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_matches_plain(cuda, B, S, H, hd, w_std, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(S + hd)
    r, k, v = (torch.randn((B, S, H, hd), generator=g, device=cuda).to(dt)
               for _ in range(3))
    wlog = -torch.nn.functional.softplus(
        w_std * torch.randn((B, S, H, hd), generator=g, device=cuda)) - 1e-4
    u = 0.1 * torch.randn((H, hd), generator=g, device=cuda)
    before = kw.KERNEL.launches
    got = kw.wkv6_chunked(r, k, v, wlog, u)
    assert kw.KERNEL.launches == before + 1
    want = kw.wkv6_chunked_plain(r, k, v, wlog, u, chunk=128)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) \
        < 1e-5 * (float(want.abs().max()) + 1)


@pytest.mark.parametrize("arch,kernel", [("yi-6b", kf.KERNEL),   # f32
                                         ("rwkv6-3b", kw.KERNEL)])
def test_smoke_model_on_card_matches_cpu(cuda, arch, kernel):
    """The smoke config in f32 on one set of weights: prefill (one kernel
    launch per layer) and four decode steps on the card equal the CPU's."""
    from repro_torch import convert
    cfg = registry.get_smoke(arch).replace(dtype=torch.float32)
    lm_cpu = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    lm_dev = convert.lm_params_from_jax(convert.lm_params_to_numpy(lm_cpu),
                                        cfg, cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 160))
    outs = []
    for lm, dev in ((lm_cpu, "cpu"), (lm_dev, cuda)):
        prompts = torch.from_numpy(toks).to(dev)
        before = kernel.launches
        logits, _ = D.prefill(lm, cfg, {"tokens": prompts})
        assert kernel.launches - before == (cfg.n_layers if dev == cuda
                                            else 0)
        cache = D.cache_zeros(D.cache_spec(cfg, 2, 4), dev)
        steps = [D.decode_step(lm, cfg, {"token": prompts[:, t:t + 1],
                                         "index": t}, cache)[0]
                 for t in range(4)]
        outs.append(torch.stack([logits, *steps]).cpu())
    assert float((outs[0] - outs[1]).abs().max()) < 1e-4


def test_hymba_smoke_on_card_matches_cpu(cuda):
    """hymba's smoke config in f32 on one set of weights: the forward
    behind the meta tokens (one f32 flash launch per layer, windowed and
    global) and ``generate``'s logits (one captured CUDA graph a step on
    the card), past the ring's wrap, on the card equal the CPU's; the
    decode launches no model kernel."""
    from repro_torch import convert
    from repro_torch.launch import serve
    cfg = registry.get_smoke("hymba-1.5b").replace(dtype=torch.float32)
    lm_cpu = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    lm_dev = convert.lm_params_from_jax(convert.lm_params_to_numpy(lm_cpu),
                                        cfg, cuda)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 48))
    outs = {}
    for name, lm, dev in (("cpu", lm_cpu, "cpu"), ("card", lm_dev, cuda)):
        prompts = torch.from_numpy(toks).to(dev)
        before = kf.KERNEL.launches
        logits, _ = D.prefill(lm, cfg, {"tokens": prompts})
        assert kf.KERNEL.launches - before == (0 if dev == "cpu"
                                               else cfg.n_layers)
        before = kf.KERNEL.launches
        gen, steps = serve.generate(lm, cfg, prompts, 4, return_logits=True)
        assert kf.KERNEL.launches == before
        outs[name] = (logits.cpu(), steps.cpu(), gen.cpu())
    assert float((outs["card"][0] - outs["cpu"][0]).abs().max()) < 1e-4
    assert float((outs["card"][1] - outs["cpu"][1]).abs().max()) < 1e-4
    assert float((outs["cpu"][1][:, 47] - outs["cpu"][0]).abs().max()) \
        < 1e-4


def test_hymba_train_step_on_card_matches_cpu(cuda):
    """hymba's smoke config in f32 on one set of weights, card against
    CPU: every leaf's gradient within 1e-4 of the leaf's largest
    magnitude (floored at 1e-2; the meta tokens, A_log and w_dt
    nonzero), then one AdamW step: loss and grad_norm within 1e-4
    relative, and the parameters after it within lr/10 wherever the
    CPU's gradient exceeds 10 times the gradient tolerance. There the
    step moves each parameter by lr·sign(g) and the two devices' signs
    agree, so one update of the wrong sign (a gap of 2·lr) fails; below
    it the first AdamW step g/(|g| + eps) turns gradient rounding into
    any value up to lr."""
    from repro_torch import convert
    from repro_torch.models.common import reference_leaves
    cfg = registry.get_smoke("hymba-1.5b").replace(dtype=torch.float32)
    lr = 1e-3
    opt = O.OptConfig(kind="adamw", lr=lr)
    cpu = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    dev = convert.train_state_from_jax(convert.train_state_to_numpy(cpu),
                                       cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64)))
    grad_fn = TR.make_grad_fn(cfg, global_batch=2)
    g_cpu, _ = grad_fn(cpu["params"], {"tokens": toks})
    g_dev, _ = grad_fn(dev["params"], {"tokens": toks.to(cuda)})
    paths = [p for p, _, _ in reference_leaves(cpu["params"])]
    assert len(g_cpu) == len(g_dev) == len(paths)
    clear = []
    for path, a, b in zip(paths, g_dev, g_cpu):
        for x, y in zip(a, b):
            tol = 1e-4 * max(1e-2, float(y.abs().max()))
            assert float((x.cpu() - y).abs().max()) <= tol, path
            if path[-1] in ("meta_tokens", "A_log", "w_dt"):
                assert float(y.abs().max()) > 0, path
            clear.append(y.abs() > 10 * tol)
    step = TR.make_train_step(cfg, opt, global_batch=2)
    cpu, m_cpu = step(cpu, {"tokens": toks})
    dev, m_dev = step(dev, {"tokens": toks.to(cuda)})
    for k in ("loss", "grad_norm"):
        assert abs(float(m_dev[k]) - float(m_cpu[k])) \
            <= 1e-4 * abs(float(m_cpu[k]))
    after = [t for _, ts, _ in reference_leaves(cpu["params"]) for t in ts]
    after_dev = [t for _, ts, _ in reference_leaves(dev["params"])
                 for t in ts]
    assert len(after) == len(after_dev) == len(clear)
    assert sum(int(m.sum()) for m in clear) > 0
    for x, y, m in zip(after_dev, after, clear):
        gap = (x.detach().cpu() - y.detach()).abs()
        assert not bool((gap[m] > lr / 10).any())


def test_whisper_smoke_on_card_matches_cpu(cuda):
    """whisper's smoke config in f32 on one set of weights, card against
    CPU: the prefill (encoder, causal and cross f32 flash launches, 3 a
    layer) and ``generate``'s logits (the frames encoded once, then one
    captured CUDA graph a step on the card, which launches no model
    kernel and reads the cross cache written before the capture)."""
    from repro_torch import convert
    from repro_torch.launch import serve
    cfg = registry.get_smoke("whisper-small").replace(dtype=torch.float32)
    lm_cpu = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    lm_dev = convert.lm_params_from_jax(convert.lm_params_to_numpy(lm_cpu),
                                        cfg, cuda)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 24))
    frames = rng.standard_normal((2, cfg.encoder_len, cfg.d_model)) \
        .astype(np.float32)
    layers = cfg.encoder_layers + 2 * cfg.n_layers
    outs = {}
    for name, lm, dev in (("cpu", lm_cpu, "cpu"), ("card", lm_dev, cuda)):
        prompts = torch.from_numpy(toks).to(dev)
        fr = torch.from_numpy(frames).to(dev)
        before = kf.KERNEL.launches
        logits, _ = D.prefill(lm, cfg, {"tokens": prompts, "frames": fr})
        assert kf.KERNEL.launches - before == (0 if dev == "cpu"
                                               else layers)
        before = kf.KERNEL.launches
        gen, steps = serve.generate(lm, cfg, prompts, 4, frames=fr,
                                    return_logits=True)
        assert kf.KERNEL.launches - before == (0 if dev == "cpu"
                                               else cfg.encoder_layers)
        outs[name] = (logits.cpu(), steps.cpu(), gen.cpu())
    assert float((outs["card"][0] - outs["cpu"][0]).abs().max()) < 1e-4
    assert float((outs["card"][1] - outs["cpu"][1]).abs().max()) < 1e-4
    assert float((outs["cpu"][1][:, 23] - outs["cpu"][0]).abs().max()) \
        < 1e-4


def test_whisper_train_step_on_card_matches_cpu(cuda):
    """whisper's smoke config in f32 on one set of weights, card against
    CPU: every leaf's gradient within 1e-4 of the leaf's largest
    magnitude (floored at 1e-2; the encoder's and the cross-attention's
    nonzero), with 2 x 3 L forward and 3 L backward f32 flash launches
    on the card, and the loss within 1e-4 relative."""
    from repro_torch import convert
    from repro_torch.models.common import reference_leaves
    cfg = registry.get_smoke("whisper-small").replace(dtype=torch.float32)
    opt = O.OptConfig(kind="adamw", lr=1e-3)
    cpu = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    dev = convert.train_state_from_jax(convert.train_state_to_numpy(cpu),
                                       cfg, cuda)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, cfg.encoder_len, cfg.d_model)).astype(np.float32))}
    grad_fn = TR.make_grad_fn(cfg, global_batch=2)
    g_cpu, l_cpu = grad_fn(cpu["params"], batch)
    before = (kf.KERNEL.launches, kf.KERNEL_BWD.launches)
    g_dev, l_dev = grad_fn(dev["params"],
                           {k: v.to(cuda) for k, v in batch.items()})
    layers = cfg.encoder_layers + 2 * cfg.n_layers
    assert (kf.KERNEL.launches - before[0],
            kf.KERNEL_BWD.launches - before[1]) == (2 * layers, layers)
    assert abs(float(l_dev) - float(l_cpu)) <= 1e-4 * abs(float(l_cpu))
    paths = [p for p, _, _ in reference_leaves(cpu["params"])]
    assert len(g_cpu) == len(g_dev) == len(paths)
    for path, a, b in zip(paths, g_dev, g_cpu):
        for x, y in zip(a, b):
            tol = 1e-4 * max(1e-2, float(y.abs().max()))
            assert float((x.cpu() - y).abs().max()) <= tol, path
            if path[0] in ("encoder", "cross"):
                assert float(y.abs().max()) > 0, path


def test_model_entry_points_default_to_the_card(cuda):
    cfg = registry.get_smoke("rwkv6-3b")
    lm = T.init_lm(cfg, torch.Generator(cuda).manual_seed(0))
    assert all(p.is_cuda for p in lm.parameters())
    cache = D.cache_zeros(D.cache_spec(cfg, 1, 4))
    assert all(t.is_cuda for t in cache["seg0"].values())


# -- epochs and the closed pipeline on the card -------------------------------

def pipeline_tree(state):
    """A pipeline state → nested numpy dicts (bitsets as uint32)."""
    return {f: convert.engine_state_to_numpy(v) if f == "engine"
            else pipeline_tree(v) if isinstance(v, tuple)
            else v.cpu().numpy() for f, v in state._asdict().items()}


def trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k])
                                            for k in a)
    return (a is None and b is None) or (a.dtype == b.dtype
                                         and np.array_equal(a, b))


def test_route_ids_on_card_match_cpu(cuda):
    from repro_torch.engine import epochs, router
    ids = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint32)
    ids[:2] = (2**31, 2**32 - 1)
    host = torch.from_numpy(ids.view(np.int32))
    for groups in (3, 4, 70000):
        got = router.route_ids(host.to(cuda), groups)
        assert got.is_cuda and torch.equal(got.cpu(),
                                           router.route_ids(host, groups))
    table = epochs.EpochTable(((0, 2), (0, 1, 2, 3)), n_rows=4)
    for e in range(2):
        assert torch.equal(epochs.route_ids_epoch(host.to(cuda), table,
                                                  e).cpu(),
                           epochs.route_ids_epoch(host, table, e))


def test_workload_model_on_card_is_deterministic(cuda):
    from repro_torch.pipeline import WorkloadModel
    m = WorkloadModel(n_clients=64, arrival_rate=0.3,
                      size_choices=(128, 1024), size_probs=(0.25, 0.75))
    a, b = (m.draw(torch.Generator(cuda).manual_seed(4), 20)
            for _ in range(2))
    assert a.arrived.is_cuda and torch.equal(a.sizes, b.sizes)
    assert torch.equal(a.arrived, b.arrived) and 0 < a.n_requests < 1280


@pytest.mark.parametrize("capture", [False, None])
@pytest.mark.parametrize("inplace", [False, True])
def test_pipeline_on_card_matches_cpu(cuda, inplace, capture):
    """G=3, D=5 with a shrink to rows (0, 1) after a drain: the run on
    the card equals the CPU's, state field by field, merged log and
    report. Eager on the card (``capture=False``): 2 quorum and 1
    stability launch per tick. Captured (the default there): both
    segments replay one loop kept in the caller's dict (segment B's
    table copied in), whose capture recorded 2 and 1, 40 times; the
    drains tick on the host."""
    from repro_torch import pipeline as P
    from repro_torch.engine.epochs import EpochTable
    ecfg = api.EngineConfig(
        groups=3, window=16, n_diss=5, n_seq=3, order_budget=4,
        merge_capacity=3 * 256,
        recycling=api.RecyclingConfig(watermark=8, id_stride=4096),
        gating=api.GatingConfig(),
        epochs=EpochTable(((0, 1, 2), (0, 1)), n_rows=3))
    cfg = P.PipelineConfig(engine=ecfg, n_clients=10, budget_bytes=2500,
                           ack_lag=(0, 1, 1, 2, 2), hold_lag=(0, 0, 1, 1, 2),
                           vote_lag=(1, 1, 2), capacity=128, seq_capacity=64)
    rng = np.random.default_rng(2)
    arrived = rng.random((40, 10)) < 0.4
    sizes = np.where(arrived, rng.choice([200, 900, 1800], (40, 10)),
                     0).astype(np.int32)
    results = []
    for dev in ("cpu", cuda):
        a, s = (torch.from_numpy(x).to(dev) for x in (arrived, sizes))
        quiet = (torch.zeros_like(a[0]), torch.zeros_like(s[0]))
        rts = [torch.from_numpy(P.build_route_table(cfg, e)).to(dev)
               for e in (0, 1)]
        before = (kq.KERNEL.launches, kd.KERNEL.launches)
        loops = {}
        st, o1 = P.run_pipeline(cfg, P.init_pipeline(cfg, dev), a[:20],
                                s[:20], rts[0], inplace=inplace,
                                capture=capture, loops=loops)
        for _ in range(16):
            st, _ = P.pipeline_tick(cfg, st, *quiet, rts[0], inplace=inplace)
        st, report = P.reconfigure_pipeline(cfg, st, 0, 1)
        st, o2 = P.run_pipeline(cfg, st, a[20:], s[20:], rts[1],
                                inplace=inplace, capture=capture,
                                loops=loops)
        for _ in range(16):
            st, _ = P.pipeline_tick(cfg, st, *quiet, rts[1], inplace=inplace)
        launches = (kq.KERNEL.launches - before[0],
                    kd.KERNEL.launches - before[1])
        if dev != cuda:
            assert launches == (0, 0)
        elif capture is False:
            assert launches == (2 * 72, 72)
        else:
            loop, = loops.values()
            rec = (loop.recorded["quorum_update_grouped"],
                   loop.recorded["stability_update_grouped"])
            assert rec == (2, 1) and loop.replays == 40
            # the drains, then the loop's warm-up and captured tick
            assert launches == (2 * 32 + 2 * rec[0], 32 + 2 * rec[1])
        merged, count, com = P.committed(cfg, st)
        assert not bool(st.overflowed)
        assert int(o1["dropped"].sum()) == int(o2["dropped"].sum()) == 0
        assert int(com) == int(st.admit_count.sum()) > 0
        results.append((pipeline_tree(st), merged.cpu(), int(count),
                        int(com), report,
                        P.decode_merged(cfg, st, merged, com)))
    (t0, m0, *r0), (t1, m1, *r1) = results
    assert trees_equal(t1, t0) and torch.equal(m1, m0) and r1 == r0


# -- adaptive tick batching on the card ---------------------------------------

@pytest.mark.parametrize("capture", [False, None])
@pytest.mark.parametrize("fam", FAMILIES)
def test_adaptive_on_card_matches_cpu(cuda, fam, capture):
    """A skewed queue (group 0 four times the others' tiles) drained by
    Engine.adaptive_pass on the card equals the same passes on the CPU
    (every pass's R, the whole state and queue, the merged log). Eager
    on the card: exactly 2·ΣR quorum and ΣR stability launches (gated).
    Captured (the default there): each pass one replay of the fixed-K
    pass, whose capture recorded 2K and K launches; the host counted a
    warm-up and the captured pass."""
    from repro_torch.engine import adaptive as ad
    G, W, T = 3, 16, 12
    cfg = api.EngineConfig(
        groups=G, window=W, n_diss=5, n_seq=3, order_budget=4,
        merge_capacity=1024,
        recycling=api.RecyclingConfig(watermark=W // 2, id_stride=4096)
        if "recycled" in fam else None,
        gating=api.GatingConfig(stab_majority=3) if "gated" in fam else None,
        adaptive=ad.AdaptiveConfig(max_tiles_per_tick=4, queue_capacity=T))
    rng = np.random.default_rng(10 + FAMILIES.index(fam))
    tiles = [((rng.random((T, G, W, 1)) < p) * np.uint32(m)).astype(np.uint32)
             for p, m in ((0.7, 0x1F), (0.6, 0x7), (0.8, 0x1F))]
    if cfg.gating is None:
        tiles = tiles[:2]
    lens = [T, T // 4, T // 4]
    runs = []
    for dev in ("cpu", cuda):
        eng = api.Engine.create(cfg, device=dev,
                                capture=capture if dev == cuda else None)
        eng.queue = ad.queue_from_arrays(
            cfg, *(convert.bits_from_numpy(x, dev) for x in tiles),
            lengths=lens)
        before = (kq.KERNEL.launches, kd.KERNEL.launches)
        rounds = []
        while (r := int(eng.adaptive_pass()["rounds"])) > 0:
            rounds.append(r)
        launches = (kq.KERNEL.launches - before[0],
                    kd.KERNEL.launches - before[1])
        gated = cfg.gating is not None
        if dev != cuda:
            assert launches == (0, 0)
        elif capture is False:
            assert launches == (2 * sum(rounds), sum(rounds) if gated else 0)
        else:
            K = cfg.adaptive.max_tiles_per_tick
            loop, = eng._loops.values()
            rec = (loop.recorded["quorum_update_grouped"],
                   loop.recorded["stability_update_grouped"])
            assert rec == (2 * K, K if gated else 0)
            assert loop.replays == len(rounds) + 1
            assert launches == (2 * rec[0], 2 * rec[1])
        merged, count, com = eng.committed()
        runs.append((rounds, convert.engine_state_to_numpy(eng.state),
                     convert.queue_to_numpy(eng.queue), merged.cpu(),
                     int(count), int(com)))
    (r0, s0, q0, m0, *c0), (r1, s1, q1, m1, *c1) = runs
    assert r1 == r0 and max(r0) > 1 and c1 == c0 and c0[1] > 0
    assert trees_equal(s1, s0) and trees_equal(q1, q0)
    assert torch.equal(m1, m0)


def test_pipeline_subtick_on_card_matches_cpu(cuda):
    """The closed pipeline in its adaptive subtick mode, G=3, D=5: the
    card's run equals the CPU's (state, merged log, every tick's R), with
    2·ΣR quorum and ΣR stability launches."""
    from repro_torch import pipeline as P
    from repro_torch.engine.adaptive import AdaptiveConfig
    ecfg = api.EngineConfig(
        groups=3, window=16, n_diss=5, n_seq=3, order_budget=4,
        merge_capacity=3 * 1024,
        recycling=api.RecyclingConfig(watermark=8, id_stride=4096),
        gating=api.GatingConfig(),
        adaptive=AdaptiveConfig(max_tiles_per_tick=3, policy="unstable"))
    cfg = P.PipelineConfig(engine=ecfg, n_clients=10, budget_bytes=2500,
                           ack_lag=(0, 1, 1, 2, 2), hold_lag=(0, 0, 1, 1, 2),
                           vote_lag=(1, 2, 2), capacity=128, seq_capacity=64)
    rng = np.random.default_rng(3)
    arrived = np.concatenate([rng.random((25, 10)) < 0.6,
                              np.zeros((15, 10), bool)])
    sizes = np.where(arrived, rng.choice([100, 400], (40, 10)),
                     0).astype(np.int32)
    results = []
    for dev in ("cpu", cuda):
        a, s = (torch.from_numpy(x).to(dev) for x in (arrived, sizes))
        rt = torch.from_numpy(P.build_route_table(cfg)).to(dev)
        before = (kq.KERNEL.launches, kd.KERNEL.launches)
        st, outs = P.run_pipeline(cfg, P.init_pipeline(cfg, dev), a, s, rt,
                                  inplace=True)
        n = int(outs["rounds"].sum())
        launches = (kq.KERNEL.launches - before[0],
                    kd.KERNEL.launches - before[1])
        assert launches == ((2 * n, n) if dev == cuda else (0, 0))
        merged, count, com = P.committed(cfg, st)
        assert int(outs["dropped"].sum()) == 0 and not bool(st.overflowed)
        assert int(com) == int(st.admit_count.sum()) > 0
        results.append((pipeline_tree(st), merged.cpu(), int(count),
                        int(com), outs["rounds"].cpu()))
    (t0, m0, *r0, k0), (t1, m1, *r1, k1) = results
    assert int(k0.max()) > 1 and torch.equal(k1, k0)
    assert trees_equal(t1, t0) and torch.equal(m1, m0) and r1 == r0


# (B, Sq, Skv, H, K, h, hv, causal, window): causal and not, windows,
# Sq != Skv, G = 1, 5, 7 and 8, h 16 / 64 / 128, hv != h, lengths off the
# tiles
BWD_CASES = [(2, 256, 256, 8, 4, 64, 64, True, 100),
             (2, 128, 128, 4, 2, 32, 32, False, -1),
             (2, 128, 128, 4, 2, 32, 32, False, 40),
             (2, 100, 130, 4, 2, 64, 48, True, -1),
             (2, 130, 100, 4, 4, 16, 16, True, -1),
             (2, 77, 77, 8, 8, 16, 16, True, 30),
             (2, 256, 256, 16, 2, 128, 128, True, -1),
             (2, 200, 300, 4, 2, 50, 36, True, -1),
             (1, 1000, 1000, 8, 2, 128, 128, True, -1),
             (2, 1024, 1024, 40, 8, 128, 128, True, -1),   # qwen3-14b
             (1, 4096, 4096, 40, 8, 128, 128, True, -1),   # llama4 train
             (1, 256, 256, 40, 8, 128, 128, True, -1),     # its f32 step
             (4, 1024, 1024, 28, 4, 128, 128, True, -1),   # qwen2-vl-7b
             (1, 4096, 4096, 28, 4, 128, 128, True, -1),   # its microbatch
             (1, 256, 256, 28, 4, 128, 128, True, -1),     # its f32 step
             (1, 4224, 4224, 25, 5, 64, 64, True, 1024),   # hymba train
             (1, 384, 384, 25, 5, 64, 64, True, 1024),     # its f32 step
             (2, 1500, 1500, 12, 12, 64, 64, False, -1),   # whisper encoder
             (2, 4096, 1500, 12, 12, 64, 64, False, -1),   # its cross
             (1, 256, 1500, 12, 12, 64, 64, False, -1),    # its f32 step
             # q/k width 192, v width 128 (deepseek-v3's MLA)
             (2, 100, 130, 4, 2, 192, 128, True, -1),      # ragged, G = 2
             (2, 256, 300, 8, 4, 192, 128, True, 100),     # window
             (2, 256, 300, 8, 4, 176, 96, False, -1),      # bidirectional
             (1, 256, 256, 128, 128, 192, 128, True, -1)]  # MLA f32 step


def bwd_inputs(seed, B, Sq, Skv, H, K, h, hv, dt, dev):
    g = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
               for s in ((B, Sq, H, h), (B, Skv, K, h), (B, Skv, K, hv)))
    do = torch.randn((B, Sq, H, hv), generator=g, device=dev).to(dt)
    return q, k, v, do


def bwd_counts():
    return kf.KERNEL_BWD.launches, kf.KERNEL_BWD_BF16.launches


@pytest.mark.parametrize("B,Sq,Skv,H,K,h,hv,causal,window", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain(cuda, B, Sq, Skv, H, K, h, hv,
                                        causal, window, dtype):
    """dq, dk, dv of one kernel call against the plain formulas on the
    same inputs: the forward's tolerances (f32 2e-5, bf16 2e-2) times
    max(1, the gradient's largest magnitude). Each dtype's backward kernel
    takes o and the LSE of its forward kernel and raises without the LSE
    (f32 on the CUDA cores, bf16 on the tensor cores, which also raises
    for a head width that is not a multiple of 16)."""
    dt = getattr(torch, dtype)
    q, k, v, do = bwd_inputs(Sq + H + h, B, Sq, Skv, H, K, h, hv, dt, cuda)
    if dt == torch.bfloat16 and (h % 16 or hv % 16):
        with pytest.raises(ValueError, match="multiples of 16"):
            kf.flash_attention_bwd(q, k, v, do, do, causal=causal,
                                   window=window,
                                   lse=torch.zeros((B, H, Sq), device=cuda))
        return
    o, lse = kf.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    with pytest.raises(ValueError, match="log-sum-exp"):
        kf.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window)
    before = bwd_counts()
    got = kf.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                 window=window, lse=lse)
    assert bwd_counts() == (before[0] + (dt == torch.float32),
                            before[1] + (dt == torch.bfloat16))
    want = kf.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        window=window)
    tol = 2e-5 if dt == torch.float32 else 2e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dt and a.shape == b.shape, name
        scale = max(1.0, float(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) <= tol * scale, \
            name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bytes, on either
    route."""
    dt = getattr(torch, dtype)
    q, k, v, do = bwd_inputs(7, 2, 512, 512, 16, 2, 128, 128, dt, cuda)
    o, lse = kf.flash_attention_fwd_lse(q, k, v)
    before = bwd_counts()
    first = kf.flash_attention_bwd(q, k, v, o, do, lse=lse)
    second = kf.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert bwd_counts() == (before[0] + 2 * (dt == torch.float32),
                            before[1] + 2 * (dt == torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_is_deterministic_at_192(cuda, dtype):
    """The same at q/k width 192 and v width 128 (the bf16 route's two
    dk/dv passes): two launches give the same bytes."""
    dt = getattr(torch, dtype)
    q, k, v, do = bwd_inputs(8, 1, 512, 512, 16, 16, 192, 128, dt, cuda)
    o, lse = kf.flash_attention_fwd_lse(q, k, v)
    before = bwd_counts()
    first = kf.flash_attention_bwd(q, k, v, o, do, lse=lse)
    second = kf.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert bwd_counts() == (before[0] + 2 * (dt == torch.float32),
                            before[1] + 2 * (dt == torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def by_head_groups(fn, tensors, H, n):
    """``fn`` (a plain version) on heads [i, i + H / n) of each tensor,
    concatenated over the head axis: at G = 1 a head's output depends on
    that head alone, and the groups bound the plain scores' memory."""
    step = H // n
    outs = [fn(*(t[:, :, i:i + step] for t in tensors))
            for i in range(0, H, step)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=2)
    return tuple(torch.cat(parts, dim=2) for parts in zip(*outs))


def test_flash_mla_train_shape_matches_plain(cuda):
    """deepseek-v3's train microbatch (q [1, 4096, 128, 192], v width 128,
    causal, G = 1) in bf16: the forward with its LSE and the backward, one
    launch each, against the plain versions taken over 8 groups of 16
    heads, within the bf16 tolerances."""
    q, k, v, do = bwd_inputs(9, 1, 4096, 4096, 128, 128, 192, 128,
                             torch.bfloat16, cuda)
    before = (kf.KERNEL_BF16.launches, kf.KERNEL_BWD_BF16.launches)
    o, lse = kf.flash_attention_fwd_lse(q, k, v)
    got = kf.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert (kf.KERNEL_BF16.launches, kf.KERNEL_BWD_BF16.launches) == (
        before[0] + 1, before[1] + 1)
    want_o = by_head_groups(kf.flash_attention_plain, (q, k, v), 128, 8)
    assert float((o.float() - want_o.float()).abs().max()) < 2e-2
    del want_o
    want = by_head_groups(kf.flash_attention_bwd_plain, (q, k, v, o, do),
                          128, 8)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        scale = max(1.0, float(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale, \
            name


@pytest.mark.parametrize("B,Sq,Skv,H,K,h,hv,causal,window",
                         [(2, 200, 300, 4, 2, 50, 36, True, -1),
                          (2, 256, 256, 8, 2, 128, 128, True, -1),
                          (2, 100, 130, 4, 2, 190, 126, True, -1)])
def test_f32_bwd_takes_misaligned_inputs(cuda, B, Sq, Skv, H, K, h, hv,
                                         causal, window):
    """q, k, v, o and do 4 bytes past a 16-byte boundary: the f32
    backward's 4-byte copy path, within 2e-5 x max(1, the gradient's
    largest magnitude) of the plain formulas, one launch."""
    q, k, v, do = (misaligned(t) for t in bwd_inputs(
        Sq + h + 2, B, Sq, Skv, H, K, h, hv, torch.float32, cuda))
    o, lse = kf.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    o = misaligned(o)
    assert kf.f32_plan(h, hv, q.data_ptr(), o.data_ptr())[-1] == 0
    before = bwd_counts()
    got = kf.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                 window=window, lse=lse)
    assert bwd_counts() == (before[0] + 1, before[1])
    want = kf.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 2e-5 * scale, name


# (B, Sq, Skv, H, K, h, hv, causal, window) of the forward's LSE; f32 also
# takes odd widths
LSE_CASES = [(2, 256, 256, 8, 4, 64, 64, True, 100),
             (2, 128, 128, 4, 2, 32, 32, False, 40),
             (2, 100, 130, 4, 2, 64, 48, True, -1),
             (2, 130, 100, 4, 4, 16, 16, True, -1),
             (1, 1000, 1000, 8, 2, 128, 128, True, -1)]


F32_LSE_CASES = [*LSE_CASES, (2, 200, 300, 4, 2, 50, 36, True, -1),
                 (2, 130, 170, 3, 1, 7, 5, False, 40)]


@pytest.mark.parametrize("B,Sq,Skv,H,K,h,hv,causal,window", F32_LSE_CASES)
def test_f32_forward_bytes_do_not_depend_on_lse(cuda, B, Sq, Skv, H, K, h,
                                                hv, causal, window):
    """The f32 forward's output is the same bytes whether or not it
    writes the LSE."""
    q, k, v, _ = bwd_inputs(Sq + h, B, Sq, Skv, H, K, h, hv, torch.float32,
                            cuda)
    before = kf.KERNEL.launches
    plain_out = kf.flash_attention(q, k, v, causal=causal, window=window)
    out, lse = kf.flash_attention_fwd_lse(q, k, v, causal=causal,
                                          window=window)
    assert kf.KERNEL.launches == before + 2
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert torch.equal(out, plain_out)


@pytest.mark.parametrize("B,Sq,Skv,H,K,h,hv,causal,window", F32_LSE_CASES)
def test_f32_forward_lse_matches_plain(cuda, B, Sq, Skv, H, K, h, hv,
                                       causal, window):
    """The LSE the f32 forward writes against the plain log2-domain
    logsumexp of the scaled, masked scores, within 1e-4 (log2 units; the
    two sum the exponentials in another order in f32)."""
    q, k, v, _ = bwd_inputs(Sq + h + 1, B, Sq, Skv, H, K, h, hv,
                            torch.float32, cuda)
    _, lse = kf.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    want = kf.flash_attention_lse_plain(q, k, causal=causal, window=window)
    assert float((lse - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("B,Sq,Skv,H,K,h,hv,causal,window", LSE_CASES)
def test_bf16_forward_bytes_do_not_depend_on_lse(cuda, B, Sq, Skv, H, K, h,
                                                 hv, causal, window):
    """The bf16 forward's output is the same bytes whether or not it
    writes the LSE (serving passes a null pointer, training does not)."""
    q, k, v, _ = bwd_inputs(Sq + h, B, Sq, Skv, H, K, h, hv,
                            torch.bfloat16, cuda)
    before = kf.KERNEL_BF16.launches
    plain_out = kf.flash_attention(q, k, v, causal=causal, window=window)
    out, lse = kf.flash_attention_fwd_lse(q, k, v, causal=causal,
                                          window=window)
    assert kf.KERNEL_BF16.launches == before + 2
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert torch.equal(out, plain_out)


@pytest.mark.parametrize("B,Sq,Skv,H,K,h,hv,causal,window", LSE_CASES)
def test_bf16_forward_lse_matches_plain(cuda, B, Sq, Skv, H, K, h, hv,
                                        causal, window):
    """The LSE the bf16 forward writes against the plain log2-domain
    logsumexp of the scaled, masked scores on the same inputs, within
    1e-3 (log2 units: a relative error of 0.07 % in P, below a bf16 ulp
    of it; the two sum the exponentials in another order)."""
    q, k, v, _ = bwd_inputs(Sq + h + 1, B, Sq, Skv, H, K, h, hv,
                            torch.bfloat16, cuda)
    _, lse = kf.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    want = kf.flash_attention_lse_plain(q, k, causal=causal, window=window)
    assert float((lse - want).abs().max()) <= 1e-3


def test_flash_autograd_on_card_matches_cpu(cuda):
    """Autograd through the kernels (forward and backward launched once
    each) against autograd through the plain version on the CPU."""
    q, k, v, do = bwd_inputs(3, 2, 96, 96, 8, 2, 32, 32, torch.float32,
                             cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = kf.KERNEL_BWD.launches
        out = kf.flash_attention(*xs, window=50)
        out.backward(do.to(dev))
        assert kf.KERNEL_BWD.launches == before + (dev.type == "cuda")
        grads.append([x.grad.cpu() for x in xs])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 2e-5 * max(
            1.0, float(b.abs().max()))


# the forward's cases of chip_smoke.py (WKV_CASES) and the rwkv6-3b train
# microbatch: (B, S, H, hd, dtype, std of the raw decay)
WKV_BWD_CASES = [
    (1, 4096, 40, 64, "bfloat16", 0.3),     # train/rwkv6-3b microbatch
    (4, 1024, 40, 64, "bfloat16", 0.3), (4, 1024, 40, 64, "float32", 0.3),
    *[(2, S, H, hd, dt, 1.0) for dt in ("float32", "bfloat16")
      for (S, H, hd) in ((64, 2, 32), (128, 4, 64), (64, 1, 128))],
    (2, 256, 4, 64, "float32", 0.3), (2, 300, 4, 64, "float32", 3.0),
    (1, 37, 2, 32, "float32", 1.0), (1, 4096, 8, 64, "bfloat16", 1.0),
    (2, 1, 2, 32, "float32", 1.0), (2, 31, 2, 64, "float32", 1.0),
    (2, 33, 2, 64, "bfloat16", 1.0), (1, 512, 4, 128, "bfloat16", 1.0),
    (1, 256, 2, 50, "float32", 1.0),        # hd not a multiple of 8
    # lengths that end inside an 8-token leaf (17) and on a half's edge
    # (48 = a chunk and a half)
    (2, 17, 2, 32, "float32", 1.0), (2, 17, 2, 128, "bfloat16", 1.0),
    (2, 48, 2, 128, "float32", 1.0), (2, 48, 2, 32, "bfloat16", 1.0)]


def wkv_bwd_tol(name: str, dtype) -> float:
    """The backward kernel against its plain version at the kernel's chunk
    of 32, relative to (max |plain| + 1): f32 2e-5 (both compute in f32
    from the same values, but each decay factor is the exponential of a
    difference of two cumulative log decays, which reach ~10^2 in a chunk
    of a steep decay: its f32 rounding is ~1e-5 of the factor in each);
    dr, dk and dv in bf16 8e-3, one bf16 ulp of the largest value
    (2^-7), as the two f32 results may round to neighbouring bf16
    values."""
    return 8e-3 if dtype == torch.bfloat16 and name in ("dr", "dk", "dv") \
        else 2e-5


@pytest.mark.parametrize("B,S,H,hd,dtype,w_std", WKV_BWD_CASES)
def test_wkv6_backward_kernel_matches_plain(cuda, B, S, H, hd, dtype, w_std):
    """WKV6's backward on the card is one launch of the backward kernel
    (and the forward one of the forward kernel); its gradients equal the
    plain backward's within :func:`wkv_bwd_tol`, and a second launch on
    the same saved tensors gives the same bytes."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(S + hd + 1)
    r, k, v = (torch.randn((B, S, H, hd), generator=g, device=cuda).to(dt)
               for _ in range(3))
    wlog = -torch.nn.functional.softplus(
        w_std * torch.randn((B, S, H, hd), generator=g, device=cuda)) - 1e-4
    u = 0.1 * torch.randn((H, hd), generator=g, device=cuda)
    do = torch.randn((B, S, H, hd), generator=g, device=cuda)
    xs = [x.clone().requires_grad_() for x in (r, k, v, wlog, u)]
    before = (kw.KERNEL.launches, kw.KERNEL_BWD.launches)
    out = kw.wkv6_chunked(*xs)
    got = torch.autograd.grad(out, xs, do, retain_graph=True)
    assert (kw.KERNEL.launches, kw.KERNEL_BWD.launches) \
        == (before[0] + 1, before[1] + 1)
    again = torch.autograd.grad(out, xs, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = kw.wkv6_chunked_bwd_plain(r, k, v, wlog, u, do, chunk=kw.CHUNK)
    for name, a, b in zip(("dr", "dk", "dv", "dwlog", "du"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.float().abs().max()) + 1.0
        assert float((a.float() - b.float()).abs().max()) \
            <= wkv_bwd_tol(name, dt) * scale, name


def test_wkv6_backward_kernel_rejects_bad_inputs(cuda):
    """A head dim past 128, a non-contiguous dout and a workspace of the
    wrong size raise before any launch."""
    r, k, v = (torch.randn((1, 40, 2, 32), device=cuda) for _ in range(3))
    wlog = -torch.ones((1, 40, 2, 32), device=cuda)
    u = torch.zeros((2, 32), device=cuda)
    do = torch.randn((1, 40, 2, 32), device=cuda)
    states = torch.zeros((kw.workspace_floats(1, 40, 2, 32),), device=cuda)
    before = kw.KERNEL_BWD.launches
    wide = torch.zeros((1, 40, 2, 130), device=cuda)
    with pytest.raises(ValueError, match="up to 128"):
        kw.wkv6_bwd(wide, wide, wide, wide - 1, torch.zeros((2, 130),
                                                            device=cuda),
                    wide, states)
    with pytest.raises(ValueError, match="dout must be contiguous"):
        kw.wkv6_bwd(r, k, v, wlog, u, do.transpose(2, 3).contiguous()
                    .transpose(2, 3), states)
    with pytest.raises(ValueError, match="workspace"):
        kw.wkv6_bwd(r, k, v, wlog, u, do, states[1:])
    assert kw.KERNEL_BWD.launches == before


def test_smoke_train_step_on_card_matches_cpu(cuda):
    """yi-6b's smoke config in f32, AdamW, two microbatches: loss,
    grad_norm and every gradient leaf on the card against the CPU (f32
    rounding in a different order: 1e-4 relative)."""
    cfg = registry.get_smoke("yi-6b").replace(dtype=torch.float32)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (4, 128))
    out = []
    for dev in ("cpu", cuda):
        lm = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        lm = convert.lm_params_from_jax(convert.lm_params_to_numpy(lm), cfg,
                                        dev)
        grads_of = TR.make_grad_fn(cfg, microbatches=2, global_batch=4)
        grads, loss = grads_of(lm, {"tokens": torch.from_numpy(toks).to(dev)})
        out.append((float(loss), [g.cpu() for leaf in grads for g in leaf]))
    assert abs(out[0][0] - out[1][0]) <= 1e-4 * abs(out[0][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1e-3, float(a.abs().max()))


def test_pods_on_card_end_bitwise_equal(cuda):
    """Two pods of yi-6b's smoke config (bf16, Adafactor) apply one merged
    log fed in two interleavings: equal digests, and equal to a third run
    of the same steps."""
    cfg = registry.get_smoke("yi-6b")
    opt = O.OptConfig(kind="adafactor", lr=1e-3)
    step = TR.make_train_step(cfg, opt, microbatches=2, global_batch=4)
    store = {f"b_{i}": {"tokens": torch.from_numpy(
        np.random.default_rng(i).integers(0, cfg.vocab, (4, 64))).to(cuda)}
        for i in range(3)}
    decided = [(0, 0, Command("STEP", "b_0")), (1, 0, Command("NOOP")),
               (0, 1, Command("STEP", "b_1")), (1, 1, Command("STEP", "b_2"))]
    pods = []
    for order in (decided, decided[::-1]):
        sm = TrainerStateMachine("pod", step, TR.make_state(
            cfg, opt, torch.Generator(cuda).manual_seed(0), cuda), store)
        log = MergedCommandLog(2, apply=sm.apply)
        for g, i, cmd in order:
            log.feed(g, i, cmd)
        assert log.audit() == [] and sm.step == 3
        pods.append(sm)
    assert pods[0].digest() == pods[1].digest()


# -- the MoE (llama4-maverick's smoke config) on the card ---------------------

MOE_ARCH = "llama4-maverick-400b-a17b"
# f32, card against CPU: a token may take the other expert only where its
# top-2 router probabilities are closer than this (f32 rounding of the
# router product moves them by ~1e-7)
MOE_FLIP_MARGIN = 1e-4


class MoeRecorder:
    """Records each MoE dispatch's routing (wraps ``layers.moe_route``)."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.real, self.routes, self.deterministic = \
            L, L.moe_route, [], []

        def route(*a):
            r = self.real(*a)
            self.routes.append(r)
            self.deterministic.append(
                torch.are_deterministic_algorithms_enabled())
            return r
        L.moe_route = route
        return self

    def __exit__(self, *exc):
        self.L.moe_route = self.real


def flip_aware_rows(cpu_routes, card_routes, margin):
    """bool [T] per dispatch pair: the tokens whose set of k experts and
    keep mask agree on both devices (a token's choices compared by
    expert: their order changes no slot). Raises where a token's set
    differs with a margin of ``margin`` or more between its k-th and
    (k+1)-th router probabilities (for k = 1 the top-2 margin)."""
    rows = []
    for a, b in zip(cpu_routes, card_routes):
        T_, k = a.gate.shape
        top = torch.topk(a.probs, k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]

        def by_expert(r):
            e = r.expert.cpu().reshape(T_, k)
            order = torch.argsort(e, dim=-1)
            return (torch.gather(e, 1, order),
                    torch.gather(r.keep.cpu().reshape(T_, k), 1, order))
        (ea, ka), (eb, kb) = by_expert(a), by_expert(b)
        flipped = (ea != eb).any(dim=-1)
        assert bool((gap[flipped] < margin).all()), gap[flipped]
        rows.append(~flipped & (ka == kb).all(dim=-1))
    return rows


def moe_pair(cfg, cuda):
    lm_cpu = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    lm_dev = convert.lm_params_from_jax(convert.lm_params_to_numpy(lm_cpu),
                                        cfg, cuda)
    return lm_cpu, lm_dev


def test_moe_forward_on_card_matches_cpu(cuda):
    """llama4's smoke config in f32, one pair, B = 2 × 64 (T = 128 at C =
    24: the forward drops tokens): every dispatch's expert and keep mask
    equal the CPU's up to flips under MOE_FLIP_MARGIN; the per-position logits of
    the tokens with the same routing agree within 1e-4 (one pair: a
    token's routing changes only its own output), as do the aux losses."""
    from repro_torch.models import layers as L
    cfg = registry.get_smoke(MOE_ARCH).replace(dtype=torch.float32,
                                               n_layers=2)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64)))
    outs = []
    for lm, dev in zip(moe_pair(cfg, cuda), ("cpu", cuda)):
        with MoeRecorder() as rec, torch.no_grad():
            x = L.embed_apply(lm["embed"], toks.to(dev))
            hidden, aux = T.backbone_forward(
                lm, cfg, x, torch.arange(64, device=dev)[None].expand(2, 64))
            logits = L.logits_apply(lm["embed"], hidden, cfg.tie_embeddings)
        outs.append((logits.cpu(), float(aux), rec.routes))
    (cpu, aux_cpu, r_cpu), (card, aux_card, r_card) = outs
    assert len(r_cpu) == len(r_card) == 1
    assert int((~r_cpu[0].keep).sum()) > 0
    (rows,) = flip_aware_rows(r_cpu, r_card, MOE_FLIP_MARGIN)
    assert rows.float().mean() > 0.9
    diff = (cpu - card).abs().amax(dim=-1).reshape(-1)
    assert float(diff[rows].max()) < 1e-4
    assert abs(aux_cpu - aux_card) <= 1e-5 * aux_cpu


def test_moe_train_step_on_card_is_deterministic(cuda):
    """llama4's smoke config in bf16, Adafactor, two microbatches, under
    the step's deterministic mode (an op without a deterministic CUDA
    implementation would raise): two runs from one state end with the
    same bytes, and the loss, grad_norm and aux are finite."""
    cfg = registry.get_smoke(MOE_ARCH)
    opt = O.OptConfig(kind="adafactor", lr=1e-3)
    step = TR.make_train_step(cfg, opt, microbatches=2, global_batch=4)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 64))).to(cuda)}
    runs = []
    for _ in range(2):
        state = TR.make_state(cfg, opt, torch.Generator(cuda).manual_seed(0),
                              cuda)
        with MoeRecorder() as rec:
            for _ in range(2):
                state, m = step(state, batch)
        # steps x microbatches x MoE layers x (forward, recompute)
        assert len(rec.routes) == 2 * 2 * 2 * 2 and all(rec.deterministic)
        assert not torch.are_deterministic_algorithms_enabled()
        assert all(np.isfinite(float(m[k])) for k in ("loss", "grad_norm",
                                                      "aux"))
        assert float(m["aux"]) > 0
        runs.append(_leaves(convert.train_state_to_numpy(state)))
    a, b = runs
    assert len(a) == len(b) and all(x.tobytes() == y.tobytes()
                                    for x, y in zip(a, b))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def test_moe_checkpointed_gradients_on_card(cuda):
    """On the card in f32, deterministic mode: the loss with every block
    under checkpoint (the backward recomputes each MoE block's routing)
    against the same loss composed from the blocks without checkpoint:
    the same routing in the recompute, the same gradients (1e-5 of each
    leaf's largest magnitude)."""
    from repro_torch.models import layers as L
    cfg = registry.get_smoke(MOE_ARCH).replace(dtype=torch.float32)
    _, lm = moe_pair(cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64))).to(cuda)
    params = list(lm.parameters())
    with TR.deterministic(cuda):
        with MoeRecorder() as rec:
            loss, _ = T.lm_loss(lm, cfg, {"tokens": toks})
            ckpt = torch.autograd.grad(loss, params)
        assert len(rec.routes) == 4
        for a, b in zip(rec.routes[:2], rec.routes[:1:-1]):
            assert torch.equal(a.expert, b.expert)
            assert torch.equal(a.keep, b.keep)
        x = L.embed_apply(lm["embed"], toks)
        pos = torch.arange(64, device=cuda)[None].expand(2, 64)
        aux = 0.0
        for lp in lm["segments"]["seg0"]:
            x, _, _ = T.block_apply(lp["dense"], cfg, x, pos, moe=False,
                                    window=-1)
            x, _, a = T.block_apply(lp["moe"], cfg, x, pos, moe=True,
                                    window=-1)
            aux = aux + a
        logits = L.logits_apply(lm["embed"],
                                L.rmsnorm(lm["ln_f"], x, cfg.norm_eps),
                                cfg.tie_embeddings)
        plain = T.ce_loss(logits[:, :-1], toks[:, 1:]) + 0.01 * aux
        direct = torch.autograd.grad(plain, params)
    assert abs(float(plain) - float(loss)) <= 1e-6 * abs(float(loss))
    for a, b in zip(ckpt, direct):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1e-2, float(b.abs().max()))


# -- deepseek-v3 (its smoke config: MLA, a dense prefix, top-k MoE) ------------

DS_ARCH = "deepseek-v3-671b"


def _ds_forward(lm, cfg, toks, dev):
    """The forward's logits at every position, aux and the routes."""
    from repro_torch.models import layers as L
    B, S = toks.shape
    with MoeRecorder() as rec, torch.no_grad():
        x = L.embed_apply(lm["embed"], toks.to(dev))
        hidden, aux = T.backbone_forward(
            lm, cfg, x, torch.arange(S, device=dev)[None].expand(B, S))
        logits = L.logits_apply(lm["embed"], hidden, cfg.tie_embeddings)
    return logits.cpu(), float(aux), rec.routes


def test_deepseek_mla_prefill_on_card_matches_cpu(cuda):
    """deepseek-v3's smoke config in f32 at its depth (1 dense and 3 MoE
    layers, q/k width 48, v width 32: the padded (64, 64) flash), B = 2 x
    64: the forward launches one f32 flash a layer; every dispatch's
    experts and keep mask equal the CPU's (at these inputs no token sits
    within MOE_FLIP_MARGIN of a flip, which the test asserts first, since
    at this depth a flip would reach other tokens through attention and
    capacity); the logits at every position agree within 1e-4, as do
    aux and the prefill's last-token logits."""
    cfg = registry.get_smoke(DS_ARCH).replace(dtype=torch.float32)
    lm_cpu, lm_dev = moe_pair(cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 64)))
    cpu, aux_cpu, r_cpu = _ds_forward(lm_cpu, cfg, toks, "cpu")
    before = kf.KERNEL.launches
    card, aux_card, r_card = _ds_forward(lm_dev, cfg, toks, cuda)
    assert kf.KERNEL.launches - before == cfg.n_layers
    assert len(r_cpu) == len(r_card) == 3
    rows = flip_aware_rows(r_cpu, r_card, MOE_FLIP_MARGIN)
    assert all(bool(r.all()) for r in rows)
    assert float((cpu - card).abs().max()) < 1e-4
    assert abs(aux_cpu - aux_card) <= 1e-5 * aux_cpu
    last, _ = D.prefill(lm_dev, cfg, {"tokens": toks.to(cuda)})
    assert float((last.cpu() - cpu[:, -1]).abs().max()) < 1e-4


def test_deepseek_top8_routing_on_card_matches_cpu(cuda):
    """k = 8 of 16 experts (deepseek-v3 routes 8 of 256), f32, one dense
    and one MoE layer, B = 2 x 64 (T = 128 at C = 80): every token's set
    of experts and keep mask equal the CPU's up to flips under
    MOE_FLIP_MARGIN (its k-th against its (k+1)-th probability); the
    logits of the tokens with the same routing agree within 1e-4 (the MoE
    layer is the last, so a token's routing changes only its own
    output), as do the aux losses."""
    cfg = registry.get_smoke(DS_ARCH).replace(
        dtype=torch.float32, n_layers=2, n_experts=16, experts_per_token=8)
    lm_cpu, lm_dev = moe_pair(cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 64)))
    cpu, aux_cpu, r_cpu = _ds_forward(lm_cpu, cfg, toks, "cpu")
    card, aux_card, r_card = _ds_forward(lm_dev, cfg, toks, cuda)
    assert len(r_cpu) == len(r_card) == 1
    assert r_card[0].expert.shape == (128 * 8,)
    assert r_card[0].capacity == 80
    (rows,) = flip_aware_rows(r_cpu, r_card, MOE_FLIP_MARGIN)
    assert rows.float().mean() > 0.9
    diff = (cpu - card).abs().amax(dim=-1).reshape(-1)
    assert float(diff[rows].max()) < 1e-4
    assert abs(aux_cpu - aux_card) <= 1e-5 * aux_cpu


def test_deepseek_captured_absorbed_decode_matches_eager(cuda):
    """The smoke config in f32 on the card: ``launch.serve.generate``
    (each step one captured CUDA graph of the absorbed MLA decode, both
    segments' compressed caches written through a 0-d index tensor)
    against eager ``decode_step`` calls with int indices, B = 2, 12
    prompt and 4 new tokens: the same logits within 1e-6 and the same
    tokens; no model kernel is launched; the first prompt step's logits
    equal the forward's first position within 1e-4."""
    cfg = registry.get_smoke(DS_ARCH).replace(dtype=torch.float32)
    _, lm = moe_pair(cfg, cuda)
    P, N = 12, 4
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, P))).to(cuda)
    from repro_torch.launch import serve
    before = {k.source: k.launches for k in (kf.KERNEL, kf.KERNEL_BF16)}
    gen, logits = serve.generate(lm, cfg, prompts, N, return_logits=True)
    assert {k.source: k.launches for k in (kf.KERNEL, kf.KERNEL_BF16)} \
        == before
    seq = torch.cat([prompts, gen], dim=1)
    cache = D.cache_zeros(D.cache_spec(cfg, 2, P + N), cuda)
    eager = []
    for t in range(P + N - 1):
        lg, cache = D.decode_step(lm, cfg, {"token": seq[:, t:t + 1],
                                            "index": t}, cache)
        eager.append(lg.clone())
    eager = torch.stack(eager, dim=1)
    assert float((logits - eager).abs().max()) <= 1e-6
    assert torch.equal(eager[:, P - 1:].argmax(-1), gen)
    full, _, _ = _ds_forward(lm, cfg, prompts[:, :1].cpu(), cuda)
    assert float((full[:, 0] - logits[:, 0].cpu()).abs().max()) < 1e-4
