"""The port's model kernels (flash attention, WKV6) against the Pallas
kernels and the reference oracles.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
it against ``repro.kernels.*`` in interpret mode and against
``repro.kernels.ref`` on the same numpy inputs, at the shapes of
tests/test_kernels.py, plus the cases the Pallas kernels do not take
(ragged lengths, no causal mask) and the decay range where the Pallas
WKV6 kernel overflows. Tolerances are those of tests/test_kernels.py:
f32 2e-5 (flash), 1e-5 × (max |out| + 1) (WKV6); bf16 2e-2 and
3e-3 × (max |out| + 1). The CUDA kernels are checked in
tests/test_torch_gpu.py; here, the wrapper's choice between them (and its
shape rule for the bf16 kernel), a plain emulation of the bf16 kernel's
arithmetic (P rounded to bf16 before P·V) against the Pallas kernel
within the bf16 tolerance, and a plain emulation of the WKV6 kernel's
three passes (chunk states, the scan over chunks, the outputs with the
kernel's factorised intra-chunk weights) against the sequential oracle
and the plain chunked version within the f32 tolerance.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as pl_flash)
from repro.kernels.rwkv6_scan import wkv6_chunked as pl_wkv6  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as ws  # noqa: E402

FLASH_SHAPES = [(128, 4, 4, 32, 32, -1), (256, 8, 4, 64, 64, -1),
                (256, 8, 4, 64, 64, 100), (128, 4, 2, 48, 32, -1)]
WKV_SHAPES = [(64, 2, 32, 16), (128, 4, 64, 32), (64, 1, 128, 64)]


def _qkv(seed, B, Sq, Skv, H, K, h, hv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, h)).astype(np.float32),
            rng.standard_normal((B, Skv, K, h)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hv)).astype(np.float32))


def _wkv_inputs(seed, B, S, H, hd, w_std=1.0):
    """r/k/v standard normal; wlog = -softplus(N(0, w_std)) - 1e-4 as the
    model's ``_decay_log``; u = N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    wlog = (-np.logaddexp(0.0, w_std * rng.standard_normal((B, S, H, hd)))
            - 1e-4).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    return r, k, v, wlog, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


# -- flash attention ----------------------------------------------------------

@pytest.mark.parametrize("S,H,K,h,hv,window", FLASH_SHAPES)
def test_flash_plain_matches_pallas_and_ref(S, H, K, h, hv, window):
    q, k, v = _qkv(S + H + h, 2, S, S, H, K, h, hv)
    before = fa.KERNEL.launches
    got = fa.flash_attention(*_t(q, k, v), window=window).numpy()
    assert fa.KERNEL.launches == before          # CPU: the plain version
    pallas = pl_flash(*_j(q, k, v), window=window, block_q=64, block_k=64,
                      interpret=True)
    oracle = jref.flash_attention_ref(*_j(q, k, v), window=window)
    assert _err(got, pallas) < 2e-5
    assert _err(got, oracle) < 2e-5


def test_flash_plain_bf16_matches_pallas():
    q, k, v = _qkv(7, 2, 128, 128, 8, 4, 64, 64)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = fa.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    pallas = pl_flash(*(x.astype(jnp.bfloat16) for x in _j(q, k, v)),
                      block_q=64, block_k=64, interpret=True)
    assert _err(got.float().numpy(), pallas.astype(jnp.float32)) < 2e-2


def test_flash_noncausal_and_window_follow_pallas():
    """Without the causal mask: the JAX oracle takes every key; with a
    window, the Pallas kernel still applies it and so does the port."""
    q, k, v = _qkv(11, 2, 128, 128, 4, 2, 32, 32)
    got = fa.flash_attention(*_t(q, k, v), causal=False).numpy()
    assert _err(got, jref.flash_attention_ref(*_j(q, k, v), causal=False)) \
        < 2e-5
    assert _err(got, pl_flash(*_j(q, k, v), causal=False, block_q=64,
                              block_k=64, interpret=True)) < 2e-5
    got_w = fa.flash_attention(*_t(q, k, v), causal=False, window=40).numpy()
    assert _err(got_w, pl_flash(*_j(q, k, v), causal=False, window=40,
                                block_q=64, block_k=64,
                                interpret=True)) < 2e-5


@pytest.mark.parametrize("Sq,Skv,window", [(100, 130, -1), (77, 77, 30),
                                           (130, 130, -1)])
def test_flash_plain_ragged_lengths(Sq, Skv, window):
    """Lengths no block divides (the Pallas kernel asserts divisibility):
    against the JAX oracle."""
    q, k, v = _qkv(Sq + Skv, 2, Sq, Skv, 4, 2, 64, 48)
    got = fa.flash_attention(*_t(q, k, v), window=window).numpy()
    assert _err(got, jref.flash_attention_ref(*_j(q, k, v), window=window)) \
        < 2e-5


def test_flash_wrapper_rejects_bad_inputs():
    q, k, v = _t(*_qkv(0, 1, 8, 8, 4, 2, 16, 16))
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, :3], k, v)           # 3 heads over 2 kv
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :8], v)            # h of k != h of q
    with pytest.raises(ValueError):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("h,hv,width", [(16, 16, 32), (32, 32, 32),
                                         (48, 32, 64), (64, 64, 64),
                                         (64, 48, 64), (32, 128, 128),
                                         (128, 128, 128)])
def test_bf16_kernel_takes_multiples_of_16(h, hv, width):
    assert fa.bf16_head_width(h, hv) == width
    assert fa.select_kernel(torch.bfloat16, h, hv) is fa.KERNEL_BF16
    assert fa.select_kernel(torch.float32, h, hv) is fa.KERNEL


@pytest.mark.parametrize("h,hv", [(40, 40), (160, 160), (8, 8), (64, 40),
                                  (128, 144), (72, 64)])
def test_bf16_kernel_rejects_other_head_widths(h, hv):
    """A bf16 head width the tensor-core kernel does not take raises; it
    is never routed to the f32 kernel."""
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.bf16_head_width(h, hv)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.select_kernel(torch.bfloat16, h, hv)


def test_select_kernel_rejects_other_dtypes():
    with pytest.raises(ValueError):
        fa.select_kernel(torch.float32, 160, 64)
    with pytest.raises(TypeError):
        fa.select_kernel(torch.float16, 64, 64)


def _bf16_kernel_arithmetic(q, k, v, *, causal=True, window=-1, tile=64):
    """The bf16 CUDA kernel's arithmetic in plain PyTorch (a test helper,
    on no path): kv tiles of ``tile`` keys with an online softmax in f32
    in the log2 domain, the unnormalised P rounded to bf16 before P·V,
    l summed from the unrounded P, out = acc / max(l, 1e-30) in bf16."""
    B, Sq, H, h = q.shape
    Skv, K, hv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, h)
    scale = math.log2(math.e) / math.sqrt(h)
    mask = ref.attention_mask(Sq, Skv, causal=causal, window=window,
                              device=q.device)
    m = torch.full((B, K, G, Sq), ref.MASKED)
    l = torch.zeros((B, K, G, Sq))
    acc = torch.zeros((B, K, G, Sq, hv))
    for k0 in range(0, Skv, tile):
        s = torch.einsum("bqkgh,bskh->bkgqs", qf,
                         k[:, k0:k0 + tile].float()) * scale
        s = torch.where(mask[:, k0:k0 + tile], s,
                        torch.full_like(s, ref.MASKED))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(torch.bfloat16).float(),
            v[:, k0:k0 + tile].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hv) \
        .to(torch.bfloat16)


@pytest.mark.parametrize("S,H,K,h,hv,window", [
    (128, 4, 4, 32, 32, -1), (256, 8, 4, 64, 64, 100),
    (128, 4, 2, 48, 32, -1), (128, 8, 1, 128, 128, -1)])
def test_bf16_kernel_arithmetic_matches_pallas(S, H, K, h, hv, window):
    """Rounding the unnormalised P to bf16 before P·V, as the tensor-core
    kernel does, stays within the bf16 tolerance of the Pallas kernel
    (which multiplies bf16 inputs in f32)."""
    q, k, v = _qkv(S + H + h + 1, 2, S, S, H, K, h, hv)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = _bf16_kernel_arithmetic(tq, tk, tv, window=window)
    pallas = pl_flash(*(x.astype(jnp.bfloat16) for x in _j(q, k, v)),
                      window=window, block_q=64, block_k=64, interpret=True)
    assert _err(got.float().numpy(), pallas.astype(jnp.float32)) < 2e-2
    plain = fa.flash_attention(tq, tk, tv, window=window)
    assert _err(got.float().numpy(), plain.float().numpy()) < 2e-2


# -- WKV6 ---------------------------------------------------------------------

@pytest.mark.parametrize("S,H,hd,chunk", WKV_SHAPES)
def test_wkv6_plain_matches_pallas_and_sequential(S, H, hd, chunk):
    r, k, v, wlog, u = _wkv_inputs(S + hd, 2, S, H, hd)
    before = ws.KERNEL.launches
    got = ws.wkv6_chunked(*_t(r, k, v, wlog, u), chunk=chunk).numpy()
    assert ws.KERNEL.launches == before
    want = np.asarray(jref.wkv6_ref(*_j(r, k, v, wlog, u)))
    pallas = np.asarray(pl_wkv6(*_j(r, k, v, wlog, u), chunk=chunk,
                                interpret=True))
    tol = 1e-5 * (np.abs(want).max() + 1.0)
    assert _err(got, want) < tol
    assert _err(got, pallas) < tol
    oracle = ref.wkv6_ref(*_t(r, k, v, wlog, u)).numpy()
    assert _err(oracle, want) < tol


def test_wkv6_finite_where_pallas_overflows():
    """S = 256, chunk 128, the model's decay range (w_raw ~ N(0, 0.3):
    about -0.7 per step, a chunk sums past -88.7): the Pallas kernel's
    exp(-cum) overflows to NaN; the port's pairwise form stays finite and
    equals the sequential recurrence."""
    r, k, v, wlog, u = _wkv_inputs(3, 2, 256, 4, 64, w_std=0.3)
    assert np.cumsum(wlog[:, :128], axis=1).min() < -88.8
    pallas = np.asarray(pl_wkv6(*_j(r, k, v, wlog, u), chunk=128,
                                interpret=True))
    assert np.isnan(pallas).any()
    got = ws.wkv6_chunked(*_t(r, k, v, wlog, u), chunk=128).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jref.wkv6_ref(*_j(r, k, v, wlog, u)))
    assert _err(got, want) < 1e-5 * (np.abs(want).max() + 1.0)


@pytest.mark.parametrize("S,chunk", [(100, 32), (37, 128)])
def test_wkv6_plain_ragged_length(S, chunk):
    r, k, v, wlog, u = _wkv_inputs(S, 2, S, 2, 32)
    got = ws.wkv6_chunked(*_t(r, k, v, wlog, u), chunk=chunk).numpy()
    want = np.asarray(jref.wkv6_ref(*_j(r, k, v, wlog, u)))
    assert _err(got, want) < 1e-5 * (np.abs(want).max() + 1.0)


def test_wkv6_plain_bf16_matches_pallas():
    r, k, v, wlog, u = _wkv_inputs(5, 2, 64, 2, 32)
    tr, tk, tv = (x.to(torch.bfloat16) for x in _t(r, k, v))
    got = ws.wkv6_chunked(tr, tk, tv, *_t(wlog, u), chunk=16).numpy()
    jr, jk, jv = (x.astype(jnp.bfloat16) for x in _j(r, k, v))
    pallas = np.asarray(pl_wkv6(jr, jk, jv, *_j(wlog, u), chunk=16,
                                interpret=True))
    assert _err(got, pallas) < 3e-3 * (np.abs(pallas).max() + 1.0)


LOG2E = 1.4426950408889634


def _wkv6_split_arithmetic(r, k, v, wlog, u, *, chunk=ws.CHUNK):
    """The CUDA kernel's three passes in plain PyTorch (a test helper, on
    no path), in f32 on log2(e)-scaled cumulative decays:

    1. chunk states: dS_c = (k ⊙ 2^(total - cum))^T v and the decay
       2^total of every chunk but the last;
    2. the scan S_{c+1} = 2^total_c ⊙ S_c + dS_c from S_0 = 0;
    3. outputs: the intra-chunk weights a, then a·v + (r ⊙ 2^cum_ex)·S_c.
       a is factorised as the kernel does: on two levels (blocks of the
       chunk and of its halves), t in a block's right half and s in its
       left half give a plain product of rows decayed through the left
       half's last token m; inside leaves of a quarter chunk the pairs
       s < t take one exp each, and the bonus u sits on the diagonal.

    Asserts that no exponent it takes is positive."""
    B, S, H, hd = r.shape
    n, leaf = -(-S // chunk), chunk // 4

    def chunks(x):              # [B,S,H,hd] -> [B,H,n,chunk,hd], zero-padded
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, n * chunk - S))
        return x.reshape(B, n, chunk, H, hd).permute(0, 3, 1, 2, 4)

    def exp2(e):
        assert bool((e <= 0).all()), "a positive exponent"
        return torch.exp2(e)
    rf, kf, vf = chunks(r), chunks(k), chunks(v)
    cum = torch.cumsum(chunks(wlog) * LOG2E, dim=3)
    cum_ex = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]],
                       dim=3)
    total = cum[..., -1, :]                                 # [B,H,n,hd]
    # 1. chunk states, all chunks but the last
    d_state = (kf * exp2(total[..., None, :] - cum)).transpose(-1, -2) @ vf
    decay = exp2(total)
    # 2. the scan: states[:, :, c] is the state entering chunk c
    state = torch.zeros((B, H, hd, hd))
    states = [state]
    for c in range(n - 1):
        state = decay[:, :, c, :, None] * state + d_state[:, :, c]
        states.append(state)
    states = torch.stack(states, dim=2)
    # 3. outputs
    a = torch.zeros((B, H, n, chunk, chunk))
    for half in (chunk // 2, chunk // 4):
        for base in range(0, chunk, 2 * half):
            left = slice(base, base + half)
            right = slice(base + half, base + 2 * half)
            m = cum[..., base + half - 1:base + half, :]
            a[..., right, left] = (
                (rf[..., right, :] * exp2(cum_ex[..., right, :] - m))
                @ (kf[..., left, :] * exp2(m - cum[..., left, :]))
                .transpose(-1, -2))
    below = torch.tril(torch.ones((leaf, leaf), dtype=torch.bool),
                       diagonal=-1)
    for lo in range(0, chunk, leaf):
        blk = slice(lo, lo + leaf)
        expo = cum_ex[..., blk, None, :] - cum[..., None, blk, :]
        dec = exp2(torch.where(below[..., None], expo,
                               torch.full_like(expo, -math.inf)))
        a[..., blk, blk] = (
            torch.einsum("bhntd,bhnsd,bhntsd->bhnts", rf[..., blk, :],
                         kf[..., blk, :], dec)
            + torch.diag_embed((rf[..., blk, :] * u.float()[None, :, None,
                                                            None, :]
                                * kf[..., blk, :]).sum(-1)))
    out = a @ vf + (rf * exp2(cum_ex)) @ states
    return out.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H, hd)[:, :S]


def _bf16_values(*arrays):
    """The f32 values of the arrays rounded to bf16."""
    return [x.to(torch.bfloat16).float().numpy() for x in _t(*arrays)]


C = ws.CHUNK


@pytest.mark.parametrize("S,hd,w_std", [
    *[(S, hd, 1.0) for S in (1, C - 1, C, C + 1, 4 * C + 7)
      for hd in (32, 64, 128)],
    (256, 64, 0.3),      # the reference's overflow range
    (300, 32, 3.0)])     # steep decay: the sequence's decay underflows
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_split_arithmetic_matches_oracles(S, hd, w_std, dtype):
    """The kernel's three-pass split, in plain PyTorch, against JAX's
    sequential oracle and the port's plain chunked version on the same
    values (bf16: r/k/v rounded to bf16 for all three), within
    1e-5 × (max |want| + 1)."""
    r, k, v, wlog, u = _wkv_inputs(S + hd, 2, S, 2, hd, w_std=w_std)
    if dtype == "bfloat16":
        r, k, v = _bf16_values(r, k, v)
    tr, tk, tv = (x.to(getattr(torch, dtype)) for x in _t(r, k, v))
    got = _wkv6_split_arithmetic(tr, tk, tv, *_t(wlog, u)).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jref.wkv6_ref(*_j(r, k, v, wlog, u)))
    tol = 1e-5 * (np.abs(want).max() + 1.0)
    assert _err(got, want) < tol
    plain = ws.wkv6_chunked_plain(tr, tk, tv, *_t(wlog, u)).numpy()
    assert _err(got, plain) < 1e-5 * (np.abs(plain).max() + 1.0)
    if w_std == 0.3:    # the Pallas kernel's exp(-cum) overflows here
        assert np.isnan(np.asarray(pl_wkv6(*_j(r, k, v, wlog, u), chunk=128,
                                           interpret=True))).any()
    if w_std == 3.0:    # e^(sum of wlog) underflows to 0 within the run
        assert (np.exp(np.cumsum(wlog, axis=1)) == 0).any()


def test_wkv6_workspace_size():
    """One [hd, hd] state and its [hd] decay per (batch, head) and chunk
    but the last: none for S <= CHUNK; 82.5 MB at the rwkv6-3b prefill."""
    assert ws.workspace_floats(2, 1, 2, 32) == 0
    assert ws.workspace_floats(2, C, 2, 32) == 0
    assert ws.workspace_floats(2, C + 1, 2, 32) == 2 * 2 * 32 * 33
    assert 4 * ws.workspace_floats(4, 1024, 40, 64) \
        == 4 * 40 * 31 * 64 * 65 * 4 == 82_534_400


def test_wkv6_wrapper_rejects_bad_inputs():
    r, k, v, wlog, u = _t(*_wkv_inputs(0, 1, 8, 2, 16))
    with pytest.raises(TypeError):
        ws.wkv6_chunked(r, k, v, wlog.double(), u)
    with pytest.raises(ValueError):
        ws.wkv6_chunked(r, k, v, wlog, u[:1])
    with pytest.raises(ValueError):
        ws.wkv6_chunked(r, k[:, :4], v, wlog, u)


def test_ops_dispatch_to_plain_versions_on_cpu():
    q, k, v = _t(*_qkv(1, 2, 64, 64, 4, 2, 16, 16))
    assert torch.equal(ops.attention(q, k, v, window=20),
                       fa.flash_attention_plain(q, k, v, window=20))
    r, kk, vv, wlog, u = _t(*_wkv_inputs(2, 2, 64, 2, 16))
    assert torch.equal(ops.wkv6(r, kk, vv, wlog, u, chunk=32),
                       ws.wkv6_chunked_plain(r, kk, vv, wlog, u, chunk=32))
