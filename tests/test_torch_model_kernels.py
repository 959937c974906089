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
tests/test_torch_gpu.py.
"""
from __future__ import annotations

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
