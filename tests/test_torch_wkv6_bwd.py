"""The WKV6 gradient of the port on the CPU: ``wkv6_chunked_bwd_plain``
(the plain version of the WKV6 backward kernel, which ``WKV6`` runs on a
CPU tensor) against three oracles on the same numpy inputs: autograd
through the port's sequential ``ref.wkv6_ref`` and through its chunked
``ref.wkv6_chunked_ref``, and ``jax.vjp`` of the JAX package's
``repro.kernels.ref.wkv6_ref``; then a plain emulation of the CUDA
kernel's arithmetic (C = 32, cumsums by groups of 8 tokens, the reverse
scan over chunks, the intra-chunk decay factored on two levels with an exp
per pair only inside 8-token leaves, the chunk-end term of dwlog from the
entering state, split-TF32 state products, du summed over (batch, chunk)
partials in order) against the same oracle, and two of its steps against
their direct forms: the factored intra-chunk sums against per-pair sums,
and y from the entering state against the sum over the leaving state.

The JAX oracle is one ``jax.vjp`` call for every case: each case is two
heads of it, zero-padded to 70 tokens and head width 64, with the
output's gradient zero past the case's length, so the case's rows of the
gradient are those of the case alone (the recurrence is causal, and zero
columns add nothing). It runs op by op, and its backward compiles one
``pad`` per token (the transpose of the reference's slice of token t):
XLA's optimisations are off for that call, which halves its time.

Tolerances, relative to (max |oracle| + 1): f32 1e-5 (f32 rounding of
sums of up to 70 terms in another order); r/k/v in bf16 (the oracles run
on the bf16-rounded values in f32) 4e-3 on dr, dk and dv, which the port
rounds to bf16 (half a bf16 ulp is 2^-9 of a value), and 1e-5 on dwlog
and du (f32 outputs).
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as ws  # noqa: E402

NAMES = ("dr", "dk", "dv", "dwlog", "du")
F32_TOL = 1e-5
BF16_TOL = 4e-3
S_PAD, HD_PAD = 70, 64
# (S, hd, dtype, std of the raw decay): the lengths around a chunk of 32
# and past two, both widths, both dtypes; a steep decay (e^cum underflows)
CASES = [*[(S, hd, dt, 1.0) for S in (1, 31, 33, 70) for hd in (32, 64)
           for dt in ("float32", "bfloat16")],
         (70, 64, "float32", 3.0), (70, 32, "bfloat16", 3.0)]


def _inputs(case):
    """r, k, v, wlog, u, dout as f32 numpy for B = 2, H = 2; r/k/v rounded
    to bf16 values for a bf16 case. wlog = -softplus(N(0, w_std)) - 1e-4,
    as the model's ``_decay_log``."""
    S, hd, dt, w_std = case
    seed = (1000 + CASES.index(case) if case in CASES
            else 2000 + 97 * case[0] + case[1])
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((2, S, 2, hd)).astype(np.float32)
                   for _ in range(4))
    wlog = (-np.logaddexp(0.0, w_std * rng.standard_normal((2, S, 2, hd)))
            - 1e-4).astype(np.float32)
    u = (0.1 * rng.standard_normal((2, hd))).astype(np.float32)
    if dt == "bfloat16":
        r, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                   for x in (r, k, v))
    return r, k, v, wlog, u, do


def _torch(case, arrays):
    """The inputs as the port takes them: r/k/v in the case's dtype."""
    dt = getattr(torch, case[2])
    r, k, v, wlog, u, do = (torch.from_numpy(a) for a in arrays)
    return r.to(dt), k.to(dt), v.to(dt), wlog, u, do


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp of the reference's sequential wkv6_ref over every case at
    once: {case: (dr, dk, dv, dwlog, du)} as numpy."""
    parts = []
    for case in CASES:
        S, hd = case[:2]
        r, k, v, wlog, u, do = _inputs(case)
        pad = ((0, 0), (0, S_PAD - S), (0, 0), (0, HD_PAD - hd))
        parts.append([np.pad(x, pad) for x in (r, k, v, wlog, do)]
                     + [np.pad(u, ((0, 0), (0, HD_PAD - hd)))])
    r, k, v, wlog, do = (np.concatenate([p[i] for p in parts], axis=2)
                         for i in range(5))
    u = np.concatenate([p[5] for p in parts], axis=0)
    was = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        _, vjp = jax.vjp(jref.wkv6_ref, *(jnp.asarray(x)
                                          for x in (r, k, v, wlog, u)))
        grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    finally:
        jax.config.update("jax_disable_most_optimizations", was)
    out = {}
    for i, case in enumerate(CASES):
        S, hd = case[:2]
        heads = slice(2 * i, 2 * i + 2)
        out[case] = (*(g[:, :S, heads, :hd] for g in grads[:4]),
                     grads[4][heads, :hd])
    return out


def _autograd(fn, arrays, **kw):
    """(dr, dk, dv, dwlog, du) of ``fn`` by torch autograd, in f32."""
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    grads = torch.autograd.grad(fn(*xs, **kw), xs,
                                torch.from_numpy(arrays[5]),
                                allow_unused=True)
    return [np.zeros(x.shape, np.float32) if g is None else g.numpy()
            for g, x in zip(grads, xs)]


def _check(case, got, want):
    """Each gradient within its tolerance of the oracle's."""
    for name, a, b in zip(NAMES, got, want):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        tol = BF16_TOL if case[2] == "bfloat16" and name in NAMES[:3] \
            else F32_TOL
        scale = float(np.abs(b).max()) + 1.0
        assert np.isfinite(a).all(), name
        assert float(np.abs(a - b).max()) <= tol * scale, \
            (name, float(np.abs(a - b).max()), tol * scale)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_wkv6_bwd_plain_matches_oracles(case, jax_grads):
    """The plain backward (at chunk 32, and at 16 to cut S = 70 into five
    ragged-ended chunks) against autograd through the sequential and the
    chunked plain forward and against jax.vjp of the reference's oracle;
    its dtypes are r's for dr/dk/dv, f32 for dwlog and du."""
    arrays = _inputs(case)
    r, k, v, wlog, u, do = _torch(case, arrays)
    seq = _autograd(ref.wkv6_ref, arrays)
    chunked = _autograd(ref.wkv6_chunked_ref, arrays, chunk=32)
    for chunk in (32, 16):
        got = ref.wkv6_chunked_bwd_plain(r, k, v, wlog, u, do, chunk=chunk)
        assert [g.dtype for g in got] == [r.dtype] * 3 + [torch.float32] * 2
        for want in (jax_grads[case], seq, chunked):
            _check(case, got, want)


def test_wkv6_autograd_on_cpu_runs_the_plain_backward():
    """On a CPU tensor ``wkv6_chunked`` is the WKV6 autograd function: its
    gradients are the bytes of ``wkv6_chunked_bwd_plain`` at the call's
    chunk, and no kernel is launched."""
    arrays = _inputs(CASES[5])
    r, k, v, wlog, u, do = _torch(CASES[5], arrays)
    xs = [x.clone().requires_grad_() for x in (r, k, v, wlog, u)]
    before = (ws.KERNEL.launches, ws.KERNEL_BWD.launches)
    out = ws.wkv6_chunked(*xs, chunk=16)
    assert out.grad_fn is not None and "WKV6" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, xs, do)
    want = ref.wkv6_chunked_bwd_plain(r, k, v, wlog, u, do, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert (ws.KERNEL.launches, ws.KERNEL_BWD.launches) == before


def test_wkv6_bwd_wrapper_checks_inputs():
    """``wkv6_bwd`` launches on a CUDA device only, and checks dout and the
    forward's workspace; the workspace sizes follow the kernel's layout."""
    r, k, v, wlog, u, do = _torch(CASES[0], _inputs(CASES[0]))
    states = torch.empty((0,))
    with pytest.raises(ValueError, match="CUDA"):
        ws.wkv6_bwd(r, k, v, wlog, u, do, states)
    with pytest.raises(TypeError):
        ws.wkv6_bwd(r, k, v, wlog.double(), u, do, states)
    assert ws.bwd_workspace_floats(2, 1, 2, 32) == 2 * 1 * 2 * 32
    assert ws.bwd_workspace_floats(2, 33, 2, 50) \
        == ws.workspace_floats(2, 33, 2, 50) + 2 * 2 * 2 * 64
    assert 4 * ws.bwd_workspace_floats(1, 4096, 40, 64) \
        == 4 * 40 * (127 * 64 * 65 + 128 * 64)


# -- the kernel's passes, emulated --------------------------------------------

LOG2E = 1.4426950408889634
TOK, GROUPS = 8, 4        # the kernel's groups (leaves) of 8 tokens


def _exp2(e):
    """2^e, asserting that no exponent is positive (the kernel's rule)."""
    assert bool((e <= 0).all()), "a positive exponent"
    return torch.exp2(e)


def _group_cumsums(wl):
    """The kernel's cumsums of log2 decays ``wl`` [..., 32, hd]: each group
    of 8 tokens summed token by token, offset by the chained sum of the
    groups before it. Returns cum [..., 32, hd] and the bounds [..., 5,
    hd] (bound[q] = groups 0..q-1, bound[4] = total), each bound a value
    of cum: the cum of a group's last token is the next bound exactly."""
    *lead, C, hd = wl.shape
    cs = torch.cumsum(wl.reshape(*lead, GROUPS, TOK, hd), dim=-2)
    bounds = [torch.zeros_like(cs[..., 0, -1, :])]
    for q in range(GROUPS):
        bounds.append(bounds[-1] + cs[..., q, -1, :])
    bound = torch.stack(bounds, dim=-2)
    return (bound[..., :GROUPS, None, :] + cs).reshape(*lead, C, hd), bound


def _cum_ex(cum):
    """cum of the token before (0 before the chunk's first)."""
    return torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]],
                     dim=-2)


def _intra_factored(rf, kf, a, cum, bound):
    """att[t, s] (s < t), and dr's and dk's intra-chunk sums, as the
    kernel factors the decay 2^(cum_ex[t] - cum[s]) on two levels: for t
    on the right and s on the left of the chunk's halves (pivot m =
    token 15) or of a half's quarters (pivot: the left quarter's last
    token), 2^(cum_ex[t] - m) 2^(m - cum[s]), so the three sums are
    products of decayed rows; only pairs inside an 8-token leaf take an
    exp per (t, s, d), one shared by the three sums (2^0 = 1 for adjacent
    tokens). rf, kf [..., 32, hd], a = A [..., 32, 32]."""
    cum_ex = _cum_ex(cum)
    att = torch.zeros_like(a)
    dri, dki = torch.zeros_like(rf), torch.zeros_like(kf)
    for t, s, q in ((slice(16, 32), slice(0, 16), 2),     # level 1
                    (slice(8, 16), slice(0, 8), 1),       # level 2
                    (slice(24, 32), slice(16, 24), 3)):
        m = bound[..., q:q + 1, :]
        er, ek = _exp2(cum_ex[..., t, :] - m), _exp2(m - cum[..., s, :])
        x, y = rf[..., t, :] * er, kf[..., s, :] * ek
        att[..., t, s] = x @ y.transpose(-1, -2)
        dri[..., t, :] += er * (a[..., t, s] @ y)
        dki[..., s, :] += ek * (a[..., t, s].transpose(-1, -2) @ x)
    lead, hd = rf.shape[:-2], rf.shape[-1]

    def leaves(z):
        return z.reshape(*lead, GROUPS, TOK, hd)
    below = torch.tril(torch.ones((TOK, TOK), dtype=torch.bool), diagonal=-1)
    expo = leaves(cum_ex)[..., :, None, :] - leaves(cum)[..., None, :, :]
    e = _exp2(torch.where(below[..., None], expo,
                          torch.full_like(expo, -math.inf)))
    al = torch.stack([a[..., g * TOK:(g + 1) * TOK, g * TOK:(g + 1) * TOK]
                      for g in range(GROUPS)], dim=-3)
    rl, kl = leaves(rf), leaves(kf)
    leaf = torch.einsum("...gtd,...gsd,...gtsd->...gts", rl, kl, e)
    for g in range(GROUPS):
        att[..., g * TOK:(g + 1) * TOK, g * TOK:(g + 1) * TOK] = leaf[..., g,
                                                                      :, :]
    dri += torch.einsum("...gtsd,...gsd,...gts->...gtd", e, kl,
                        al).reshape(rf.shape)
    dki += torch.einsum("...gtsd,...gtd,...gts->...gsd", e, rl,
                        al).reshape(kf.shape)
    return att, dri, dki


def _intra_pairs(rf, kf, a, cum):
    """The same three sums with one exp per (t, s, d) pair s < t."""
    cum_ex = _cum_ex(cum)
    C = rf.shape[-2]
    below = torch.tril(torch.ones((C, C), dtype=torch.bool), diagonal=-1)
    expo = cum_ex[..., :, None, :] - cum[..., None, :, :]
    dec = _exp2(torch.where(below[..., None], expo,
                            torch.full_like(expo, -math.inf)))
    return (torch.einsum("...td,...sd,...tsd->...ts", rf, kf, dec),
            torch.einsum("...tsd,...sd,...ts->...td", dec, kf, a),
            torch.einsum("...tsd,...td,...ts->...sd", dec, rf, a))


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as the card's cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(a, b):
    """a @ b as the kernel's state products take it on the tensor cores:
    each operand as hi + lo TF32 parts, lo·hi + hi·lo + hi·hi summed in
    f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _kernel_chunks(r, k, v, wlog, dout, chunk=ws.CHUNK):
    """The inputs in the kernel's chunks ([B, H, n, chunk, hd], f32,
    zero-padded), its grouped log2 cumsums, the states entering each chunk
    (the forward's scan, emulated: states[:, :, c] enters chunk c, c = n
    leaves the last) and, by passes 1 and 2, G_c (grads[:, :, c], the
    gradient of the state leaving chunk c; 0 for the last)."""
    B, S, H, hd = r.shape
    n = -(-S // chunk)

    def chunks(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, n * chunk - S))
        return x.reshape(B, n, chunk, H, hd).permute(0, 3, 1, 2, 4)
    rf, kf, vf, gf = chunks(r), chunks(k), chunks(v), chunks(dout)
    cum, bound = _group_cumsums(chunks(wlog) * LOG2E)
    total = bound[..., -1, :]                               # [B,H,n,hd]
    k_out = kf * _exp2(total[..., None, :] - cum)
    states = [torch.zeros((B, H, hd, hd))]
    for c in range(n):
        states.append(_exp2(total[:, :, c, :, None]) * states[-1]
                      + k_out[:, :, c].transpose(-1, -2) @ vf[:, :, c])
    # 1. each chunk's term (r 2^cum_ex)^T do of the gradient of the state
    # entering it, 2. the reverse scan
    term = (rf * _exp2(_cum_ex(cum))).transpose(-1, -2) @ gf
    g = torch.zeros((B, H, hd, hd))
    grads = [g]
    for c in range(n - 1, 0, -1):
        g = _exp2(total[:, :, c, :, None]) * g + term[:, :, c]
        grads.append(g)
    return dict(rf=rf, kf=kf, vf=vf, gf=gf, cum=cum, bound=bound,
                total=total, k_out=k_out, states=torch.stack(states, dim=2),
                grads=torch.stack(grads[::-1], dim=2))


def _wkv6_bwd_passes(r, k, v, wlog, u, dout, *, chunk=ws.CHUNK):
    """The CUDA backward kernel's arithmetic in plain PyTorch (a test
    helper, on no path), in f32 on log2(e)-scaled cumulative decays over
    chunks zero-padded to ``chunk`` tokens, summed by groups of 8 tokens
    as the kernel sums them:

    1. each chunk c but the first: its term (r ⊙ 2^cum_ex)ᵀ do of the
       gradient of the state entering it, and its decay 2^total;
    2. the reverse scan from the last slot: G_{c-1} = 2^total_c G_c +
       term_c, G_last = 0;
    3. each chunk's dr, dk, dv from its inputs, its entering state S_c
       (the forward's scan, emulated here) and G_c: A = do vᵀ, the
       intra-chunk sums factored on two levels with per-pair exps only
       inside 8-token leaves (:func:`_intra_factored`), the three state
       products (S_c do, G_c v, kout G_c) in split TF32
       (:func:`_split_tf32`);
       dwlog from the chunk's last token back, Σ_{t>i} f_t - h_i + y, with
       y = 2^total ⊙ Σ_j G_c S_c + Σ_s k_s ⊙ p_out_s (p_out = dk's state
       term) and no S_{c+1}; a [B, n, H, hd] partial of du;
    4. du: the partials summed over batch, then chunk, in that order.

    Asserts that no exponent it takes is positive."""
    B, S, H, hd = r.shape
    n = -(-S // chunk)
    z = _kernel_chunks(r, k, v, wlog, dout, chunk)
    rf, kf, vf, gf, cum = z["rf"], z["kf"], z["vf"], z["gf"], z["cum"]
    total, s_in, g_out = z["total"], z["states"][:, :, :n], z["grads"]
    a = gf @ vf.transpose(-1, -2)                           # A[t, s]
    a_diag = torch.diagonal(a, dim1=-2, dim2=-1)[..., None]
    uf = u.float()[None, :, None, None, :]
    att, dr_state, dk_state = _intra_factored(rf, kf, a, cum, z["bound"])
    att = att + torch.diag_embed((rf * uf * kf).sum(-1))
    dr_state = dr_state + _exp2(_cum_ex(cum)) * _split_tf32(
        gf, s_in.transpose(-1, -2))
    p_out = _exp2(total[..., None, :] - cum) * _split_tf32(
        vf, g_out.transpose(-1, -2))
    dk_state = dk_state + p_out
    dr = dr_state + uf * kf * a_diag
    dk = dk_state + uf * rf * a_diag
    dv = att.transpose(-1, -2) @ gf + _split_tf32(z["k_out"], g_out)
    f, h = rf * dr_state - kf * dk_state, kf * dk_state
    y = (_exp2(total) * (g_out * s_in).sum(-1)
         + (kf * p_out).sum(-2))                            # [B,H,n,hd]
    dwlog = torch.empty_like(f)
    after = torch.zeros_like(f[..., 0, :])
    for t in range(chunk - 1, -1, -1):
        dwlog[..., t, :] = after - h[..., t, :] + y
        after = after + f[..., t, :]
    # 4. du
    part = (rf * kf * a_diag).sum(3).permute(0, 2, 1, 3)    # [B,n,H,hd]
    du = torch.zeros((H, hd))
    for b in range(B):
        for c in range(n):
            du = du + part[b, c]

    def back(x):
        return x.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H, hd)[:, :S]
    return (*(back(x).to(r.dtype) for x in (dr, dk, dv)), back(dwlog), du)


@pytest.mark.parametrize("case", [CASES[i] for i in (0, 3, 6, 12, 14, 16,
                                                       17)], ids=str)
def test_wkv6_bwd_kernel_passes_match_oracle(case, jax_grads):
    """The kernel's four passes, emulated, against jax.vjp of the
    reference's oracle and the plain backward, within the tolerances
    above: one token, a chunk less one, a chunk and one, three chunks
    (the last ragged), and the steep decay."""
    arrays = _inputs(case)
    r, k, v, wlog, u, do = _torch(case, arrays)
    got = _wkv6_bwd_passes(r, k, v, wlog, u, do)
    _check(case, got, jax_grads[case])
    plain = ref.wkv6_chunked_bwd_plain(r, k, v, wlog, u, do, chunk=32)
    _check(case, got, [x.float().numpy() for x in plain])


@pytest.mark.parametrize("hd", [32, 64])
def test_wkv6_bwd_y_from_entering_state(hd):
    """y = Σ_j G_c S_{c+1}, the pairs that straddle a chunk's end, from
    S_c, G_c and dk's state term alone (2^total ⊙ Σ_j G_c S_c + Σ_s k_s ⊙
    p_out_s, as the kernel forms it) against the direct sum over the state
    leaving the chunk: f32, the steep decay, 300 tokens (ten chunks, the
    last ragged), within 1e-5 of (max |y| + 1)."""
    case = (300, hd, "float32", 3.0)
    r, k, v, wlog, u, do = _torch(case, _inputs(case))
    z = _kernel_chunks(r, k, v, wlog, do)
    s_in, s_out, g_out = (z["states"][:, :, :-1], z["states"][:, :, 1:],
                          z["grads"])
    p_out = (_exp2(z["total"][..., None, :] - z["cum"])
             * (z["vf"] @ g_out.transpose(-1, -2)))
    got = (_exp2(z["total"]) * (g_out * s_in).sum(-1)
           + (z["kf"] * p_out).sum(-2))
    want = (g_out * s_out).sum(-1)
    assert float(want.abs().max()) > 1.0
    assert float((got - want).abs().max()) <= F32_TOL * (
        float(want.abs().max()) + 1.0)


@pytest.mark.parametrize("S", [1, 8, 9, 16, 17, 31, 33, 300])
def test_wkv6_bwd_factored_intra_matches_pairs(S):
    """The two-level factoring of the intra-chunk sums (att, dr's and
    dk's) against one exp per (t, s, d) pair, on the kernel's grouped
    cumsums: lengths at and past a leaf's and a half's edge, and ragged
    chunks; f32, hd 32, within 1e-5 of (max |pairs| + 1)."""
    case = (S, 32, "float32", 1.0)
    r, k, v, wlog, u, do = _torch(case, _inputs(case))
    z = _kernel_chunks(r, k, v, wlog, do)
    a = z["gf"] @ z["vf"].transpose(-1, -2)
    got = _intra_factored(z["rf"], z["kf"], a, z["cum"], z["bound"])
    want = _intra_pairs(z["rf"], z["kf"], a, z["cum"])
    for name, x, y in zip(("att", "dr", "dk"), got, want):
        assert float((x - y).abs().max()) <= F32_TOL * (
            float(y.abs().max()) + 1.0), name
