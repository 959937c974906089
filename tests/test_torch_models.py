"""The port's serving path (repro_torch.models, configs, launch.serve)
against the JAX package, on the smoke configs of yi-6b, rwkv6-3b and
llama4-maverick-400b-a17b (whose MoE has its own tests in
tests/test_torch_moe.py).

Both packages run the same weights: the reference's ``init_lm`` tree,
carried to the port through ``convert.lm_params_from_jax``, and the same
numpy-made inputs. Everything runs in f32 on the CPU, where the two agree
to f32 rounding: layers to 2e-5, whole-model logits to 1e-4 (a few
hundred f32 operations deep); decode attention is also held to the
reference in bf16, where it rounds its probabilities as the reference
does. The reference's chunked RWKV6 gives NaN for
prompts of 128 tokens or more; the port's stays finite there and is held
against the reference's sequential recurrence instead.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["yi-6b", "rwkv6-3b", "llama4-maverick-400b-a17b"]
LAYER_TOL = 2e-5
MODEL_TOL = 1e-4


class Model:
    """One smoke config in f32 in both packages, on the same weights."""

    def __init__(self, arch: str):
        self.jcfg = jregistry.get_smoke(arch).replace(dtype=jnp.float32)
        self.cfg = registry.get_smoke(arch).replace(dtype=torch.float32)
        self.jparams, _ = JT.init_lm(self.jcfg, jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.lm = convert.lm_params_from_jax(self.tree, self.cfg, "cpu")
        self.jstep = jax.jit(
            lambda p, b, c: JD.decode_step(p, self.jcfg, b, c))

    def layer(self, i: int = 0):
        """Layer i's parameters in both packages."""
        jl = jax.tree.map(lambda x: x[i], self.jparams["segments"]["seg0"])
        return jl, self.lm["segments"]["seg0"][i]


@pytest.fixture(scope="module")
def models():
    return {arch: Model(arch) for arch in ARCHS}


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _tokens(seed, cfg, B, Sq):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, Sq))


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _jax_decode(m, toks, steps=None):
    """The reference's teacher-forced decode: logits per step and the
    final cache."""
    B, Sq = toks.shape
    cache = JD.cache_zeros(JD.cache_spec(m.jcfg, B, Sq))
    outs = []
    for t in range(steps or Sq):
        lg, cache = m.jstep(m.jparams, {"token": jnp.asarray(toks[:, t:t + 1]),
                                        "index": jnp.int32(t)}, cache)
        outs.append(np.asarray(lg))
    return np.stack(outs, axis=1), cache


def _port_decode(m, toks, steps=None):
    B, Sq = toks.shape
    cache = D.cache_zeros(D.cache_spec(m.cfg, B, Sq), "cpu")
    outs = []
    for t in range(steps or Sq):
        lg, cache = D.decode_step(m.lm, m.cfg, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "index": t}, cache)
        outs.append(lg.numpy())
    return np.stack(outs, axis=1), cache


# -- configs and weights ------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch):
    for port, ref in ((registry.get(arch), jregistry.get(arch)),
                      (registry.get_smoke(arch), jregistry.get_smoke(arch))):
        assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert port.replace(dtype=None).__dict__ \
            == ref.replace(dtype=None).__dict__


@pytest.mark.parametrize("arch", [a for a in jregistry.ARCHS
                                  if a not in registry.ARCHS])
def test_registry_raises_for_unported_archs(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        registry.get(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_reference_layout(models, arch):
    """The port's initialiser draws the reference's tree: same keys,
    shapes and dtype, normal × 0.02 (× 0.006 for the decay projection),
    zeros and ones where the reference has them; one seed, one model."""
    cfg = registry.get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    lm = T.init_lm(cfg, gen, "cpu")
    got = convert.lm_params_to_numpy(lm)
    ref, _ = JT.init_lm(jregistry.get_smoke(arch), jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for path, leaf in paths:
        keys = [p.key for p in path]
        mine = got
        for key in keys:
            mine = mine[key]
        assert mine.shape == leaf.shape, keys
        want = np.asarray(leaf, np.float32)
        if np.all(want == want.flat[0]):           # ones or zeros
            assert np.array_equal(mine, want), keys
        elif mine.size > 1000:
            scale = 0.006 if keys[-1] in ("w_w", "router") else 0.02
            assert abs(mine.std() / scale - 1) < 0.05, keys
    assert all(p.dtype == torch.bfloat16 for p in lm.parameters())
    again = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(lm.parameters(),
                                                  again.parameters()))


def test_convert_round_trip_and_shape_check(models):
    m = models["yi-6b"]
    back = convert.lm_params_to_numpy(m.lm)
    assert jax.tree.all(jax.tree.map(np.array_equal, m.tree, back))
    bad = jax.tree.map(lambda x: x, m.tree)
    bad["embed"]["tok"] = bad["embed"]["tok"][:-1]
    with pytest.raises(ValueError, match="embed.tok"):
        convert.lm_params_from_jax(bad, m.cfg, "cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card and without device="cpu", creation raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_smoke("rwkv6-3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.cache_zeros(D.cache_spec(cfg, 1, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "rwkv6-3b"])


# -- layers -------------------------------------------------------------------

def test_rmsnorm_and_rope(models):
    x = _rand(0, 2, 16, 4, 32)
    scale = 1 + _rand(1, 32, scale=0.1)
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    assert _err(got, want) < LAYER_TOL
    pos = np.broadcast_to(np.arange(40, 56), (2, 16))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 5e6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6)
    assert _err(got, want) < LAYER_TOL
    # M-RoPE: three position streams that differ, sections (4, 6, 6)
    pos3 = np.random.default_rng(2).integers(0, 64, (3, 2, 16))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                       (4, 6, 6))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (4, 6, 6))
    assert _err(got, want) < LAYER_TOL


@pytest.mark.parametrize("Sq", [64, 1024])
def test_gqa_apply_prefill(models, Sq):
    """S = 64 takes the reference's direct softmax, S = 1024 its blockwise
    ``flash_attend``; the port runs its flash kernel's plain version for
    both."""
    m = models["yi-6b"]
    jl, tl = m.layer(1)
    x = _rand(Sq, 2, Sq, m.cfg.d_model)
    pos = np.broadcast_to(np.arange(Sq), (2, Sq)).copy()
    got, nc = L.gqa_apply(tl["attn"], m.cfg, torch.from_numpy(x),
                          torch.from_numpy(pos), window=-1)
    want, _ = JL.gqa_apply(jl["attn"], m.jcfg, jnp.asarray(x),
                           jnp.asarray(pos), window=-1)
    assert nc is None
    assert _err(got, want) < LAYER_TOL


def test_gqa_apply_decode_updates_cache_in_place(models):
    m = models["yi-6b"]
    jl, tl = m.layer(0)
    B, Lc, kv = 2, 12, m.cfg.n_kv_heads * m.cfg.hd
    ck, cv = _rand(3, B, Lc, kv), _rand(4, B, Lc, kv)
    x, idx = _rand(5, B, 1, m.cfg.d_model), 7
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy())}
    ptr = cache["k"].data_ptr()
    got, nc = L.gqa_apply(tl["attn"], m.cfg, torch.from_numpy(x),
                          torch.full((B, 1), idx), window=-1, cache=cache,
                          cache_index=idx)
    want, jc = JL.gqa_apply(jl["attn"], m.jcfg, jnp.asarray(x),
                            jnp.full((B, 1), idx), window=-1,
                            cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                            cache_index=jnp.int32(idx))
    assert nc is cache and nc["k"].data_ptr() == ptr
    assert _err(got, want) < LAYER_TOL
    assert _err(nc["k"], jc["k"]) == 0 and _err(nc["v"], jc["v"]) == 0


@pytest.mark.parametrize("B,Sq,Skv,H,K,h", [(2, 1, 40, 8, 2, 32),
                                            (2, 3, 64, 4, 2, 16),
                                            (1, 1, 300, 4, 1, 64)])
def test_attend_bf16_rounds_probabilities_like_reference(B, Sq, Skv, H, K,
                                                         h):
    """Decode attention in bf16: the probabilities are rounded to v's
    dtype before the weighted sum, as in the reference. Both sides then
    sum the same bf16 products in f32, so fewer than 1 % of the bf16
    outputs may differ (the two softmaxes may round a probability
    differently), by at most one rounding step."""
    rng = np.random.default_rng(B * Sq + Skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, h), (B, Skv, K, h), (B, Skv, K, h)))
    mask = np.tril(np.ones((Sq, Skv), bool), k=Skv - Sq)
    want = np.asarray(JL.attend(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(mask)).astype(jnp.float32))
    got = L.attend(*(torch.from_numpy(x).to(torch.bfloat16)
                     for x in (q, k, v)), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.mean(got != want) < 0.01
    assert _err(got, want) <= 2.0 ** -7 * np.abs(want).max()


def test_mlp_and_channel_mix(models):
    _, yl = models["yi-6b"].layer(0)
    jl = jax.tree.map(lambda x: x[0],
                      models["yi-6b"].jparams["segments"]["seg0"])
    x = _rand(6, 2, 8, 128)
    assert _err(L.mlp_apply(yl["mlp"], torch.from_numpy(x)),
                JL.mlp_apply(jl["mlp"], jnp.asarray(x))) < LAYER_TOL
    jr, tr = models["rwkv6-3b"].layer(0)
    assert _err(S.channel_mix(tr["cmix"], torch.from_numpy(x)),
                JS.channel_mix(jr["cmix"], jnp.asarray(x))) < LAYER_TOL


def test_rwkv6_chunked_and_decode_step(models):
    m = models["rwkv6-3b"]
    jl, tl = m.layer(2)
    x = _rand(7, 2, 64, m.cfg.d_model)
    got = S.rwkv6_chunked(tl["tmix"], m.cfg, torch.from_numpy(x))
    want = JS.rwkv6_chunked(jl["tmix"], m.jcfg, jnp.asarray(x))
    assert _err(got, want) < LAYER_TOL
    H, hd = m.cfg.ssm_heads, m.cfg.d_model // m.cfg.ssm_heads
    state = _rand(8, 2, H, hd, hd, scale=0.3)
    y, st = S.rwkv6_decode_step(tl["tmix"], m.cfg, torch.from_numpy(x[:, :1]),
                                torch.from_numpy(state))
    jy, jst = JS.rwkv6_decode_step(jl["tmix"], m.jcfg, jnp.asarray(x[:, :1]),
                                   jnp.asarray(state))
    assert _err(y, jy) < LAYER_TOL and _err(st, jst) < LAYER_TOL


# -- prefill and decode -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(models, arch):
    m = models[arch]
    toks = _tokens(10, m.cfg, 2, 64)
    got, cache = D.prefill(m.lm, m.cfg, {"tokens": torch.from_numpy(toks)})
    want, _ = JD.prefill(m.jparams, m.jcfg, {"tokens": jnp.asarray(toks)})
    assert cache is None and got.shape == (2, m.cfg.vocab)
    assert _err(got, want) < MODEL_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(models, arch):
    """Eight steps: the logits of every step and the cache after the last
    (updated in place by the port) equal the reference's."""
    m = models[arch]
    toks = _tokens(11, m.cfg, 2, 8)
    got, cache = _port_decode(m, toks)
    want, jcache = _jax_decode(m, toks)
    assert _err(got, want) < MODEL_TOL
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, leaf in flat:
        mine = cache
        for p in path:
            mine = mine[p.key]
        assert tuple(mine.shape) == leaf.shape
        assert _err(mine, leaf) < MODEL_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches_jax(arch):
    cfg = registry.get(arch)
    got = D.cache_spec(cfg, 4, 1056)
    want = JD.cache_spec(jregistry.get(arch), 4, 1056)
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[0], tuple))[0]
    assert len(flat) == len(jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, tuple)))
    for path, (shape, dtype) in flat:
        mine = got
        for p in path:
            mine = mine[p.key]
        assert mine[0] == shape
        assert str(mine[1]).split(".")[-1] == jnp.dtype(dtype).name


def test_rwkv6_prefill_finite_where_reference_is_nan(models):
    """rwkv6-smoke, f32, B = 2, S = 128: the reference's prefill logits are
    NaN (its chunked form overflows f32). The port's are finite, equal
    its own teacher-forced decode and the reference's (finite) decode,
    and its time mix equals the reference's sequential oracle."""
    m = models["rwkv6-3b"]
    toks = _tokens(12, m.cfg, 2, 128)
    want_nan, _ = JD.prefill(m.jparams, m.jcfg, {"tokens": jnp.asarray(toks)})
    assert np.isnan(np.asarray(want_nan)).any()
    got, _ = D.prefill(m.lm, m.cfg, {"tokens": torch.from_numpy(toks)})
    assert torch.isfinite(got).all()
    port_dec, _ = _port_decode(m, toks)
    jax_dec, _ = _jax_decode(m, toks)
    assert _err(got, port_dec[:, -1]) < MODEL_TOL
    assert _err(got, jax_dec[:, -1]) < MODEL_TOL
    jl, tl = m.layer(0)
    x = _rand(13, 2, 128, m.cfg.d_model)
    assert np.isnan(np.asarray(
        JS.rwkv6_chunked(jl["tmix"], m.jcfg, jnp.asarray(x)))).any()
    got_mix = S.rwkv6_chunked(tl["tmix"], m.cfg, torch.from_numpy(x))
    step = jax.jit(lambda p, xt, st: JS.rwkv6_decode_step(p, m.jcfg, xt, st))
    H, hd = m.cfg.ssm_heads, m.cfg.d_model // m.cfg.ssm_heads
    state, ys = jnp.zeros((2, H, hd, hd), jnp.float32), []
    for t in range(128):               # rwkv6_sequential_oracle, step jitted
        y, state = step(jl["tmix"], jnp.asarray(x[:, t:t + 1]), state)
        ys.append(np.asarray(y))
    want_mix = np.concatenate(ys, axis=1)
    assert _err(got_mix, want_mix) < LAYER_TOL
    assert _err(S.rwkv6_sequential_oracle(tl["tmix"], m.cfg,
                                          torch.from_numpy(x)),
                want_mix) < LAYER_TOL


def test_rwkv6_gradient_finite_where_reference_is_nan(models):
    """rwkv6-smoke, f32, B = 2, S = 128, the input of the test above:
    jax.grad of the reference's chunked time mix (``models/ssm.py::
    rwkv6_chunked``) in x and in the decay base is NaN, as its forward is
    (in the bonus u, which only the diagonal terms take, it is finite).
    The port's gradient, taken
    through the WKV6 function's plain backward, is finite and equals
    jax.grad of the reference's sequential form (its decode step scanned
    over the tokens) in x, the decay base and the bonus u, within
    LAYER_TOL relative to (max |grad| + 1): f32 rounding of sums over 128
    tokens and a 128-wide layer in another order."""
    m = models["rwkv6-3b"]
    jl, tl = m.layer(0)
    x = _rand(13, 2, 128, m.cfg.d_model)
    cot = _rand(14, 2, 128, m.cfg.d_model)
    H, hd = m.cfg.ssm_heads, m.cfg.d_model // m.cfg.ssm_heads

    def chunked(xx, bu, db):
        p = {**jl["tmix"], "bonus_u": bu, "decay_base": db}
        return jnp.sum(JS.rwkv6_chunked(p, m.jcfg, xx) * cot)

    def sequential(xx, bu, db):
        p = {**jl["tmix"], "bonus_u": bu, "decay_base": db}

        def body(st, xt):
            y, st = JS.rwkv6_decode_step(p, m.jcfg, xt[:, None], st)
            return st, y[:, 0]
        _, ys = jax.lax.scan(body, jnp.zeros((2, H, hd, hd), jnp.float32),
                             jnp.swapaxes(xx, 0, 1))
        return jnp.sum(jnp.swapaxes(ys, 0, 1) * cot)
    args = (jnp.asarray(x), jl["tmix"]["bonus_u"], jl["tmix"]["decay_base"])
    nan = jax.jit(jax.grad(chunked, argnums=(0, 2)))(*args)
    assert all(np.isnan(np.asarray(g)).any() for g in nan)
    want = jax.jit(jax.grad(sequential, argnums=(0, 1, 2)))(*args)
    xt = torch.from_numpy(x).requires_grad_()
    leaves = (xt, tl["tmix"]["bonus_u"], tl["tmix"]["decay_base"])
    loss = (S.rwkv6_chunked(tl["tmix"], m.cfg, xt)
            * torch.from_numpy(cot)).sum()
    for got, w in zip(torch.autograd.grad(loss, leaves), want):
        w = np.asarray(w)
        assert torch.isfinite(got).all()
        assert _err(got, w) < LAYER_TOL * (float(np.abs(w).max()) + 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """Counterpart of test_arch_smoke.py::test_decode_matches_forward_internlm:
    sequential decode over a prompt reproduces the teacher-forced forward
    logits (cache correctness). For the MoE config the forward's 16 tokens
    meet a capacity of 8 and the decode's single token never overflows:
    the two agree before the first position the forward dropped (a
    token's place in its expert counts only earlier tokens, so a drop
    changes nothing before it) and differ there."""
    m = models[arch]
    toks = _tokens(14, m.cfg, 1, 16)
    x = L.embed_apply(m.lm["embed"], torch.from_numpy(toks))
    pos = torch.arange(16)[None]
    routes, real = [], L.moe_route
    L.moe_route = lambda *a: routes.append(real(*a)) or routes[-1]
    try:
        with torch.no_grad():
            hidden, _ = T.backbone_forward(m.lm, m.cfg, x, pos)
            full = L.logits_apply(m.lm["embed"], hidden,
                                  m.cfg.tie_embeddings)
    finally:
        L.moe_route = real
    assert len(routes) == (2 if m.cfg.n_experts else 0)
    first = min([int(torch.nonzero(~r.keep)[0]) for r in routes
                 if not r.keep.all()], default=16)
    assert torch.equal(hidden, m.lm(torch.from_numpy(toks)))
    dec, _ = _port_decode(m, toks)
    assert _err(dec[:, :first], full[:, :first]) < MODEL_TOL
    if m.cfg.n_experts:
        assert 8 <= first < 16
        assert _err(dec[:, first], full[:, first]) > MODEL_TOL


def test_prefill_batch_chunks_are_exact(models):
    m = models["yi-6b"]
    toks = torch.from_numpy(_tokens(15, m.cfg, 8, 32))
    auto, _ = D.prefill(m.lm, m.cfg, {"tokens": toks})          # 4 chunks
    whole, _ = D.prefill(m.lm, m.cfg, {"tokens": toks}, batch_chunks=1)
    assert _err(auto, whole) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generate_matches_jax_greedy(models, arch):
    """``serve.generate`` (teacher-forced prompt, then greedy) picks the
    reference's tokens on the same weights."""
    m = models[arch]
    P, N = 6, 5
    prompts = _tokens(16, m.cfg, 2, P)
    got = serve.generate(m.lm, m.cfg, torch.from_numpy(prompts), N).numpy()
    cache = JD.cache_zeros(JD.cache_spec(m.jcfg, 2, P + N))
    gen = []
    for t in range(P + N - 1):
        inp = prompts[:, t:t + 1] if t < P else gen[-1]
        lg, cache = m.jstep(m.jparams, {"token": jnp.asarray(inp),
                                        "index": jnp.int32(t)}, cache)
        if t >= P - 1:
            gen.append(np.asarray(jnp.argmax(lg, axis=-1))[:, None])
    assert np.array_equal(got, np.concatenate(gen, axis=1))


def test_serve_main_on_cpu(capsys):
    serve.main(["--arch", "rwkv6-3b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-smoke batch=2 prompt=4 new=3" in out
    assert "(host CPU)" in out and out.count("sample:") == 1


def test_port_imports_without_jax_or_reference():
    """Every repro_torch module, chip_smoke.py and the port's example
    twins (examples/torch_train_smr_service.py,
    examples/torch_serve_engine.py) import with jax and repro blocked;
    the modules include the DES, its baselines and the training
    service."""
    code = (
        "import importlib, importlib.util, json, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for name, path in (('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r}), ('torch_smr_example', "
        f"{str(ROOT / 'examples' / 'torch_train_smr_service.py')!r}), "
        "('torch_serve_example', "
        f"{str(ROOT / 'examples' / 'torch_serve_engine.py')!r})):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None)\n"
        "print(json.dumps([mods, bad]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert len(mods) >= 60
    core = ("events", "network", "agents", "classic", "htpaxos", "ring",
            "multiring", "spaxos", "classical_smr", "analytical",
            "invariants", "tilesim")
    assert {f"repro_torch.core.{m}" for m in core} <= set(mods)
    assert "repro_torch.runtime.coordinator" in mods
