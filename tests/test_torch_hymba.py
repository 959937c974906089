"""The port's hybrid family (hymba-1.5b: attention and Mamba heads in
parallel, sliding-window attention except in the global layers, 128 meta
tokens) against the JAX package, on its smoke config (5 layers, global
0, 2 and 4, window 32, d 64, ssm_state 16) in f32 on the CPU.

Both packages run the same weights (the reference's ``init_lm`` or
``make_state`` tree, carried to the port through ``convert``) and the same
numpy-made inputs. Tolerances: the Mamba scan and decode step 1e-5 of the
output's largest magnitude; hidden states and logits 1e-5 (f32 rounding
through 5 layers, each value ~1); losses 2e-5 relative; gradients 1e-5
times the leaf's largest magnitude (floored at 1e-2); parameters after
two train steps lr/10 an element (a step's update is lr an element, so
one update of the wrong sign fails; measured on the CPU: 1.1e-5 AdamW,
3.7e-7 Adafactor) and, over the whole tree in the L2 norm, 1e-3 of the
reference's change from the start (measured 1.8e-5, 1.6e-6). In bf16 the
loss is held at 1e-2 relative: both packages round the same products to
bf16, in another order.

The model is the one ``lm_loss`` defines: the sequence behind the meta
tokens. The reference's serving path differs from it in three places
(ROADMAP.md queue 3), each shown by a test here: its ring mask attends
never-written slots, its prefill leaves the meta tokens out, and its
launcher never writes them into the cache. Where the reference's
``decode_step`` is right (every layer global, the meta tokens written
first) the port's equals it cache for cache.
"""
from __future__ import annotations

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
from repro.runtime.statemachine import tree_digest as jdigest  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reference_leaves  # noqa: E402
from repro_torch.runtime.statemachine import tree_digest  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

ARCH = "hymba-1.5b"
META = 128
# one prompt shape per model, so each jitted reference function compiles
# once: B = 2 x 48 tokens on the smoke config (128 + 48 positions: the
# window's ring of 32 wraps), 2 x 24 on the all-global variant
B_, S_, S_GLOBAL = 2, 48, 24
SCAN_TOL = 1e-5
MODEL_TOL = 1e-5
LOSS_TOL = 2e-5
GRAD_TOL = 1e-5
BF16_LOSS_TOL = 1e-2
LR = 1e-3
PARAM_TOL = LR / 10
PARAM_REL_TOL = 1e-3
# the reference's serving faults are far above f32 rounding
FAULT = 1e-3


class Model:
    """The smoke config (with ``replace`` overrides) in f32 in both
    packages, on the same weights."""

    def __init__(self, seed: int = 0, **replace):
        self.jcfg = jregistry.get_smoke(ARCH).replace(dtype=jnp.float32,
                                                      **replace)
        self.cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32,
                                                    **replace)
        self.jparams, _ = JT.init_lm(self.jcfg, jax.random.PRNGKey(seed))
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.lm = convert.lm_params_from_jax(self.tree, self.cfg, "cpu")
        self.jstep = jax.jit(
            lambda p, b, c: JD.decode_step(p, self.jcfg, b, c))
        self.jforward = jax.jit(lambda p, t: _jax_meta_logits(p, self.jcfg,
                                                              t))


def _jax_meta_logits(params, jcfg, tokens):
    """The reference's model as its ``lm_loss`` runs it: the meta tokens
    at position 0 before the tokens (positions + 128), their hidden
    states dropped; the logits of every token position."""
    B, Sq = tokens.shape
    x = JL.embed_apply(params["embed"], tokens)
    meta = jnp.broadcast_to(params["meta_tokens"][None],
                            (B, *params["meta_tokens"].shape))
    x = jnp.concatenate([meta.astype(x.dtype), x], axis=1)
    pos = jnp.concatenate([jnp.zeros((B, META), jnp.int32),
                           jnp.arange(Sq, dtype=jnp.int32)[None]
                           .repeat(B, 0) + META], axis=1)
    hidden, _ = JT.backbone_forward(params, jcfg, x, pos)
    return JL.logits_apply(params["embed"], hidden[:, META:],
                           jcfg.tie_embeddings)


@pytest.fixture(scope="module")
def model():
    return Model()


@pytest.fixture(scope="module")
def all_global():
    """Every layer global: the reference's decode has no ring there."""
    return Model(global_layers=(0, 1, 2, 3, 4))


def _tokens(seed, cfg, B, Sq):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, Sq))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _rel(a, b) -> float:
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def _first_over(got, want, tol) -> int:
    """The first position (axis 1) where |got - want| > tol, else -1."""
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    over = np.nonzero(d.reshape(d.shape[0], d.shape[1], -1).max(axis=(0, 2))
                      > tol)[0]
    return int(over[0]) if over.size else -1


def _jax_decode(m, toks, *, prime=True, slots=None):
    """The reference's ``decode_step`` driven token by token: with
    ``prime`` the meta tokens first (embeds at index -128..-1, positions
    -128) into caches of ``slots`` (default 128 + S) slots. Returns the
    logits of every token step and the final cache."""
    B, Sq = toks.shape
    cache = JD.cache_zeros(JD.cache_spec(
        m.jcfg, B, slots or (META * prime + Sq)))
    if prime:
        for j in range(META):
            x = jnp.broadcast_to(m.jparams["meta_tokens"][j],
                                 (B, 1, m.jcfg.d_model))
            _, cache = m.jstep(m.jparams, {
                "embeds": x, "index": jnp.int32(j - META),
                "positions": jnp.full((B, 1), -META, jnp.int32)}, cache)
    outs = []
    for t in range(Sq):
        lg, cache = m.jstep(m.jparams, {"token": jnp.asarray(toks[:, t:t + 1]),
                                        "index": jnp.int32(t)}, cache)
        outs.append(np.asarray(lg))
    return np.stack(outs, axis=1), cache


def _port_decode(m, toks, index_tensor=False):
    """The port's ``decode_step`` driven as :func:`_jax_decode` drives the
    reference's (``index_tensor``: the index as a 0-d tensor, the form a
    captured step takes)."""
    B, Sq = toks.shape
    cache = D.cache_zeros(D.cache_spec(m.cfg, B, META + Sq), "cpu")

    def idx(i):
        return torch.tensor(i) if index_tensor else i
    for j in range(META):
        x = m.lm["meta_tokens"][j].detach().expand(B, 1, -1)
        D.decode_step(m.lm, m.cfg, {
            "embeds": x, "index": idx(j - META),
            "positions": torch.full((B, 1), -META, dtype=torch.int32)},
            cache)
    outs = []
    for t in range(Sq):
        lg, cache = D.decode_step(m.lm, m.cfg, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "index": idx(t)},
            cache)
        outs.append(lg)
    return torch.stack(outs, dim=1), cache


def _cache_errs(cache, jcache) -> list:
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        mine = cache
        for p in path:
            mine = mine[p.key]
        assert tuple(mine.shape) == leaf.shape, path
        out.append(_err(mine, leaf))
    return out


# -- config, registry, weights ------------------------------------------------

def test_registry_has_the_hybrid_config():
    for port, ref in ((registry.get(ARCH), jregistry.get(ARCH)),
                      (registry.get_smoke(ARCH), jregistry.get_smoke(ARCH))):
        assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert port.replace(dtype=None).__dict__ \
            == ref.replace(dtype=None).__dict__
    assert ARCH in registry.ARCHS and ARCH not in registry.NOT_PORTED
    assert registry.microbatches(ARCH, "train_4k") \
        == jregistry.microbatches(ARCH, "train_4k") == 4
    assert registry.NOT_PORTED == {}
    for arch in ("deepseek-v3-671b",):
        assert registry.get_smoke(arch).replace(dtype=None).__dict__ \
            == jregistry.get_smoke(arch).replace(dtype=None).__dict__


@pytest.mark.parametrize("arch", [ARCH])
def test_plan_and_layout_match_reference(arch):
    """Segments as the reference plans them (global layers unscanned),
    the reference's tree from the port's initialiser, and the global
    layers' leaves reported unstacked."""
    for cfg, jcfg in ((registry.get(arch), jregistry.get(arch)),
                      (registry.get_smoke(arch), jregistry.get_smoke(arch))):
        assert T.plan_segments(cfg) == JT.plan_segments(jcfg)
    cfg = registry.get_smoke(arch)
    lm = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    got = convert.lm_params_to_numpy(lm)
    ref, _ = JT.init_lm(jregistry.get_smoke(arch), jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for path, leaf in paths:
        mine = got
        for p in path:
            mine = mine[p.key]
        assert mine.shape == leaf.shape, path
        want = np.asarray(leaf, np.float32)
        if np.all(want == want.flat[0]):
            assert np.array_equal(mine, want), path
    leaves = reference_leaves(lm)
    assert [p for p, _, _ in leaves] == [
        tuple(k.key for k in p) for p, _ in paths]
    stacked = {p[1] for p, _, st in leaves if p[0] == "segments" and st}
    flat = {p[1] for p, _, st in leaves if p[0] == "segments" and not st}
    assert stacked == {"seg1", "seg3"} and flat == {"seg0", "seg2", "seg4"}
    assert tuple(lm["meta_tokens"].shape) == (META, cfg.d_model)


def test_convert_round_trip_and_shape_check(model):
    back = convert.lm_params_to_numpy(model.lm)
    assert jax.tree.all(jax.tree.map(np.array_equal, model.tree, back))
    bad = jax.tree.map(lambda x: x, model.tree)
    bad["meta_tokens"] = bad["meta_tokens"][:-1]
    with pytest.raises(ValueError, match="meta_tokens"):
        convert.lm_params_from_jax(bad, model.cfg, "cpu")
    bad = jax.tree.map(lambda x: x, model.tree)
    bad["segments"]["seg2"]["ssm"]["A_log"] = \
        bad["segments"]["seg2"]["ssm"]["A_log"][None]
    with pytest.raises(ValueError, match="seg2.ssm.A_log"):
        convert.lm_params_from_jax(bad, model.cfg, "cpu")


# -- the Mamba heads ----------------------------------------------------------

@pytest.mark.parametrize("Sq", [1, 7, 128, 200, 256])
def test_mamba_scan_matches_reference(model, Sq):
    """S a multiple of the reference's 128-token chunk and not; the port's
    chunk is ceil(sqrt(S)), which S need not be a multiple of either. The
    input is large enough that dt·A sums past -88.7 inside a chunk."""
    p = model.tree["segments"]["seg0"]["ssm"]
    x = 3.0 * _rand(Sq, 2, Sq, model.cfg.d_model)
    want = np.asarray(jax.jit(lambda pp, xx: JS.mamba_scan(
        pp, model.jcfg, xx))(p, jnp.asarray(x)))
    got = S.mamba_scan(model.lm["segments"]["seg0"]["ssm"], model.cfg,
                       torch.from_numpy(x))
    assert _err(got, want) <= SCAN_TOL * np.abs(want).max()
    with torch.no_grad():
        xf, _, B_, C_, dt, A = S._mamba_project(
            model.lm["segments"]["seg0"]["ssm"], torch.from_numpy(x))
        y = S.selective_scan(xf, dt, A, B_, C_)
        if Sq > 100:     # the in-chunk log decay reaches the f32 exp range
            la = dt[..., None] * A
            assert float(la[:, :128].sum(dim=1).min()) < -88.7
        for chunk in (1, 5, Sq):
            other = S.selective_scan(xf, dt, A, B_, C_, chunk)
            assert _err(other, y.numpy()) <= SCAN_TOL * float(y.abs().max())


def test_mamba_decode_step_matches_reference(model):
    """Twelve steps of the recurrence in both packages, and the port's
    steps against its own scan over the same tokens."""
    p = jax.tree.map(lambda a: a[0], model.tree["segments"]["seg1"]["ssm"])
    tp = model.lm["segments"]["seg1"][0]["ssm"]
    step = jax.jit(lambda pp, xt, h: JS.mamba_decode_step(pp, model.jcfg,
                                                          xt, h))
    x = _rand(3, 2, 12, model.cfg.d_model)
    h = jnp.zeros((2, model.cfg.d_model, model.cfg.ssm_state), jnp.float32)
    th = torch.zeros(tuple(h.shape))
    ys = []
    for t in range(12):
        y, h = step(jax.tree.map(jnp.asarray, p), jnp.asarray(x[:, t:t + 1]),
                    h)
        ty, th = S.mamba_decode_step(tp, model.cfg,
                                     torch.from_numpy(x[:, t:t + 1]), th)
        scale = float(np.abs(np.asarray(y)).max())
        assert _err(ty, y) <= SCAN_TOL * scale
        assert _err(th, h) <= SCAN_TOL * float(np.abs(np.asarray(h)).max())
        ys.append(ty)
    with torch.no_grad():
        scan = S.mamba_scan(tp, model.cfg, torch.from_numpy(x))
    assert _err(torch.cat(ys, dim=1), scan.numpy()) \
        <= SCAN_TOL * float(scan.abs().max())
    spec = S.mamba_state_spec(model.cfg, 2, model.cfg.d_model)
    assert spec == ((2, model.cfg.d_model, model.cfg.ssm_state),
                    torch.float32)


# -- the model: forward, loss -------------------------------------------------

def _port_logits(m, toks) -> torch.Tensor:
    """The port's logits at every token position, the meta tokens first
    (``LM.forward``)."""
    with torch.no_grad():
        return L.logits_apply(m.lm["embed"], m.lm(torch.from_numpy(toks)),
                              m.cfg.tie_embeddings)


def test_backbone_with_meta_tokens_matches_reference(model):
    """The forward behind the meta tokens: the port's hidden states
    (``LM.forward``, ``lm_hidden``) and logits against the reference's
    ``backbone_forward`` over the same prefix; past the window (128 + 48
    positions > 32)."""
    toks = _tokens(1, model.cfg, B_, S_)
    want = np.asarray(model.jforward(model.jparams, jnp.asarray(toks)))
    assert _err(_port_logits(model, toks), want) <= MODEL_TOL
    x = L.embed_apply(model.lm["embed"], torch.from_numpy(toks))
    pos = torch.arange(S_)[None].expand(B_, S_)
    xm, pm = T.with_meta_tokens(model.lm, model.cfg, x, pos)
    assert tuple(xm.shape) == (B_, META + S_, model.cfg.d_model)
    assert pm[:, :META].eq(0).all() and torch.equal(pm[:, META:], pos + META)


def test_lm_loss_matches_reference(model):
    toks = _tokens(2, model.cfg, 2, 64)
    batch = {"tokens": jnp.asarray(toks)}
    want, jm = jax.jit(lambda p, b: JT.lm_loss(p, model.jcfg, b))(
        model.jparams, batch)
    with torch.no_grad():
        got, m = T.lm_loss(model.lm, model.cfg,
                           {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= LOSS_TOL
    assert _rel(m["ce"], jm["ce"]) <= LOSS_TOL
    assert float(m["aux"]) == 0.0


def test_lm_loss_bf16_matches_reference():
    jcfg = jregistry.get_smoke(ARCH)
    cfg = registry.get_smoke(ARCH)
    jparams, _ = JT.init_lm(jcfg, jax.random.PRNGKey(4))
    lm = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    toks = _tokens(5, cfg, B_, S_)
    want, _ = jax.jit(lambda p, b: JT.lm_loss(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = T.lm_loss(lm, cfg, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= BF16_LOSS_TOL


# -- serving ------------------------------------------------------------------

def test_decode_step_matches_reference_all_global(all_global):
    """Every layer global (no ring), the meta tokens written first, caches
    of 128 + S slots: the reference is right here, and the port's
    ``decode_step`` equals it logits for logits and cache for cache, with
    the index as an int and as a 0-d tensor."""
    m = all_global
    toks = _tokens(6, m.cfg, B_, S_GLOBAL)
    want, jcache = _jax_decode(m, toks)
    got, cache = _port_decode(m, toks)
    assert _err(got, want) <= MODEL_TOL
    assert max(_cache_errs(cache, jcache)) <= MODEL_TOL
    got_t, cache_t = _port_decode(m, toks, index_tensor=True)
    assert torch.equal(got_t, got)
    meta = np.asarray(m.jforward(m.jparams, jnp.asarray(toks)))
    assert _err(want, meta) <= MODEL_TOL


def test_generate_matches_meta_forward_past_the_ring(model):
    """``serve.generate`` teacher-forced over S = 48 tokens and 4 greedy
    steps, window 32, 128 meta tokens first: every ring wraps (179
    positions). Its logits at every prompt position equal the reference's
    forward behind the meta tokens, at the greedy ones the port's own
    forward; its prefill equals the prompt's last."""
    toks = _tokens(7, model.cfg, B_, S_)
    gen, logits = serve.generate(model.lm, model.cfg, torch.from_numpy(toks),
                                 4, return_logits=True)
    assert tuple(logits.shape) == (B_, S_ + 3, model.cfg.vocab)
    want = np.asarray(model.jforward(model.jparams, jnp.asarray(toks)))
    assert _err(logits[:, :S_], want) <= MODEL_TOL
    full = _port_logits(model, np.concatenate([toks, gen[:, :3].numpy()],
                                              axis=1))
    assert _err(logits, full.numpy()) <= MODEL_TOL
    assert torch.equal(gen, full[:, S_ - 1:].argmax(-1))
    pre, _ = D.prefill(model.lm, model.cfg, {"tokens": torch.from_numpy(toks)})
    assert _err(pre, want[:, -1]) <= MODEL_TOL
    # the port's decode_step driven as the reference's, int and tensor index
    dec, cache = _port_decode(model, toks)
    assert _err(dec, want) <= MODEL_TOL
    dec_t, _ = _port_decode(model, toks, index_tensor=True)
    assert torch.equal(dec_t, dec)
    assert tuple(cache["seg1"]["attn"]["k"].shape) == (1, B_, 32, 32)
    assert tuple(cache["seg0"]["attn"]["k"].shape) == (B_, META + S_, 32)


def test_cache_spec_matches_reference():
    for cfg, jcfg in ((registry.get(ARCH), jregistry.get(ARCH)),
                      (registry.get_smoke(ARCH), jregistry.get_smoke(ARCH))):
        got = D.cache_spec(cfg, 4, 1183)
        want = JD.cache_spec(jcfg, 4, 1183)
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


# -- the reference's serving faults (ROADMAP.md queue 3) ----------------------

def test_reference_ring_mask_attends_unwritten_slots(model):
    """Fault 1: ``repro/models/decode.py:121`` masks the ring with
    ``max(index, W - 1)``, which is every slot, so until a ring fills each
    window layer attends never-written zero slots. B = 2, S = 48, the meta
    tokens written first: the reference's decode leaves the forward behind
    the meta tokens from the first token on; the port's stays on it."""
    toks = _tokens(8, model.cfg, B_, S_)
    want = np.asarray(model.jforward(model.jparams, jnp.asarray(toks)))
    ref, _ = _jax_decode(model, toks)
    got, _ = _port_decode(model, toks)
    assert _err(got, want) <= MODEL_TOL
    assert _err(ref, want) > FAULT
    assert _first_over(ref, want, FAULT) == 0


def test_reference_prefill_leaves_out_meta_tokens(model):
    """Fault 2: the reference's ``prefill`` (``decode.py:309-318``) runs the
    prompt without the meta tokens that ``lm_loss`` puts before it. B = 2,
    S = 48: its last-token logits are far from the model's; the port's
    prefill equals them."""
    toks = _tokens(9, model.cfg, B_, S_)
    want = np.asarray(model.jforward(model.jparams, jnp.asarray(toks)))[:, -1]
    ref, _ = jax.jit(lambda p, b: JD.prefill(p, model.jcfg, b))(
        model.jparams, {"tokens": jnp.asarray(toks)})
    got, _ = D.prefill(model.lm, model.cfg, {"tokens": torch.from_numpy(toks)})
    assert _err(got, want) <= MODEL_TOL
    assert _err(ref, want) > 100 * FAULT


def test_reference_serve_never_writes_meta_tokens(all_global):
    """Fault 3: the reference's launcher (``launch/serve.py:34``) sizes the
    caches at P + N and decodes from index 0 without writing the meta
    tokens, so ``decode_step``'s slot index + 128 runs off the cache (its
    write is clamped into the last slot). All layers global, so the ring
    mask (fault 1) plays no part: the reference's decode so driven is far
    from the model from the first token on; the port's ``generate``
    equals it."""
    m = all_global
    P, N = S_GLOBAL, 1
    toks = _tokens(10, m.cfg, B_, P)
    ref, _ = _jax_decode(m, toks, prime=False, slots=P + N)
    _, logits = serve.generate(m.lm, m.cfg, torch.from_numpy(toks), N,
                               return_logits=True)
    want = np.asarray(m.jforward(m.jparams, jnp.asarray(toks)))
    assert _err(logits, want) <= MODEL_TOL
    assert _err(ref, want) > 100 * FAULT
    assert _first_over(ref, want, FAULT) == 0


# -- training -----------------------------------------------------------------

def _state(kind="adamw", seed=0):
    jcfg = jregistry.get_smoke(ARCH).replace(dtype=jnp.float32)
    cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32)
    jstate, _ = JTR.make_state(jcfg, JO.OptConfig(kind=kind, lr=LR),
                               key=jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jstate)
    return jcfg, cfg, jstate, convert.train_state_from_jax(tree, cfg, "cpu")


def _leaf_errs(got: list, want_tree) -> list:
    out = []
    for g, w in zip(got, jax.tree.leaves(want_tree)):
        g = np.stack([t.detach().float().numpy() for t in g]) \
            if len(g) > 1 or np.ndim(w) > g[0].dim() else \
            g[0].detach().float().numpy()
        w = np.asarray(w, np.float32)
        out.append((float(np.abs(g.reshape(w.shape) - w).max()),
                    float(np.abs(w).max())))
    return out


def test_gradients_match_reference():
    """Every leaf's gradient, the meta tokens and the Mamba heads' A_log
    and w_dt among them (all nonzero)."""
    jcfg, cfg, jstate, state = _state()
    toks = _tokens(11, cfg, 2, 40)
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b), has_aux=True))(
        jstate["params"], {"tokens": jnp.asarray(toks)})
    grads, loss = TR.make_grad_fn(cfg, global_batch=2)(
        state["params"], {"tokens": torch.from_numpy(toks)})
    assert _rel(loss, want) <= LOSS_TOL
    for err, size in _leaf_errs(grads, jgrads):
        assert err <= GRAD_TOL * max(1e-2, size)
    paths = [p for p, _, _ in reference_leaves(state["params"])]
    for path in (("meta_tokens",), ("segments", "seg2", "ssm", "A_log"),
                 ("segments", "seg1", "ssm", "w_dt")):
        g = grads[paths.index(path)]
        assert all(bool(t.abs().max() > 0) for t in g), path


@pytest.mark.parametrize("kind,microbatches", [("adamw", 1),
                                               ("adafactor", 2)])
def test_train_step_matches_reference(kind, microbatches):
    """Two steps: loss and grad_norm at each, the parameters after the
    last (PARAM_TOL an element, PARAM_REL_TOL of the change). AdamW
    skips the decay of the global layers' [D] norm scales, as the
    reference's ``p.ndim >= 2`` rule does on their unstacked leaves.
    Adafactor runs over two microbatches."""
    jcfg, cfg, jstate, state = _state(kind)
    start = [np.asarray(x, np.float32)
             for x in jax.tree.leaves(jstate["params"])]
    jstep = jax.jit(JTR.make_train_step(
        jcfg, JO.OptConfig(kind=kind, lr=LR), microbatches=microbatches,
        global_batch=2))
    step = TR.make_train_step(cfg, O.OptConfig(kind=kind, lr=LR),
                              microbatches=microbatches, global_batch=2)
    for i in range(2):
        toks = _tokens(20 + i, cfg, 2, 32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        assert _rel(m["loss"], jm["loss"]) <= LOSS_TOL
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
    got = convert.train_state_to_numpy(state)
    off = change = 0.0
    for a, b, c in zip(jax.tree.leaves(got["params"]),
                       jax.tree.leaves(jstate["params"]), start):
        b = np.asarray(b, np.float32)
        assert float(np.abs(a - b).max()) <= PARAM_TOL
        off += float(np.square(a - b).sum())
        change += float(np.square(b - c).sum())
    assert off ** 0.5 <= PARAM_REL_TOL * change ** 0.5
    assert jax.tree.structure(got["opt"]) \
        == jax.tree.structure(jax.tree.map(np.asarray, jstate["opt"]))


def test_train_state_converters_and_digest_round_trip():
    """The state crosses both ways leaf for leaf (the global layers'
    optimizer state unstacked), and its digest is the reference's."""
    jcfg, cfg, jstate, state = _state("adafactor")
    tree = jax.tree.map(np.asarray, jstate)
    back = convert.train_state_to_numpy(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: np.array_equal(np.asarray(a, np.float32),
                                    np.asarray(b, np.float32)), back, tree))
    assert tree_digest(state) == jdigest(jstate)
    assert tuple(state["opt"]["segments"]["seg0"]["ln1"]["scale"]["v"]
                 .shape) == (cfg.d_model,)
    assert tuple(state["opt"]["segments"]["seg1"]["ln1"]["scale"]["v"]
                 .shape) == (1, cfg.d_model)


def test_train_step_lowers_the_loss():
    """As tests/test_arch_smoke.py asks of hymba: three AdamW steps on one
    repeated batch lower the loss (no dead Mamba or meta-token path)."""
    cfg = registry.get_smoke(ARCH)
    opt = O.OptConfig(kind="adamw", lr=2e-3)
    state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    step = TR.make_train_step(cfg, opt, global_batch=2)
    batch = {"tokens": torch.from_numpy(_tokens(12, cfg, 2, 64))}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state["step"]) == 3


# -- launchers ----------------------------------------------------------------

def test_launch_serve_and_train_hymba_on_cpu(tmp_path, capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--new-tokens", "3"])
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=hymba-smoke batch=2 prompt=4 new=3" in out
    assert "arch=hymba-smoke params=" in out and "done" in out


def test_ring_cache_equals_a_full_length_window(model):
    """A sliding-window layer's attention decoded over a ring of
    ``window`` slots (``layers.gqa_apply``: slot index mod W, the slots
    written so far) equals the same layer over a full-length cache with
    the window's mask, at every step past the ring's wrap, with the index
    an int or a 0-d tensor."""
    cfg = model.cfg
    W, Sq, B = cfg.window, 3 * cfg.window + 5, 2
    p = model.lm["segments"]["seg1"][0]["attn"]
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (B, Sq, cfg.d_model)).astype(np.float32))
    kv = cfg.n_kv_heads * cfg.hd
    caches = [{"k": torch.zeros(B, n, kv), "v": torch.zeros(B, n, kv)}
              for n in (Sq, W, W)]
    with torch.no_grad():
        for t in range(Sq):
            pos = torch.full((B, 1), t, dtype=torch.int32)
            full, ring, ring_t = (
                L.gqa_apply(p, cfg, x[:, t:t + 1], pos, window=W,
                            cache=c, cache_index=idx)[0]
                for c, idx in zip(caches, (t, t, torch.tensor(t))))
            assert _err(ring, full) <= MODEL_TOL, t
            assert _err(ring_t, full) <= MODEL_TOL, t
    assert tuple(caches[1]["k"].shape) == (B, W, kv)
