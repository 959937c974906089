"""The port's encoder-decoder family (whisper-small: a bidirectional
encoder over stub frame embeddings, decoder blocks each followed by
cross-attention to the encoder's output, and the cross cache of the
decode step) against the JAX package, on its smoke config (2 encoder and
2 decoder layers, d 64, 4 heads of 16, 64 frames) in f32 on the CPU.

Both packages run the same weights (the reference's ``init_lm`` or
``make_state`` tree, carried to the port through ``convert``) and the
same numpy-made inputs. Tolerances are those of tests/test_torch_moe.py:
layers 2e-5, whole-model hidden states and logits 1e-4, losses 2e-5
relative, gradients 1e-5 times the leaf's largest magnitude (floored at
1e-2); parameters after a train step lr/10 an element and, over the
whole tree in the L2 norm, 1e-3 of the reference's change from the
start. In bf16 the loss is held at 1e-2 relative, as in
tests/test_torch_hymba.py: both packages round the same products to
bf16, in another order.

The model is the one ``lm_loss`` trains: ``encdec_forward`` runs each
decoder layer's block (self-attention, then the MLP) and after it the
cross-attention. The reference's ``decode_step_encdec`` runs the
cross-attention before the MLP, so its decode is not its forward
(ROADMAP.md queue 3); ``test_reference_decode_runs_cross_before_mlp``
shows it. The port's teacher-forced decode equals the reference's
forward.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
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
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import reference_leaves  # noqa: E402
from repro_torch.runtime.checkpoint import (restore_sharded,  # noqa: E402
                                            save_sharded)
from repro_torch.runtime.data import ShardedBatchSource  # noqa: E402
from repro_torch.runtime.statemachine import tree_digest  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

ARCH = "whisper-small"
ROOT = Path(__file__).resolve().parents[1]
# one decoder shape per jitted reference function: B_ x S_ tokens
# against the smoke config's 64 frames
B_, S_ = 2, 12
LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
LOSS_TOL = 2e-5
GRAD_TOL = 1e-5
BF16_LOSS_TOL = 1e-2
LR = 1e-3
PARAM_TOL = LR / 10
PARAM_REL_TOL = 1e-3
# the reference's decode-order fault is far above f32 rounding
FAULT = 1e-3


class Model:
    """The smoke config in f32 in both packages, on the same weights."""

    def __init__(self, seed: int = 0):
        self.jcfg = jregistry.get_smoke(ARCH).replace(dtype=jnp.float32)
        self.cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32)
        self.jparams, _ = JT.init_lm(self.jcfg, jax.random.PRNGKey(seed))
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.lm = convert.lm_params_from_jax(self.tree, self.cfg, "cpu")
        self.jforward = jax.jit(lambda p, f, t: _jax_logits(p, self.jcfg,
                                                            f, t))
        self.jstep = jax.jit(
            lambda p, b, c: JD.decode_step_encdec(p, self.jcfg, b, c))


def _jax_logits(params, jcfg, frames, tokens):
    """The reference's model as ``lm_loss`` runs it: the logits of every
    token position of ``encdec_forward``."""
    hidden, _ = JT.encdec_forward(params, jcfg, frames, tokens)
    return JL.logits_apply(params["embed"], hidden, jcfg.tie_embeddings)


@pytest.fixture(scope="module")
def model():
    return Model()


def _tokens(seed, cfg, B, Sq):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, Sq))


def _frames(seed, cfg, B):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _rel(a, b) -> float:
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def _jax_cross_cache(m, frames, cache):
    """The cross cache as the reference's launcher fills it
    (``repro/launch/serve.py:36-47``): the encoder's memory times each
    layer's wk and wv, stacked over the layers."""
    mem = JT.encoder_forward(m.jparams, m.jcfg, jnp.asarray(frames))
    ks, vs = [], []
    for n in range(m.jcfg.n_layers):
        xp = jax.tree.map(lambda x, n=n: x[n], m.jparams["cross"])
        ks.append(jnp.einsum("bsd,de->bse", mem, xp["attn"]["wk"]))
        vs.append(jnp.einsum("bsd,de->bse", mem, xp["attn"]["wv"]))
    cache["cross"] = {"k": jnp.stack(ks), "v": jnp.stack(vs)}
    return cache


def _jax_decode(m, frames, toks):
    """The reference's ``decode_step_encdec`` driven token by token over
    a cross cache its launcher's way: the logits of every step."""
    B, Sq = toks.shape
    cache = _jax_cross_cache(
        m, frames, JD.cache_zeros(JD.cache_spec(m.jcfg, B, Sq)))
    outs = []
    for t in range(Sq):
        lg, cache = m.jstep(m.jparams, {"token": jnp.asarray(toks[:, t:t + 1]),
                                        "index": jnp.int32(t)}, cache)
        outs.append(np.asarray(lg))
    return np.stack(outs, axis=1)


def _port_decode(m, frames, toks, index_tensor=False):
    """The port's ``decode_step_encdec`` driven as :func:`_jax_decode`
    drives the reference's (``index_tensor``: the index as a 0-d tensor,
    the form a captured step takes). Returns the logits and the cache."""
    B, Sq = toks.shape
    cache = D.cache_zeros(D.cache_spec(m.cfg, B, Sq), "cpu")
    with torch.no_grad():
        mem = T.encoder_forward(m.lm, m.cfg, torch.from_numpy(frames))
    D.fill_cross_cache(m.lm, m.cfg, mem, cache)
    outs = []
    for t in range(Sq):
        idx = torch.tensor(t) if index_tensor else t
        lg, cache = D.decode_step_encdec(m.lm, m.cfg, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "index": idx},
            cache)
        outs.append(lg)
    return torch.stack(outs, dim=1), cache


# -- config, registry, weights ------------------------------------------------

def test_registry_has_the_encdec_config():
    for port, ref in ((registry.get(ARCH), jregistry.get(ARCH)),
                      (registry.get_smoke(ARCH), jregistry.get_smoke(ARCH))):
        assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert port.replace(dtype=None).__dict__ \
            == ref.replace(dtype=None).__dict__
    assert ARCH in registry.ARCHS and ARCH not in registry.NOT_PORTED
    assert registry.NOT_PORTED == {}
    assert registry.microbatches(ARCH, "train_4k") \
        == jregistry.microbatches(ARCH, "train_4k") == 1
    assert sorted(registry.ARCHS) == sorted(jregistry.ARCHS)


def test_tree_layout_leaves_and_converters(model):
    """The port's initialiser draws the reference's tree (``encoder``
    with stacked blocks and an unstacked ``ln``, ``cross`` stacked over
    the decoder layers); ``reference_leaves`` walks it in
    ``jax.tree.flatten`` order; the weights cross both ways leaf for
    leaf; a leaf of the wrong shape or layer count raises."""
    cfg = registry.get_smoke(ARCH)
    assert T.plan_segments(cfg) == JT.plan_segments(jregistry.get_smoke(ARCH))
    lm = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    got = convert.lm_params_to_numpy(lm)
    ref, _ = JT.init_lm(jregistry.get_smoke(ARCH), jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for path, leaf in paths:
        mine = got
        for p in path:
            mine = mine[p.key]
        assert mine.shape == leaf.shape, path
        want = np.asarray(leaf, np.float32)
        if np.all(want == want.flat[0]):           # ones
            assert np.array_equal(mine, want), path
        elif mine.size > 1000:
            assert abs(mine.std() / 0.02 - 1) < 0.05, path
    assert lm.keys() == ["embed", "ln_f", "segments", "encoder", "cross"]
    leaves = reference_leaves(lm)
    assert [p for p, _, _ in leaves] == [
        tuple(k.key for k in p) for p, _ in paths]
    stacked = {p[:2] for p, _, st in leaves if st}
    assert stacked == {("cross", "attn"), ("cross", "ln"),
                       ("encoder", "blocks"), ("segments", "seg0")}
    assert [len(ts) for p, ts, st in leaves if p[0] == "cross"] \
        == [cfg.n_layers] * 5
    assert not any(st for p, _, st in leaves if p[:2] == ("encoder", "ln"))
    back = convert.lm_params_to_numpy(model.lm)
    assert jax.tree.all(jax.tree.map(np.array_equal, model.tree, back))
    for mutate, match in (
            (lambda t: t["cross"]["attn"].update(
                wk=t["cross"]["attn"]["wk"][:, :-1]), r"cross\[0\].attn.wk"),
            (lambda t: t["encoder"]["blocks"]["mlp"].update(
                w_up=t["encoder"]["blocks"]["mlp"]["w_up"][:1]),
             "encoder.blocks: 2 layers"),
            (lambda t: t["encoder"].pop("ln"), "encoder: keys")):
        bad = jax.tree.map(lambda x: x, model.tree)
        mutate(bad)
        with pytest.raises(ValueError, match=match):
            convert.lm_params_from_jax(bad, model.cfg, "cpu")


# -- the model: blocks, encoder, forward, loss --------------------------------

def test_bidirectional_block_matches_reference(model):
    """An encoder block (``block_apply(causal=False)``: q and k rotated by
    the frame index, every frame visible, the flash path's plain version
    on the CPU) against the reference's ``_gqa_maybe_noncausal`` branch;
    the causal block differs from it, and a bidirectional decode raises."""
    jl = jax.tree.map(lambda x: x[0], model.jparams["encoder"]["blocks"])
    tl = model.lm["encoder"]["blocks"][0]
    x = _frames(1, model.cfg, B_)
    pos = np.broadcast_to(np.arange(x.shape[1]), x.shape[:2]).copy()
    want, _, _ = jax.jit(lambda p, xx, pp: JT.block_apply(
        p, model.jcfg, xx, pp, moe=False, window=-1, causal=False))(
        jl, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got, _, _ = T.block_apply(tl, model.cfg, torch.from_numpy(x),
                                  torch.from_numpy(pos), moe=False,
                                  window=-1, causal=False)
        causal, _, _ = T.block_apply(tl, model.cfg, torch.from_numpy(x),
                                     torch.from_numpy(pos), moe=False,
                                     window=-1)
    assert _err(got, want) <= LAYER_TOL
    assert _err(causal, want) > FAULT
    kv = model.cfg.n_kv_heads * model.cfg.hd
    cache = {"k": torch.zeros(B_, 4, kv), "v": torch.zeros(B_, 4, kv)}
    with pytest.raises(ValueError, match="bidirectional"):
        L.gqa_apply(tl["attn"], model.cfg, torch.from_numpy(x[:, :1]),
                    torch.zeros((B_, 1), dtype=torch.int32), window=-1,
                    cache=cache, cache_index=0, causal=False)


def test_encdec_forward_matches_reference(model):
    """``encoder_forward`` (the memory) and ``encdec_forward`` (the
    decoder's hidden states, in the reference's sublayer order) and their
    logits, f32."""
    frames, toks = _frames(2, model.cfg, B_), _tokens(2, model.cfg, B_, S_)
    jhidden, jmem = jax.jit(lambda p, f, t: JT.encdec_forward(
        p, model.jcfg, f, t))(model.jparams, jnp.asarray(frames),
                              jnp.asarray(toks))
    with torch.no_grad():
        mem = T.encoder_forward(model.lm, model.cfg, torch.from_numpy(frames))
        hidden, mem2 = T.encdec_forward(model.lm, model.cfg,
                                        torch.from_numpy(frames),
                                        torch.from_numpy(toks))
        logits = L.logits_apply(model.lm["embed"],
                                model.lm(torch.from_numpy(toks),
                                         torch.from_numpy(frames)),
                                model.cfg.tie_embeddings)
    assert _err(mem, jmem) <= MODEL_TOL and torch.equal(mem, mem2)
    assert _err(hidden, jhidden) <= MODEL_TOL
    want = np.asarray(model.jforward(model.jparams, jnp.asarray(frames),
                                     jnp.asarray(toks)))
    assert _err(logits, want) <= MODEL_TOL


def test_lm_loss_bf16_matches_reference():
    """The smoke config in bf16 (its registry dtype): ``lm_loss``, which
    runs ``encdec_forward`` in bf16, against the reference's."""
    jcfg = jregistry.get_smoke(ARCH)
    cfg = registry.get_smoke(ARCH)
    jparams, _ = JT.init_lm(jcfg, jax.random.PRNGKey(4))
    lm = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    frames, toks = _frames(5, cfg, B_), _tokens(5, cfg, B_, S_)
    want, _ = jax.jit(lambda p, b: JT.lm_loss(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    with torch.no_grad():
        got, m = T.lm_loss(lm, cfg, {"tokens": torch.from_numpy(toks),
                                     "frames": torch.from_numpy(frames)})
    assert _rel(got, want) <= BF16_LOSS_TOL
    assert float(m["aux"]) == 0.0


def _state(kind="adamw", seed=0):
    jcfg = jregistry.get_smoke(ARCH).replace(dtype=jnp.float32)
    cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32)
    jstate, _ = JTR.make_state(jcfg, JO.OptConfig(kind=kind, lr=LR),
                               key=jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jstate)
    return jcfg, cfg, jstate, convert.train_state_from_jax(tree, cfg, "cpu")


def _batches(seed, cfg):
    frames, toks = _frames(seed, cfg, B_), _tokens(seed, cfg, B_, S_)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})


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


def test_lm_loss_and_gradients_match_reference(model):
    """``lm_loss`` and every leaf's gradient (the encoder's and the
    cross-attention's nonzero: the memory reaches the loss through every
    layer's cross-attention)."""
    jcfg, cfg, params = model.jcfg, model.cfg, model.lm
    jb, tb = _batches(11, cfg)
    (want, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b), has_aux=True))(
        model.jparams, jb)
    with torch.no_grad():
        got, m = T.lm_loss(params, cfg, tb)
    assert _rel(got, want) <= LOSS_TOL and _rel(m["ce"], jm["ce"]) <= LOSS_TOL
    grads, loss = TR.make_grad_fn(cfg, global_batch=B_)(params, tb)
    assert _rel(loss, want) <= LOSS_TOL
    errs = _leaf_errs(grads, jgrads)
    assert len(errs) == len(jax.tree.leaves(jgrads))
    for err, size in errs:
        assert err <= GRAD_TOL * max(1e-2, size)
    paths = [p for p, _, _ in reference_leaves(params)]
    for path, g in zip(paths, grads):
        if path[0] in ("encoder", "cross"):
            assert all(bool(t.abs().max() > 0) for t in g), path


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("B", [2, 8])
def test_prefill_matches_reference(model, B):
    """``prefill``'s last-token logits against the reference's; B = 8 runs
    4 chunks of 2 rows, frames taken on axis 0 with the tokens."""
    frames, toks = _frames(20 + B, model.cfg, B), _tokens(20 + B, model.cfg,
                                                          B, S_)
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    want, _ = jax.jit(lambda p, b: JD.prefill(p, model.jcfg, b))(
        model.jparams, batch)
    got, cache = D.prefill(model.lm, model.cfg, {
        "tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
    assert cache is None and tuple(got.shape) == (B, model.cfg.vocab)
    assert _err(got, want) <= MODEL_TOL
    if B == 8:
        whole, _ = D.prefill(model.lm, model.cfg, {
            "tokens": torch.from_numpy(toks),
            "frames": torch.from_numpy(frames)}, batch_chunks=1)
        assert _err(got, whole.numpy()) <= MODEL_TOL


def test_cache_spec_and_cross_cache_match_reference(model):
    """``cache_spec`` of the full and smoke configs (``"cross"`` k/v
    [n, B, T, K·h]), and the cross cache that ``fill_cross_cache`` writes
    against the reference launcher's einsum stack."""
    for cfg, jcfg in ((registry.get(ARCH), jregistry.get(ARCH)),
                      (registry.get_smoke(ARCH), jregistry.get_smoke(ARCH))):
        got = D.cache_spec(cfg, 4, 1056)
        want = JD.cache_spec(jcfg, 4, 1056)
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
    assert got["cross"]["k"][0] == (2, 4, 64, 64)
    frames = _frames(3, model.cfg, B_)
    jcache = _jax_cross_cache(model, frames, {})
    _, cache = _port_decode(model, frames, _tokens(3, model.cfg, B_, 1))
    for k in ("k", "v"):
        assert _err(cache["cross"][k], jcache["cross"][k]) <= MODEL_TOL


def test_generate_matches_reference_forward(model):
    """``serve.generate`` with the frames, teacher-forced over S_ tokens
    and 3 greedy steps: its logits at every prompt position equal the
    reference's forward (``encdec_forward``, the model ``lm_loss``
    trains), at the greedy ones the port's own forward; its prefill
    equals the prompt's last; ``decode_step_encdec`` with the index as
    an int and as a 0-d tensor gives the same logits."""
    frames, toks = _frames(7, model.cfg, B_), _tokens(7, model.cfg, B_, S_)
    gen, logits = serve.generate(model.lm, model.cfg, torch.from_numpy(toks),
                                 3, frames=torch.from_numpy(frames),
                                 return_logits=True)
    assert tuple(logits.shape) == (B_, S_ + 2, model.cfg.vocab)
    want = np.asarray(model.jforward(model.jparams, jnp.asarray(frames),
                                     jnp.asarray(toks)))
    assert _err(logits[:, :S_], want) <= MODEL_TOL
    with torch.no_grad():
        full = L.logits_apply(model.lm["embed"], model.lm(
            torch.cat([torch.from_numpy(toks), gen[:, :2]], dim=1),
            torch.from_numpy(frames)), model.cfg.tie_embeddings)
    assert _err(logits, full.numpy()) <= MODEL_TOL
    assert torch.equal(gen, full[:, S_ - 1:].argmax(-1))
    pre, _ = D.prefill(model.lm, model.cfg, {
        "tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
    assert _err(pre, want[:, -1]) <= MODEL_TOL
    dec, _ = _port_decode(model, frames, toks)
    dec_t, _ = _port_decode(model, frames, toks, index_tensor=True)
    assert _err(dec, want) <= MODEL_TOL and torch.equal(dec_t, dec)
    with pytest.raises(ValueError, match="frames"):
        serve.generate(model.lm, model.cfg, torch.from_numpy(toks), 1)
    with pytest.raises(ValueError, match="decode_step_encdec"):
        D.decode_step(model.lm, model.cfg, {
            "token": torch.from_numpy(toks[:, :1]), "index": 0},
            D.cache_zeros(D.cache_spec(model.cfg, B_, 1), "cpu"))


# -- the reference's decode-order fault (ROADMAP.md queue 3) ------------------

def _jax_decode_order_logits(params, jcfg, frames, tokens):
    """A forward in the order of the reference's ``block_decode`` with a
    cross cache: per layer self-attention, then cross-attention, then
    the MLP."""
    B, Sq = tokens.shape
    mem = JT.encoder_forward(params, jcfg, frames)
    x = JL.embed_apply(params["embed"], tokens)
    pos = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))
    H, K, hd = jcfg.n_heads, jcfg.n_kv_heads, jcfg.hd
    for n in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a, n=n: a[n], params["segments"]["seg0"])
        xp = jax.tree.map(lambda a, n=n: a[n], params["cross"])
        a, _ = JL.gqa_apply(lp["attn"], jcfg,
                            JL.rmsnorm(lp["ln1"], x, jcfg.norm_eps), pos,
                            window=-1)
        x = x + a
        h = JL.rmsnorm(xp["ln"], x, jcfg.norm_eps)
        q = (h @ xp["attn"]["wq"]).reshape(B, Sq, H, hd)
        k = (mem @ xp["attn"]["wk"]).reshape(B, -1, K, hd)
        v = (mem @ xp["attn"]["wv"]).reshape(B, -1, K, hd)
        o = JL.attend(q, k, v, jnp.ones((Sq, k.shape[1]), jnp.bool_))
        x = x + o.reshape(B, Sq, H * hd) @ xp["attn"]["wo"]
        x = x + JL.mlp_apply(lp["mlp"], JL.rmsnorm(lp["ln2"], x,
                                                  jcfg.norm_eps))
    hidden = JL.rmsnorm(params["ln_f"], x, jcfg.norm_eps)
    return JL.logits_apply(params["embed"], hidden, jcfg.tie_embeddings)


def test_reference_decode_runs_cross_before_mlp(model):
    """The reference's ``decode_step_encdec`` (``block_decode``,
    ``repro/models/decode.py:157-168``) runs cross-attention before the
    MLP, while ``encdec_forward`` (its ``lm_loss`` and ``prefill``) runs
    it after. B = 1, S = 1, the cross cache filled as its launcher fills
    it: its decode is off its forward from the first logit on and equals
    a forward in the decode's order; the port's ``generate`` equals the
    forward."""
    rng = np.random.default_rng(0)
    tok = rng.integers(0, model.cfg.vocab, (1, 1))
    frames = rng.standard_normal((1, model.cfg.encoder_len,
                                  model.cfg.d_model)).astype(np.float32)
    ref = _jax_decode(model, frames, tok)
    fwd = np.asarray(model.jforward(model.jparams, jnp.asarray(frames),
                                    jnp.asarray(tok)))
    order = np.asarray(jax.jit(lambda p, f, t: _jax_decode_order_logits(
        p, model.jcfg, f, t))(model.jparams, jnp.asarray(frames),
                              jnp.asarray(tok)))
    assert _err(ref, fwd) > FAULT
    assert abs(float(ref[0, 0, 0]) - float(fwd[0, 0, 0])) > FAULT
    assert _err(ref, order) <= 1e-5
    _, logits = serve.generate(model.lm, model.cfg, torch.from_numpy(tok), 1,
                               frames=torch.from_numpy(frames),
                               return_logits=True)
    assert _err(logits, fwd) <= MODEL_TOL


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_step_matches_reference(kind):
    """The train state crosses both ways leaf for leaf with the
    reference's digest; then one step against the reference's
    ``make_train_step``: loss and grad_norm, the parameters after it
    (PARAM_TOL an element, PARAM_REL_TOL of the change), the optimizer
    state's layout."""
    jcfg, cfg, jstate, state = _state(kind)
    tree = jax.tree.map(np.asarray, jstate)
    again = convert.train_state_to_numpy(state)
    assert jax.tree.structure(again) == jax.tree.structure(tree)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: np.array_equal(np.asarray(a, np.float32),
                                    np.asarray(b, np.float32)), again, tree))
    assert tree_digest(state) == jdigest(jstate)
    start = [np.asarray(x, np.float32)
             for x in jax.tree.leaves(jstate["params"])]
    jstep = jax.jit(JTR.make_train_step(
        jcfg, JO.OptConfig(kind=kind, lr=LR), microbatches=1,
        global_batch=B_))
    step = TR.make_train_step(cfg, O.OptConfig(kind=kind, lr=LR),
                              global_batch=B_)
    jb, tb = _batches(30, cfg)
    jstate, jm = jstep(jstate, jb)
    state, m = step(state, tb)
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


def test_train_step_lowers_the_loss(tmp_path):
    """As tests/test_arch_smoke.py asks of whisper: three AdamW steps on
    one repeated batch (``ShardedBatchSource`` frames, two microbatches
    cut on the batch axis) lower the loss; the state, encoder and cross
    trees included, goes through the quorum-committed checkpoint into a
    fresh one with the same digest."""
    cfg = registry.get_smoke(ARCH)
    opt = O.OptConfig(kind="adamw", lr=2e-3)
    state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    step = TR.make_train_step(cfg, opt, microbatches=2, global_batch=4)
    batch = ShardedBatchSource(cfg.vocab, 4, 32, seed=3, device="cpu",
                               d_model=cfg.d_model,
                               encoder_len=cfg.encoder_len).batch(0)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state["step"]) == 3
    man = save_sharded(state, str(tmp_path), 3)
    assert man["committed"]
    fresh = TR.make_state(cfg, opt, torch.Generator().manual_seed(1), "cpu")
    assert tree_digest(fresh) != tree_digest(state)
    fresh, got = restore_sharded(fresh, str(tmp_path))
    assert got["step"] == 3 and tree_digest(fresh) == tree_digest(state)


def test_sharded_batch_source_frames():
    """``frames`` [B, encoder_len, D] f32, a pure function of (seed,
    index), beside the tokens; none without ``encoder_len``; the train
    step's microbatch split cuts them on the batch axis."""
    src = ShardedBatchSource(512, 4, 8, seed=5, device="cpu", d_model=64,
                             encoder_len=64)
    b = src.batch(3)
    assert set(b) == {"tokens", "frames"}
    assert tuple(b["frames"].shape) == (4, 64, 64)
    assert b["frames"].dtype == torch.float32
    assert torch.equal(b["frames"], src.batch(3)["frames"])
    assert not torch.equal(b["frames"], src.batch(4)["frames"])
    assert "frames" not in ShardedBatchSource(512, 4, 8, device="cpu") \
        .batch(0)
    parts = TR._split_microbatch(b["frames"], 2, 4)
    assert tuple(parts.shape) == (2, 2, 64, 64)
    assert torch.equal(parts[1], b["frames"][2:])


# -- launchers and the example ------------------------------------------------

def test_launchers_and_example_on_cpu(tmp_path, capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--new-tokens", "3"])
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path)])
    spec = importlib.util.spec_from_file_location(
        "torch_serve_example", ROOT / "examples" / "torch_serve_engine.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gen = mod.main(["--arch", ARCH, "--device", "cpu", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=whisper-smoke batch=2 prompt=4 new=3" in out
    assert "arch=whisper-smoke params=" in out and "done" in out
    assert tuple(gen.shape) == (2, 4)
    assert f"{ARCH}: prompt" in out and "generated 4 tokens/seq" in out
