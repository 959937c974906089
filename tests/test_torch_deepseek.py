"""The port's deepseek-v3 family (multi-head latent attention with its
compressed cache and absorbed decode, a dense prefix before top-k MoE
layers with a shared expert, and the MTP head) against the JAX package,
on its smoke config (1 dense and 3 MoE layers, d 128, 4 heads, q/k width
32 + 16, v width 32, latent 32, 8 experts at top-2) in f32 on the CPU.

Both packages run the same weights (the reference's ``init_lm`` or
``make_state`` tree, carried to the port through ``convert``) and the
same numpy-made inputs; each reference result that several tests read is
computed once, in a module-scoped fixture. Tolerances: the MLA layer
1e-5 against the reference, the port's absorbed decode 1e-6 against its
own full attention (the same function in another order of f32 sums);
whole-model logits 1e-4; losses 1e-5 relative; gradients 1e-5 times the
leaf's largest magnitude (floored at 1e-2), the rule of
tests/test_torch_train.py; parameters after an AdamW step 2·lr + 1e-6
(its first step is lr·sign(g)). In f32 the routing is held exactly.

The reference's MLA with a cache and more than one token masks every
query row at the chunk's first slot, so a chunk's rows after the first
miss their own keys (ROADMAP.md queue 3);
``test_reference_mla_cached_chunk_is_not_causal`` shows it. The port
masks each row causally. No serving path of either package writes a
chunk into the cache.
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
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.models.common import ParamFactory as JParamFactory  # noqa: E402
from repro.models.common import split_tree  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.common import reference_leaves  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

ARCH = "deepseek-v3-671b"
LAYER_TOL = 1e-5
ABSORBED_TOL = 1e-6
MODEL_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
LR = 1e-3
# the reference's cached-chunk fault is far above f32 rounding
FAULT = 1e-3
B_, S_ = 2, 16              # the loss and gradient batch


class Model:
    """The smoke config in f32 in both packages, on the same weights: the
    reference's tree (``init_lm``'s layout and logical axes, abstract)
    drawn with numpy, every norm scale 1 + N(0, 0.1) so that each is
    exercised, each router N(0, 0.006), every other leaf N(0, 0.02)."""

    def __init__(self, seed: int = 0):
        self.jcfg = jregistry.get_smoke(ARCH).replace(dtype=jnp.float32)
        self.cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32)
        shapes, self.jaxes = JT.init_lm(self.jcfg, jax.random.PRNGKey(seed),
                                        abstract=True)
        rng = np.random.default_rng(seed)

        def draw(path, leaf):
            name = path[-1].key
            x = rng.standard_normal(leaf.shape).astype(np.float32)
            if name == "scale":
                return 1 + np.float32(0.1) * x
            return np.float32(0.006 if name == "router" else 0.02) * x
        self.tree = jax.tree_util.tree_map_with_path(draw, shapes)
        self.jparams = jax.tree.map(jnp.asarray, self.tree)
        self.lm = convert.lm_params_from_jax(self.tree, self.cfg, "cpu")
        self.jstep = jax.jit(
            lambda p, b, c: JD.decode_step(p, self.jcfg, b, c))

    def attn(self) -> dict:
        """The dense layer's MLA parameters as numpy."""
        return jax.tree.map(lambda x: x[0],
                            self.tree["segments"]["seg0"]["attn"])


@pytest.fixture(scope="module")
def model():
    return Model()


def _tokens(seed, cfg, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _rand(seed, *shape, mean=0.0):
    return (mean + np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def loss_ref(model):
    """The reference's loss, metrics and gradients of one batch of B_ x
    S_ tokens, through ``jax.value_and_grad`` of its ``lm_loss``."""
    toks = _tokens(1, model.cfg, B_, S_)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, model.jcfg, b), has_aux=True))(
        model.jparams, {"tokens": jnp.asarray(toks)})
    return toks, float(loss), {k: float(v) for k, v in metrics.items()}, \
        grads


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _rel(a, b) -> float:
    a, b = (t.detach() if isinstance(t, torch.Tensor) else t for t in (a, b))
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def _torch_params(p: dict, dtype=torch.float32) -> dict:
    return {k: _torch_params(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in p.items()}


def _positions(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S))


def _leaf_errs(got: list, want_tree) -> list:
    """max |got - want| per reference leaf, and the leaf's max |want|."""
    out = []
    for g, w in zip(got, jax.tree.leaves(want_tree)):
        g = np.stack([t.detach().float().numpy() for t in g]) \
            if len(g) > 1 or np.ndim(w) > g[0].dim() else \
            g[0].detach().float().numpy()
        w = np.asarray(w, np.float32)
        out.append((float(np.abs(g.reshape(w.shape) - w).max()),
                    float(np.abs(w).max())))
    return out


# -- config, plan, layout -----------------------------------------------------

def test_registry_has_the_deepseek_config():
    """Every architecture of the reference is ported: the full and smoke
    configs equal the reference's field by field, NOT_PORTED is empty."""
    for port, ref in ((registry.get(ARCH), jregistry.get(ARCH)),
                      (registry.get_smoke(ARCH), jregistry.get_smoke(ARCH))):
        assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert port.replace(dtype=None).__dict__ \
            == ref.replace(dtype=None).__dict__
    assert ARCH in registry.ARCHS and registry.NOT_PORTED == {}
    assert registry.microbatches(ARCH, "train_4k") \
        == jregistry.microbatches(ARCH, "train_4k") == 16


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_plan_and_cache_spec_match_reference(which):
    """A scanned segment of the dense prefix, then one of the MoE layers;
    the compressed cache {c_kv [n, B, L, kvr], k_rope [n, B, L, dr]} of
    each."""
    cfg = (registry.get_smoke if which == "smoke" else registry.get)(ARCH)
    jcfg = (jregistry.get_smoke if which == "smoke" else jregistry.get)(ARCH)
    assert T.plan_segments(cfg) == JT.plan_segments(jcfg)
    assert [s["n"] for s in T.plan_segments(cfg)] == [
        cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers]
    got = D.cache_spec(cfg, 4, 1056)
    want = JD.cache_spec(jcfg, 4, 1056)
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[0], tuple))[0]
    assert len(flat) == 4
    for path, (shape, dtype) in flat:
        mine = got
        for p in path:
            mine = mine[p.key]
        assert mine[0] == shape
        assert str(mine[1]).split(".")[-1] == jnp.dtype(dtype).name


def test_weights_cross_both_ways_with_the_mtp_head(model):
    """The reference's tree (two segments, ``mtp`` with one unstacked
    block) to the port and back, in f32 and in bf16 (native bytes); the
    Adafactor train state in the reference's layout both ways; the
    port's initialiser draws the same layout, and ``reference_leaves``
    walks it in ``jax.tree.flatten`` order."""
    back = convert.lm_params_to_numpy(model.lm)
    assert jax.tree.all(jax.tree.map(np.array_equal, model.tree, back))
    assert back["mtp"]["proj"].shape == (256, 128)
    assert back["mtp"]["block"]["attn"]["wkv_a"].shape == (128, 32 + 16)
    assert back["segments"]["seg1"]["moe"]["w_gate"].shape == (3, 8, 128, 64)
    cfg = registry.get_smoke(ARCH)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        model.tree)
    native = convert.lm_params_to_numpy(
        convert.lm_params_from_jax(tree, cfg, "cpu"), native=True)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.tobytes() == b.tobytes() and a.shape == b.shape,
        tree, native))
    opt = O.OptConfig(kind="adafactor", lr=LR)
    state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    mine = convert.train_state_to_numpy(state)
    jopt, _ = JO.init_opt(JO.OptConfig(kind="adafactor", lr=LR),
                          model.jparams, model.jaxes)
    assert jax.tree.map(np.shape, mine["params"]) \
        == jax.tree.map(np.shape, model.tree)
    assert jax.tree.map(np.shape, mine["opt"]) == jax.tree.map(np.shape,
                                                               jopt)
    again = convert.train_state_to_numpy(
        convert.train_state_from_jax(mine, cfg, "cpu"))
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.tobytes() == b.tobytes(), mine, again))
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(model.tree)[0]]
    assert [p for p, _, _ in reference_leaves(model.lm)] == paths


# -- MLA ----------------------------------------------------------------------

def test_mla_prefill_is_one_flash_call_at_mla_scale(model):
    """S = 16 (the reference's direct softmax): one causal call of the
    flash entry point with q and k [B,S,H,dn+dr] and v [B,S,H,dv], all
    contiguous; its output is the softmax at scale 1/sqrt(dn+dr) computed
    here from the same q, k and v, and the layer equals the reference's
    within 1e-5."""
    cfg, jcfg = model.cfg, model.jcfg
    p = model.attn()
    x = _rand(3, 2, 16, 128)
    pos = _positions(2, 16).copy()
    want, _ = jax.jit(lambda pp, xx, ps: JL.mla_apply(pp, jcfg, xx, ps))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos))
    calls, real = [], ops.attention

    def record(q, k, v, **kw):
        out = real(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    ops.attention = record
    try:
        got, cache = L.mla_apply(_torch_params(p), cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    finally:
        ops.attention = real
    assert cache is None and _err(got, want) < LAYER_TOL
    ((q, k, v, kw, out),) = calls
    dn, dr, dv, H = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, \
        cfg.n_heads
    assert kw == {"causal": True}
    assert tuple(q.shape) == tuple(k.shape) == (2, 16, H, dn + dr)
    assert tuple(v.shape) == (2, 16, H, dv)
    assert all(t.is_contiguous() for t in (q, k, v))
    # the shared rope key is the same in every head
    assert torch.equal(k[..., dn:], k[:, :, :1, dn:].expand_as(k[..., dn:]))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dn + dr)
    s = s.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(), -1e30)
    direct = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert _err(out, direct.numpy()) < 1e-6


def test_mla_prefill_matches_reference_flash_branch(model):
    """B = 1, S = 1,024: the reference takes its blockwise
    ``flash_attend``; the port the same flash entry point as at any S."""
    p = model.attn()
    x = _rand(4, 1, 1024, 128)
    pos = _positions(1, 1024).copy()
    want, _ = jax.jit(lambda pp, xx, ps: JL.mla_apply(pp, model.jcfg, xx,
                                                      ps))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos))
    got, _ = L.mla_apply(_torch_params(p), model.cfg, torch.from_numpy(x),
                         torch.from_numpy(pos))
    assert _err(got, want) < LAYER_TOL


def test_absorbed_decode_matches_full_attention_and_reference(model):
    """Ten single-token steps into a 12-slot cache (the last two slots
    masked at every step): each step's output equals the port's
    full-sequence attention's row (1e-6) and the reference's absorbed
    step (1e-5); the caches after the last step agree; a 0-d index
    tensor gives the same bytes as the int."""
    cfg, jcfg = model.cfg, model.jcfg
    p = model.attn()
    tp, jp = _torch_params(p), jax.tree.map(jnp.asarray, p)
    B, S, Lc = 2, 10, 12
    x = torch.from_numpy(_rand(5, B, S, 128))
    pos = torch.from_numpy(_positions(B, S).copy())
    full, _ = L.mla_apply(tp, cfg, x, pos)
    spec = L.mla_cache_spec(cfg, B, Lc)
    cache = {k: torch.zeros(s, dtype=torch.float32) for k, (s, _)
             in spec.items()}
    cache_t = {k: v.clone() for k, v in cache.items()}
    jcache = {k: jnp.zeros(s, jnp.float32) for k, (s, _)
              in JL.mla_cache_spec(jcfg, B, Lc).items()}
    jstep = jax.jit(lambda c, xx, ps, i: JL.mla_apply(
        jp, jcfg, xx, ps, cache=c, cache_index=i))
    for t in range(S):
        y, cache = L.mla_apply(tp, cfg, x[:, t:t + 1], pos[:, t:t + 1],
                               cache=cache, cache_index=t)
        yt, _ = L.mla_apply(tp, cfg, x[:, t:t + 1], pos[:, t:t + 1],
                            cache=cache_t, cache_index=torch.tensor(t))
        jy, jcache = jstep(jcache, jnp.asarray(x[:, t:t + 1].numpy()),
                           jnp.asarray(pos[:, t:t + 1].numpy()),
                           jnp.int32(t))
        assert _err(y, full[:, t:t + 1].detach()) < ABSORBED_TOL
        assert _err(y, jy) < LAYER_TOL
        assert torch.equal(y, yt)
    for k in ("c_kv", "k_rope"):
        assert _err(cache[k], jcache[k]) < LAYER_TOL
        assert torch.equal(cache[k], cache_t[k])
        assert float(cache[k][:, S:].abs().max()) == 0.0


def _arch_smoke_mla():
    """The MLA layer of the reference's
    tests/test_arch_smoke.py::test_mla_absorbed_decode_matches_full_attention:
    d 64, 4 heads, q/k 16 + 8, v 16, latent 16, q rank 32; weights of
    ``PRNGKey(0)``."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=100, attn_kind="mla",
              q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
              qk_nope_dim=16, v_head_dim=16, head_dim=16)
    jcfg = JModelConfig(**kw, dtype=jnp.float32)
    cfg = ModelConfig(**kw, dtype=torch.float32)
    jp, _ = split_tree(JL.init_mla(JParamFactory(jax.random.PRNGKey(0),
                                                 dtype=jnp.float32), jcfg))
    return jcfg, cfg, jp


def test_reference_mla_cached_chunk_is_not_causal():
    """ROADMAP.md queue 3. B = 2, S = 4 written at cache_index 0 into a
    4-slot cache, x of ``PRNGKey(1)``: the reference's rows 1-3 see only
    slot 0 and differ from its full-sequence attention (first element off
    by more than 1e-5: [b 0, t 1, d 0], 0.001751651 against
    -0.000109428); the port's chunk equals its full attention, and so
    does a second chunk written at index 4 after the first."""
    jcfg, cfg, jp = _arch_smoke_mla()
    tp = _torch_params(jax.tree.map(np.asarray, jp))
    B, S = 2, 4
    x = jax.random.normal(jax.random.PRNGKey(1), (B, S, 64), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    jcache = {"c_kv": jnp.zeros((B, S, 16)), "k_rope": jnp.zeros((B, S, 8))}
    jfull, jchunk = jax.jit(lambda c: (
        JL.mla_apply(jp, jcfg, x, pos)[0],
        JL.mla_apply(jp, jcfg, x, pos, cache=c, cache_index=0)[0]))(jcache)
    diff = np.abs(np.asarray(jchunk) - np.asarray(jfull))
    assert diff[:, 0].max() < 1e-6
    assert min(diff[:, t].max() for t in (1, 2, 3)) > FAULT
    first = tuple(np.argwhere(diff > 1e-5)[0])
    assert first == (0, 1, 0)
    assert abs(float(jchunk[first]) - 0.001751651) < 1e-6
    assert abs(float(jfull[first]) + 0.000109428) < 1e-6
    # the port: full attention equals the reference's, the chunk is causal
    xt, post = torch.from_numpy(np.array(x)), torch.from_numpy(
        np.array(pos))
    full, _ = L.mla_apply(tp, cfg, xt, post)
    assert _err(full, jfull) < LAYER_TOL
    cache = {"c_kv": torch.zeros(B, 2 * S, 16),
             "k_rope": torch.zeros(B, 2 * S, 8)}
    chunk, _ = L.mla_apply(tp, cfg, xt, post, cache=cache, cache_index=0)
    assert _err(chunk, full.detach()) < ABSORBED_TOL
    x2 = torch.from_numpy(_rand(6, B, S, 64))
    xx, pp = torch.cat([xt, x2], 1), torch.arange(2 * S)[None].expand(B, -1)
    full2, _ = L.mla_apply(tp, cfg, xx, pp)
    chunk2, _ = L.mla_apply(tp, cfg, x2, pp[:, S:], cache=cache,
                            cache_index=torch.tensor(S))
    assert _err(chunk2, full2[:, S:].detach()) < ABSORBED_TOL


# -- the MoE at top-8 ---------------------------------------------------------

@pytest.mark.parametrize("case", ["balanced", "forced_drops"])
def test_moe_apply_top8_with_shared_expert(case):
    """k = 8 of 16 experts with a shared expert (deepseek-v3 routes 8 of
    256): y and aux against the reference, the gates renormalised over
    each token's 8 choices, every choice's expert the reference's top-8
    in order. ``forced_drops`` biases router columns 0-7 and feeds inputs
    of mean 1, so that experts 0-7 overflow their capacity."""
    jcfg = jregistry.get_smoke(ARCH).replace(
        dtype=jnp.float32, n_experts=16, experts_per_token=8)
    cfg = registry.get_smoke(ARCH).replace(
        dtype=torch.float32, n_experts=16, experts_per_token=8)
    rng = np.random.default_rng(7)

    def draw(*shape, scale=0.02):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    D_, F_ = cfg.d_model, cfg.moe_d_ff
    p = {"router": draw(D_, 16, scale=0.006), "w_gate": draw(16, D_, F_),
         "w_up": draw(16, D_, F_), "w_down": draw(16, F_, D_),
         "shared": {"w_gate": draw(D_, F_), "w_up": draw(D_, F_),
                    "w_down": draw(F_, D_)}}
    x = _rand(8, 2, 16, 128, mean=1.0 if case == "forced_drops" else 0.0)
    if case == "forced_drops":
        p = dict(p, router=p["router"].copy())
        p["router"][:, :8] += 0.05
    want, jaux = jax.jit(lambda pp, xx: JL.moe_apply(pp, jcfg, xx))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    routes, real = [], L.moe_route
    L.moe_route = lambda *a: routes.append(real(*a)) or routes[-1]
    try:
        got, aux = L.moe_apply(_torch_params(p), cfg, torch.from_numpy(x))
    finally:
        L.moe_route = real
    assert _err(got, want) < LAYER_TOL
    assert _rel(aux, jaux) <= LOSS_TOL and float(aux) > 0
    (r,) = routes
    assert r.capacity == JL.moe_capacity(32, jcfg) == 24
    assert r.expert.shape == (256,)
    assert torch.allclose(r.gate.sum(-1), torch.ones(32))
    logits = np.asarray(x).reshape(32, 128) @ p["router"]
    order = np.argsort(-logits, axis=-1, kind="stable")[:, :8]
    assert np.array_equal(r.expert.reshape(32, 8).numpy(), order)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (case == "forced_drops")


# -- the model ----------------------------------------------------------------

def test_lm_loss_matches_reference(model, loss_ref):
    """ce, aux (summed over the 3 MoE layers), the MTP term and the total
    ce + 0.3·mtp + 0.01·aux, with grad enabled (every block, the MTP
    block's too, under checkpoint) and without."""
    toks, want, jm, _ = loss_ref
    batch = {"tokens": torch.from_numpy(toks)}
    got, m = T.lm_loss(model.lm, model.cfg, batch)
    assert set(m) == set(jm) == {"ce", "aux", "mtp"}
    assert _rel(got, want) <= LOSS_TOL
    for k in ("ce", "aux", "mtp"):
        assert _rel(m[k], jm[k]) <= LOSS_TOL
    assert float(m["aux"].detach()) > 0
    assert _rel(got, m["ce"] + 0.3 * m["mtp"] + 0.01 * m["aux"]) <= 1e-7
    with torch.no_grad():
        plain, _ = T.lm_loss(model.lm, model.cfg, batch)
    assert float(plain) == float(got.detach())


def test_gradients_match_reference(model, loss_ref):
    """Every leaf's gradient against ``jax.grad`` of the reference's
    ``lm_loss``, the MTP head's and each router's among them (nonzero)."""
    toks, want, _, jgrads = loss_ref
    grads, loss = TR.make_grad_fn(model.cfg, global_batch=B_)(
        model.lm, {"tokens": torch.from_numpy(toks)})
    assert _rel(loss, want) <= LOSS_TOL
    for err, size in _leaf_errs(grads, jgrads):
        assert err <= GRAD_TOL * max(1e-2, size)
    paths = [p for p, _, _ in reference_leaves(model.lm)]
    for i, path in enumerate(paths):
        if path[0] == "mtp" or path[-1] == "router":
            assert all(float(g.abs().max()) > 0 for g in grads[i]), path


@pytest.mark.parametrize("B", [2, 8])
def test_prefill_matches_reference(model, B):
    """B = 8 runs as 4 chunks of 2 rows in both packages (4 dispatches a
    MoE layer)."""
    toks = _tokens(20 + B, model.cfg, B, 16)
    got, cache = D.prefill(model.lm, model.cfg,
                           {"tokens": torch.from_numpy(toks)})
    want, _ = JD.prefill(model.jparams, model.jcfg,
                         {"tokens": jnp.asarray(toks)})
    assert cache is None and got.shape == (B, model.cfg.vocab)
    assert _err(got, want) < MODEL_TOL


def _decode(m, toks, port: bool, index_tensor: bool = False):
    """Teacher-forced decode: the logits of every step and the cache."""
    B, S = toks.shape
    outs = []
    if port:
        cache = D.cache_zeros(D.cache_spec(m.cfg, B, S), "cpu")
        for t in range(S):
            lg, cache = D.decode_step(m.lm, m.cfg, {
                "token": torch.from_numpy(toks[:, t:t + 1]),
                "index": torch.tensor(t) if index_tensor else t}, cache)
            outs.append(lg.numpy())
    else:
        cache = JD.cache_zeros(JD.cache_spec(m.jcfg, B, S))
        for t in range(S):
            lg, cache = m.jstep(m.jparams, {
                "token": jnp.asarray(toks[:, t:t + 1]),
                "index": jnp.int32(t)}, cache)
            outs.append(np.asarray(lg))
    return np.stack(outs, axis=1), cache


def test_decode_step_matches_reference(model):
    """Eight steps (B = 2, a dispatch of 2 tokens at C = 8: nothing
    dropped) through both segments: every step's logits and the caches
    after the last, updated in place by the port; a 0-d index tensor
    gives the same logits as the int."""
    toks = _tokens(11, model.cfg, 2, 8)
    got, cache = _decode(model, toks, port=True)
    want, jcache = _decode(model, toks, port=False)
    assert _err(got, want) < MODEL_TOL
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == 4
    for path, leaf in flat:
        mine = cache
        for p in path:
            mine = mine[p.key]
        assert tuple(mine.shape) == leaf.shape
        assert _err(mine, leaf) < MODEL_TOL
    again, _ = _decode(model, toks, port=True, index_tensor=True)
    assert np.array_equal(got, again)


def test_generate_matches_teacher_forced_reference(model):
    """``launch.serve.generate`` (B = 2, P = 6, 5 new tokens): its logits
    at every step equal the reference's decode fed the same tokens, and
    each new token is the argmax of the reference's logits."""
    P, N = 6, 5
    prompts = _tokens(16, model.cfg, 2, P)
    gen, logits = serve.generate(model.lm, model.cfg,
                                 torch.from_numpy(prompts), N,
                                 return_logits=True)
    seq = np.concatenate([prompts, gen.numpy()], axis=1)
    want, _ = _decode(model, seq[:, :P + N - 1], port=False)
    assert _err(logits, want) < MODEL_TOL
    assert np.array_equal(gen.numpy(), want[:, P - 1:].argmax(-1))


def test_train_step_matches_reference(model, loss_ref):
    """One AdamW step on the loss fixture's batch: loss, grad_norm, aux
    and the MTP term against the reference's, and the parameters after
    the step against the reference's ``apply_opt`` of its gradients."""
    toks, want, jm, jgrads = loss_ref
    opt = JO.OptConfig(lr=LR)
    jopt, _ = JO.init_opt(opt, model.jparams, model.jaxes)
    newp, _ = jax.jit(lambda p, g, o: JO.apply_opt(
        opt, p, g, o, jnp.zeros((), jnp.int32)))(model.jparams, jgrads, jopt)
    jnorm = np.sqrt(sum(float(np.sum(np.square(np.asarray(g))))
                        for g in jax.tree.leaves(jgrads)))
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, {
        "params": model.jparams, "opt": jopt,
        "step": jnp.zeros((), jnp.int32)}), model.cfg, "cpu")
    step = TR.make_train_step(model.cfg, O.OptConfig(lr=LR),
                              global_batch=B_)
    state, m = step(state, {"tokens": torch.from_numpy(toks)})
    assert set(m) == {"loss", "grad_norm", "aux", "mtp"}
    assert _rel(m["loss"], want) <= LOSS_TOL
    assert _rel(m["grad_norm"], jnorm) <= GRAD_TOL
    for k in ("aux", "mtp"):
        assert _rel(m[k], jm[k]) <= LOSS_TOL
    assert int(state["step"]) == 1
    got = convert.train_state_to_numpy(state)["params"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(newp)):
        assert float(np.abs(a - np.asarray(b)).max()) <= 2 * LR + 1e-6


def test_train_step_metrics_are_microbatch_means(model):
    """Two microbatches: the step's loss, aux and MTP term are the means
    of ``lm_loss``'s over the two halves of the batch."""
    toks = torch.from_numpy(_tokens(41, model.cfg, 4, 16))
    with torch.no_grad():
        halves = [T.lm_loss(model.lm, model.cfg, {"tokens": t})
                  for t in toks.split(2)]
    state = TR.make_state(model.cfg, O.OptConfig(lr=LR),
                          torch.Generator().manual_seed(0), "cpu")
    state["params"].load_state_dict(model.lm.state_dict())
    step = TR.make_train_step(model.cfg, O.OptConfig(lr=LR),
                              microbatches=2, global_batch=4)
    _, m = step(state, {"tokens": toks})
    assert _rel(m["loss"], np.mean([float(x) for x, _ in halves])) <= 1e-6
    for k in ("aux", "mtp"):
        assert _rel(m[k], np.mean([float(h[k]) for _, h in halves])) <= 1e-6


def test_train_step_lowers_the_loss_in_bf16():
    """Three Adafactor steps on one batch in bf16 lower the loss and the
    MTP term; the MTP head moves."""
    cfg = registry.get_smoke(ARCH)
    opt = O.OptConfig(kind="adafactor", lr=2e-3)
    state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    proj = state["params"]["mtp"]["proj"]
    before = proj.detach().clone()
    step = TR.make_train_step(cfg, opt, global_batch=2)
    toks = {"tokens": torch.from_numpy(_tokens(50, cfg, 2, 32))}
    ms = [step(state, toks)[1] for _ in range(3)]
    losses = [float(m["loss"]) for m in ms]
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert float(ms[-1]["mtp"]) < float(ms[0]["mtp"])
    assert all(np.isfinite(losses)) and not torch.equal(proj, before)


def test_launchers_on_cpu(tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--steps", "1",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path)])
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=deepseek-v3-smoke" in out and "done" in out
    assert " aux " in out and " mtp " in out
    assert "arch=deepseek-v3-smoke batch=2 prompt=4 new=3" in out
