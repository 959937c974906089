"""The port's MoE family (llama4-maverick-400b-a17b: dense and MoE blocks in
pairs, capacity-routed top-1 experts plus a shared expert, and the
auxiliary load-balance loss) against the JAX package, on its smoke config
(4 layers = 2 pairs, d 128, 8 experts, moe_d_ff 128) in f32 on the CPU.

Both packages run the same weights (the reference's ``init_lm`` or
``make_state`` tree, carried to the port through ``convert``) and the
same numpy-made inputs. Tolerances are the repo's: layers 2e-5,
whole-model logits 1e-4, losses 2e-5 relative, gradients 1e-5 times the
leaf's largest magnitude (floored at 1e-2). In f32 the routing is held
exactly: every token's expert and keep mask are the reference's. The
reference's keep mask is read from its own output: with the shared
expert taken out, a dropped token's MoE output is exactly 0.

In bf16 (one layer case) a token whose top-2 router margin is below
``FLIP_MARGIN`` may pick the other expert in the two packages, and under
first-come capacity move other tokens' drops: the flip-aware rule allows
exactly that and compares the outputs of the tokens whose expert and
keep mask agree, at the bf16 tolerance of the flash kernels (2e-2 of the
output's largest magnitude).

The reference's chunked prefill is not its unchunked prefill under drops
(each chunk is one dispatch with its own capacity);
``test_prefill_chunks_are_dispatches`` holds that (ROADMAP.md queue 3).
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
from repro_torch.runtime.data import ShardedBatchSource  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

ARCH = "llama4-maverick-400b-a17b"
LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
LOSS_TOL = 2e-5
GRAD_TOL = 1e-5
BF16_TOL = 2e-2
FLIP_MARGIN = 1e-2      # bf16: top-2 router probabilities closer than this
LR = 1e-3


class Model:
    """A smoke config (of ``n_layers``) in f32 in both packages, on the
    same weights."""

    def __init__(self, n_layers: int = 4, seed: int = 0):
        self.jcfg = jregistry.get_smoke(ARCH).replace(
            dtype=jnp.float32, n_layers=n_layers)
        self.cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32,
                                                    n_layers=n_layers)
        self.jparams, _ = JT.init_lm(self.jcfg, jax.random.PRNGKey(seed))
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.lm = convert.lm_params_from_jax(self.tree, self.cfg, "cpu")
        self.jstep = jax.jit(
            lambda p, b, c: JD.decode_step(p, self.jcfg, b, c))

    def moe(self, i: int = 0) -> dict:
        """Pair i's MoE parameters as numpy."""
        return jax.tree.map(lambda x: x[i],
                            self.tree["segments"]["seg0"]["moe"]["moe"])


@pytest.fixture(scope="module")
def model():
    return Model()


@pytest.fixture(scope="module")
def pair():
    """One pair (2 layers): a drop changes only its own token's output."""
    return Model(n_layers=2, seed=1)


def _rand(seed, *shape, mean=0.0):
    return (mean + np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _tokens(seed, cfg, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _rel(a, b) -> float:
    a, b = (t.detach() if isinstance(t, torch.Tensor) else t for t in (a, b))
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


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


def _router_index(params) -> list:
    """Indices of the router leaves in ``reference_leaves(params)``."""
    return [i for i, (p, _, _) in enumerate(reference_leaves(params))
            if p[-1] == "router"]


class Recorder:
    """Records the routing of every MoE dispatch of the port (wraps
    ``layers.moe_route``, which ``moe_apply`` calls)."""

    def __init__(self):
        self.routes = []

    def __enter__(self):
        self.real = L.moe_route

        def route(p, cfg, xf):
            r = self.real(p, cfg, xf)
            self.routes.append(r)
            return r
        L.moe_route = route
        return self

    def __exit__(self, *exc):
        L.moe_route = self.real


def _ref_routing(p: dict, jcfg, x: np.ndarray, dtype=jnp.float32):
    """The reference's expert choice and keep mask of ``x`` [B,S,D]: the
    argmax of its router softmax (its f32 product), and whether its MoE
    output without the shared expert is nonzero."""
    jp = {k: jnp.asarray(v, dtype) for k, v in p.items() if k != "shared"}
    xj = jnp.asarray(x, dtype)
    y, _ = JL.moe_apply(jp, jcfg, xj)
    xf = xj.reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xf, jp["router"],
                        preferred_element_type=jnp.float32)
    choice = np.asarray(jnp.argmax(jax.nn.softmax(logits, -1), -1))
    keep = np.asarray(jnp.any(y.reshape(xf.shape) != 0, axis=-1))
    return choice, keep


def _torch_params(p: dict, dtype=torch.float32) -> dict:
    return {k: _torch_params(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in p.items()}


# -- config, capacity, plan ---------------------------------------------------

def test_registry_has_the_moe_config():
    """Both MoE architectures are ported: NOT_PORTED is empty, and
    deepseek-v3's config equals the reference's field by field."""
    assert ARCH in registry.ARCHS and ARCH not in registry.NOT_PORTED
    assert registry.microbatches(ARCH, "train_4k") \
        == jregistry.microbatches(ARCH, "train_4k") == 16
    assert registry.NOT_PORTED == {}
    for arch in ("deepseek-v3-671b",):
        assert registry.get(arch).replace(dtype=None).__dict__ \
            == jregistry.get(arch).replace(dtype=None).__dict__


@pytest.mark.parametrize("T_", [1, 7, 64, 100, 256, 4096, 4097])
def test_moe_capacity_matches_reference(T_):
    base = jregistry.get_smoke(ARCH)
    for E in (8, 16, 128):
        for k in (1, 2):
            for cf in (1.0, 1.25, 2.0):
                jcfg = base.replace(n_experts=E, experts_per_token=k,
                                    capacity_factor=cf)
                cfg = registry.get_smoke(ARCH).replace(
                    n_experts=E, experts_per_token=k, capacity_factor=cf)
                want = JL.moe_capacity(T_, jcfg)
                assert L.moe_capacity(T_, cfg) == want
                assert want % 8 == 0 and want >= 8
    full = registry.get(ARCH)
    assert L.moe_capacity(4096, full) == 40      # the serving prefill
    assert L.moe_capacity(4, full) == 8          # a decode step, B = 4
    assert L.moe_capacity(4096, full.replace(n_experts=16)) == 320


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_plan_segments_match_reference(which):
    get = registry.get_smoke if which == "smoke" else registry.get
    jget = jregistry.get_smoke if which == "smoke" else jregistry.get
    assert T.plan_segments(get(ARCH)) == JT.plan_segments(jget(ARCH))
    assert T.plan_segments(get(ARCH))[0]["kind"] == "pair"


def test_moe_stack_without_pairs_still_raises():
    """A MoE stack without pairs (interleave 1: a dense prefix, then MoE
    layers, deepseek-v3's layout) and this config with MLA blocks plan as
    the reference plans them; without a prefix the stack is one MoE
    segment. A layout no family has (MLA beside Mamba heads) raises."""
    for kw in ({"moe_interleave": 1, "n_dense_layers": 1},
               {"moe_interleave": 1, "n_dense_layers": 0},
               {"attn_kind": "mla"},
               {"moe_interleave": 1, "n_dense_layers": 3,
                "attn_kind": "mla"}):
        cfg = registry.get_smoke(ARCH).replace(**kw)
        jcfg = jregistry.get_smoke(ARCH).replace(**kw)
        assert T.plan_segments(cfg) == JT.plan_segments(jcfg), kw
    plan = T.plan_segments(registry.get_smoke(ARCH).replace(
        moe_interleave=1, n_dense_layers=1))
    assert [(s["n"], s["moe"]) for s in plan] == [(1, False), (3, True)]
    with pytest.raises(NotImplementedError, match="no such block layout"):
        T.plan_segments(registry.get_smoke("hymba-1.5b").replace(
            attn_kind="mla"))


def test_cache_spec_matches_reference():
    for B, S in ((4, 1056), (2, 8)):
        got = D.cache_spec(registry.get(ARCH), B, S)
        want = JD.cache_spec(jregistry.get(ARCH), B, S)
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


def test_weight_round_trip_bit_for_bit(model):
    """The reference's pair tree (expert leaves [n, E, D, F]) to the port
    and back, in f32 and in bf16 (native bytes); the port's initialiser
    draws the same layout."""
    back = convert.lm_params_to_numpy(model.lm)
    assert jax.tree.all(jax.tree.map(np.array_equal, model.tree, back))
    assert back["segments"]["seg0"]["moe"]["moe"]["w_gate"].shape \
        == (2, 8, 128, 128)
    jcfg = jregistry.get_smoke(ARCH)
    jp, _ = JT.init_lm(jcfg, jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, jp)
    lm = convert.lm_params_from_jax(tree, registry.get_smoke(ARCH), "cpu")
    native = convert.lm_params_to_numpy(lm, native=True)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.tobytes() == b.tobytes() and a.shape == b.shape,
        tree, native))
    mine = convert.lm_params_to_numpy(T.init_lm(
        registry.get_smoke(ARCH), torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.map(np.shape, mine) == jax.tree.map(np.shape, tree)


# -- the MoE layer ------------------------------------------------------------

@pytest.mark.parametrize("case", ["no_drops", "forced_drops"])
def test_moe_apply_matches_reference(model, case):
    """y and aux against the reference, and the routing exactly: every
    token's expert and keep mask. ``forced_drops`` biases router column 0
    and feeds inputs of mean 1, so that most tokens pick expert 0 and all
    but C of them are dropped in both packages."""
    p = model.moe(1)
    if case == "no_drops":
        x = _rand(1, 2, 8, 128)                      # T = 16, C = 8
    else:
        p = dict(p, router=p["router"].copy())
        p["router"][:, 0] += 0.05
        x = _rand(2, 2, 16, 128, mean=1.0)           # T = 32, C = 8
    want, jaux = JL.moe_apply(jax.tree.map(jnp.asarray, p), model.jcfg,
                              jnp.asarray(x))
    tp = _torch_params(p)
    with Recorder() as rec:
        got, aux = L.moe_apply(tp, model.cfg, torch.from_numpy(x))
    assert _err(got, want) < LAYER_TOL
    assert _rel(aux, jaux) <= LOSS_TOL and float(aux) > 0
    (r,) = rec.routes
    choice, keep = _ref_routing(p, model.jcfg, x)
    assert np.array_equal(r.expert.numpy(), choice)
    assert np.array_equal(r.keep.numpy(), keep)
    C = r.capacity
    assert C == JL.moe_capacity(x.shape[0] * x.shape[1], model.jcfg) == 8
    dropped = int((~keep).sum())
    if case == "no_drops":
        assert dropped == 0
    else:
        assert dropped >= 1 and int((~r.keep).sum()) == dropped
        assert dropped == sum(max(0, int(n) - C) for n in r.counts)
    # first come, first served: each expert's kept slots are 0..n-1 in
    # token order, the rest sit in the sink slot C
    for e in range(model.cfg.n_experts):
        mine = r.slot[r.expert == e].tolist()
        n = len(mine)
        assert mine == list(range(min(n, C))) + [C] * max(0, n - C)


def test_moe_apply_top2_matches_reference(model):
    """k = 2 (deepseek-v3's smoke routing; llama4 routes top-1): y and aux
    with drops forced (router columns 0 and 1 biased, inputs of mean 1),
    the gates renormalised over each token's two choices."""
    jcfg = model.jcfg.replace(experts_per_token=2)
    cfg = model.cfg.replace(experts_per_token=2)
    p = model.moe(0)
    p = dict(p, router=p["router"].copy())
    p["router"][:, :2] += 0.05
    x = _rand(6, 2, 16, 128, mean=1.0)               # T·k = 64, C = 16
    want, jaux = JL.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                              jnp.asarray(x))
    with Recorder() as rec:
        got, aux = L.moe_apply(_torch_params(p), cfg, torch.from_numpy(x))
    assert _err(got, want) < LAYER_TOL
    assert _rel(aux, jaux) <= LOSS_TOL
    (r,) = rec.routes
    assert r.capacity == JL.moe_capacity(32, jcfg) == 16
    assert r.expert.shape == (64,) and int((~r.keep).sum()) >= 1
    assert torch.allclose(r.gate.sum(-1), torch.ones(32))


def test_moe_apply_gradients_match_reference(model):
    """d(sum(y·w) + aux)/d(x, router, experts, shared) with drops."""
    p = model.moe(0)
    p = dict(p, router=p["router"].copy())
    p["router"][:, 3] += 0.03
    x = _rand(3, 2, 16, 128, mean=1.0)
    w = _rand(4, 2, 16, 128)

    def jloss(params, xj):
        y, aux = JL.moe_apply(params, model.jcfg, xj)
        return jnp.sum(y * w) + aux
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = _torch_params(p)
    for t in [*tp.values(), *tp["shared"].values()]:
        if isinstance(t, torch.Tensor):
            t.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    with Recorder() as rec:
        y, aux = L.moe_apply(tp, model.cfg, xt)
    assert int((~rec.routes[0].keep).sum()) >= 1
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    for name in ("router", "w_gate", "w_up", "w_down"):
        want = np.asarray(jg[name])
        assert _err(tp[name].grad, want) <= GRAD_TOL * max(
            1e-2, float(np.abs(want).max())), name
    assert float(tp["router"].grad.abs().max()) > 0
    assert _err(xt.grad, jgx) <= GRAD_TOL * max(
        1e-2, float(np.abs(np.asarray(jgx)).max()))


def test_moe_apply_bf16_flip_aware(model):
    """bf16 weights and inputs: the tokens whose expert and keep mask
    agree have the reference's output within BF16_TOL of its largest
    magnitude; a token whose expert differs must have a top-2 margin
    below FLIP_MARGIN."""
    p = model.moe(1)
    x = _rand(5, 4, 16, 128)                         # T = 64, C = 16
    bf = {k: v for k, v in p.items() if k != "shared"}
    want, _ = JL.moe_apply(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), bf), model.jcfg,
        jnp.asarray(x, jnp.bfloat16))
    cfg = model.cfg.replace(dtype=torch.bfloat16)
    with Recorder() as rec:
        got, _ = L.moe_apply(_torch_params(bf, torch.bfloat16), cfg,
                             torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    (r,) = rec.routes
    choice, keep = _ref_routing(bf, model.jcfg, x, jnp.bfloat16)
    top2 = torch.topk(r.probs, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    flipped = r.expert.numpy() != choice
    assert np.all(margin[flipped] < FLIP_MARGIN)
    same = ~flipped & (r.keep.numpy() == keep)
    assert same.mean() > 0.9
    want = np.asarray(want, np.float32).reshape(-1, 128)
    err = np.abs(got.float().numpy().reshape(-1, 128) - want)[same].max()
    assert err <= BF16_TOL * float(np.abs(want).max())


# -- the model ----------------------------------------------------------------

def test_lm_loss_matches_reference(model):
    """Loss, ce and aux (summed over the two MoE layers) of the same
    tokens; with grad enabled too (every block under checkpoint)."""
    toks = _tokens(10, model.cfg, 2, 64)
    want, jm = JT.lm_loss(model.jparams, model.jcfg,
                          {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, m = T.lm_loss(model.lm, model.cfg,
                           {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= LOSS_TOL
    assert _rel(m["ce"], jm["ce"]) <= LOSS_TOL
    assert _rel(m["aux"], jm["aux"]) <= LOSS_TOL and float(m["aux"]) > 0
    assert _rel(got, m["ce"] + 0.01 * m["aux"]) <= 1e-7
    grad_loss, _ = T.lm_loss(model.lm, model.cfg,
                             {"tokens": torch.from_numpy(toks)})
    assert float(grad_loss.detach()) == float(got)


@pytest.mark.parametrize("B", [2, 8])
def test_prefill_matches_reference(model, B):
    """B = 8 runs as 4 chunks of 2 rows in both packages (4 dispatches)."""
    toks = _tokens(20 + B, model.cfg, B, 32)
    with Recorder() as rec:
        got, cache = D.prefill(model.lm, model.cfg,
                               {"tokens": torch.from_numpy(toks)})
    want, _ = JD.prefill(model.jparams, model.jcfg,
                         {"tokens": jnp.asarray(toks)})
    assert cache is None and got.shape == (B, model.cfg.vocab)
    assert _err(got, want) < MODEL_TOL
    chunks = 4 if B == 8 else 1
    assert len(rec.routes) == 2 * chunks
    assert {r.capacity for r in rec.routes} == {
        L.moe_capacity(B // chunks * 32, model.cfg)}


def test_prefill_chunks_are_dispatches(model):
    """B = 8, S = 3: the unchunked dispatch of 24 tokens drops tokens at
    C = 8, its 4 chunks of 6 tokens drop none, and the last-token logits
    of the two differ, in the reference and in the port alike (ROADMAP.md
    queue 3: the reference's docstring calls its chunking exact)."""
    toks = _tokens(3, model.cfg, 8, 3)
    runs = {}
    for chunks in (0, 1):
        with Recorder() as rec:
            got, _ = D.prefill(model.lm, model.cfg,
                               {"tokens": torch.from_numpy(toks)},
                               batch_chunks=chunks)
        want, _ = JD.prefill(model.jparams, model.jcfg,
                             {"tokens": jnp.asarray(toks)},
                             batch_chunks=chunks)
        assert _err(got, want) < MODEL_TOL
        runs[chunks] = (got, np.asarray(want),
                        sum(int((~r.keep).sum()) for r in rec.routes))
    assert runs[0][2] == 0 and runs[1][2] > 0
    assert _err(runs[0][1], runs[1][1]) > 100 * MODEL_TOL
    assert _err(runs[0][0], runs[1][0]) > 100 * MODEL_TOL


def _decode(m, toks, port: bool, spare: int = 0):
    """Teacher-forced decode: the logits of every step and the cache."""
    B, S = toks.shape
    outs = []
    if port:
        cache = D.cache_zeros(D.cache_spec(m.cfg, B, S + spare), "cpu")
        for t in range(S):
            lg, cache = D.decode_step(m.lm, m.cfg, {
                "token": torch.from_numpy(toks[:, t:t + 1]), "index": t},
                cache)
            outs.append(lg.numpy())
    else:
        cache = JD.cache_zeros(JD.cache_spec(m.jcfg, B, S + spare))
        for t in range(S):
            lg, cache = m.jstep(m.jparams, {
                "token": jnp.asarray(toks[:, t:t + 1]),
                "index": jnp.int32(t)}, cache)
            outs.append(np.asarray(lg))
    return np.stack(outs, axis=1), cache


def test_decode_step_matches_reference(model):
    """Eight steps (B = 2: C = 8, nothing dropped): every step's logits
    and the pair cache after the last, updated in place by the port."""
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


def test_prefill_matches_teacher_forced_decode_where_kept(pair):
    """One pair, B = 1 × 96 positions (C = 16): the full-sequence forward
    drops tokens, the decode (C = 8 for one token) drops none. At each
    position the prefill kept, the forward's logits equal the decode's
    (the port's and the reference's); at a dropped one they differ."""
    toks = _tokens(12, pair.cfg, 1, 96)
    x = L.embed_apply(pair.lm["embed"], torch.from_numpy(toks))
    with torch.no_grad(), Recorder() as rec:
        hidden, aux = T.backbone_forward(pair.lm, pair.cfg, x,
                                         torch.arange(96)[None])
        full = L.logits_apply(pair.lm["embed"], hidden,
                              pair.cfg.tie_embeddings)
    (r,) = rec.routes
    keep = r.keep.numpy()
    assert 0 < int((~keep).sum()) and float(aux) > 0
    with Recorder() as rec:
        dec, _ = _decode(pair, toks, port=True)
    assert all(int((~d.keep).sum()) == 0 and d.capacity == 8
               for d in rec.routes)
    jdec, _ = _decode(pair, toks, port=False)
    assert _err(dec, jdec) < MODEL_TOL
    diff = np.abs(full.numpy()[0] - dec[0]).max(axis=-1)
    assert diff[keep].max() < MODEL_TOL
    assert diff[~keep].min() > 100 * MODEL_TOL
    last, _ = D.prefill(pair.lm, pair.cfg, {"tokens": torch.from_numpy(toks)})
    assert _err(last, full[:, -1]) < MODEL_TOL


def test_serve_generate_matches_reference_greedy(model):
    P, N = 6, 5
    prompts = _tokens(16, model.cfg, 2, P)
    got = serve.generate(model.lm, model.cfg, torch.from_numpy(prompts),
                         N).numpy()
    cache = JD.cache_zeros(JD.cache_spec(model.jcfg, 2, P + N))
    gen = []
    for t in range(P + N - 1):
        inp = prompts[:, t:t + 1] if t < P else gen[-1]
        lg, cache = model.jstep(model.jparams, {"token": jnp.asarray(inp),
                                                "index": jnp.int32(t)}, cache)
        if t >= P - 1:
            gen.append(np.asarray(jnp.argmax(lg, axis=-1))[:, None])
    assert np.array_equal(got, np.concatenate(gen, axis=1))


# -- training -----------------------------------------------------------------

def _state(seed=0):
    jcfg = jregistry.get_smoke(ARCH).replace(dtype=jnp.float32)
    cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32)
    jstate, _ = JTR.make_state(jcfg, JO.OptConfig(lr=LR),
                               key=jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jstate)
    return jcfg, cfg, jstate, convert.train_state_from_jax(tree, cfg, "cpu")


def test_gradients_match_reference():
    """One batch of 4 × 64 tokens: every leaf's gradient against
    ``jax.grad`` of the reference's ``lm_loss``; both routers' gradients
    are nonzero (through the gate and the auxiliary loss)."""
    jcfg, cfg, jstate, state = _state()
    toks = _tokens(30, cfg, 4, 64)
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b), has_aux=True))(
        jstate["params"], {"tokens": jnp.asarray(toks)})
    grads, loss = TR.make_grad_fn(cfg, global_batch=4)(
        state["params"], {"tokens": torch.from_numpy(toks)})
    assert _rel(loss, want) <= LOSS_TOL
    for err, size in _leaf_errs(grads, jgrads):
        assert err <= GRAD_TOL * max(1e-2, size)
    (router,) = _router_index(state["params"])
    assert all(float(g.abs().max()) > 0 for g in grads[router])
    jrouter = np.asarray(jgrads["segments"]["seg0"]["moe"]["moe"]["router"])
    assert np.abs(jrouter).max(axis=(1, 2)).min() > 0


def test_checkpointed_gradients_equal_uncheckpointed(model):
    """The port's loss (every block under checkpoint, the backward
    recomputing each block's routing) against the same loss composed here
    from the blocks with no checkpoint at all: the same gradients, with
    tokens dropped in both MoE layers."""
    toks = torch.from_numpy(_tokens(31, model.cfg, 2, 64))
    lm, cfg = model.lm, model.cfg
    params = list(lm.parameters())
    with Recorder() as rec:
        loss, _ = T.lm_loss(lm, cfg, {"tokens": toks})
        ckpt = torch.autograd.grad(loss, params, allow_unused=True)
    # forward, then the two recomputed MoE dispatches in the backward
    assert len(rec.routes) == 4
    for a, b in zip(rec.routes[:2], rec.routes[:1:-1]):
        assert torch.equal(a.expert, b.expert) and torch.equal(a.keep, b.keep)
    assert all(int((~r.keep).sum()) > 0 for r in rec.routes)
    x = L.embed_apply(lm["embed"], toks)
    pos = torch.arange(64)[None].expand(2, 64)
    aux = 0.0
    for lp in lm["segments"]["seg0"]:
        x, _, _ = T.block_apply(lp["dense"], cfg, x, pos, moe=False,
                                window=-1)
        x, _, a = T.block_apply(lp["moe"], cfg, x, pos, moe=True, window=-1)
        aux = aux + a
    hidden = L.rmsnorm(lm["ln_f"], x, cfg.norm_eps)
    logits = L.logits_apply(lm["embed"], hidden, cfg.tie_embeddings)
    plain = T.ce_loss(logits[:, :-1], toks[:, 1:]) + 0.01 * aux
    assert _rel(plain, loss) <= 1e-6
    direct = torch.autograd.grad(plain, params, allow_unused=True)
    for a, b in zip(ckpt, direct):
        assert (a is None) == (b is None)
        if a is not None:
            assert float((a - b).abs().max()) <= GRAD_TOL * max(
                1e-2, float(b.abs().max()))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Three AdamW steps over batches of 4 × 32 tokens: loss and grad_norm
    at each (each microbatch its own dispatch, as in the reference's
    scan), the parameters after the last; the port's metrics carry the
    MoE auxiliary loss, the mean over the microbatches of the
    reference's."""
    jcfg, cfg, jstate, state = _state()
    jstep = jax.jit(JTR.make_train_step(jcfg, JO.OptConfig(lr=LR),
                                        microbatches=microbatches,
                                        global_batch=4))
    step = TR.make_train_step(cfg, O.OptConfig(lr=LR),
                              microbatches=microbatches, global_batch=4)
    jaux = jax.jit(lambda p, t: JT.lm_loss(p, jcfg, {"tokens": t})[1]["aux"])
    for i in range(3):
        toks = _tokens(40 + i, cfg, 4, 32)
        auxs = [jaux(jstate["params"], jnp.asarray(t))
                for t in np.split(toks, microbatches)]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        assert _rel(m["loss"], jm["loss"]) <= LOSS_TOL
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
        assert _rel(m["aux"], np.mean(auxs)) <= LOSS_TOL
    assert int(state["step"]) == int(jstate["step"]) == 3
    got = convert.train_state_to_numpy(state)["params"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate["params"])):
        assert float(np.abs(a - np.asarray(b)).max()) <= 2 * LR + 1e-6


def test_train_step_lowers_the_loss_in_bf16():
    """The reference's test_train_step_reduces_loss on this config: three
    Adafactor steps on one batch in bf16 lower the loss, and the router
    moves."""
    cfg = registry.get_smoke(ARCH)
    opt = O.OptConfig(kind="adafactor", lr=2e-3)
    state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    router = state["params"]["segments"]["seg0"][0]["moe"]["moe"]["router"]
    before = router.detach().clone()
    step = TR.make_train_step(cfg, opt, global_batch=2)
    toks = {"tokens": torch.from_numpy(_tokens(50, cfg, 2, 64))}
    losses = [float(step(state, toks)[1]["loss"]) for _ in range(3)]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    assert not torch.equal(router, before)


# -- launchers and data -------------------------------------------------------

def test_launchers_and_batch_source_on_cpu(tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path)])
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=llama4-smoke" in out and "done" in out
    assert "arch=llama4-smoke batch=2 prompt=4 new=3" in out
    src = ShardedBatchSource(512, 2, 16, seed=3, device="cpu", family="moe")
    assert src.batch(0).keys() == {"tokens"}
