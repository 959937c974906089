"""The port's training path (repro_torch.models.transformer losses,
repro_torch.train, repro_torch.launch.train, the dense GQA config
copies) against the JAX package, on the smoke configs in f32 on the CPU.

Both packages run the same weights (the reference's ``make_state`` tree,
carried to the port through ``convert.train_state_from_jax``) and the same
numpy-made tokens and gradients. Tolerances, each for f32 rounding in a
different order: losses 2e-5 relative; gradients 1e-5 times the leaf's
largest magnitude (floored at 1e-2); ``grad_norm`` 1e-5 relative; the
optimizers on identical gradients 2e-6 absolute on parameters of size
~0.02-1 and 1e-6 relative on their state. After a train step the
parameters are held at 2·lr + 1e-6: AdamW's first step is lr·sign(g), and
an element whose gradient is near zero may take either sign in the two
frameworks.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import (param_count,  # noqa: E402
                                        reference_leaves)
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

LOSS_TOL = 2e-5
GRAD_TOL = 1e-5
OPT_TOL = 2e-6
LR = 1e-3
NEW_ARCHS = ["qwen3-14b", "internlm2-1.8b", "yi-34b", "qwen2-vl-7b"]


def _cfgs(arch):
    return (jregistry.get_smoke(arch).replace(dtype=jnp.float32),
            registry.get_smoke(arch).replace(dtype=torch.float32))


def _state(arch, kind="adamw", seed=0):
    """The reference's train state of the smoke config in f32 and the
    port's copy of it."""
    jcfg, cfg = _cfgs(arch)
    jstate, _ = JTR.make_state(jcfg, JO.OptConfig(kind=kind, lr=LR),
                               key=jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jstate)
    return jstate, convert.train_state_from_jax(tree, cfg, "cpu")


def _tokens(seed, cfg, B=4, S=64):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _rel(a, b) -> float:
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def _leaf_errs(got: list, want_tree) -> list:
    """max |got - want| per reference leaf, and the leaf's max |want|."""
    flat = jax.tree.leaves(want_tree)
    out = []
    for g, w in zip(got, flat):
        g = np.stack([t.detach().float().numpy() for t in g]) \
            if len(g) > 1 or np.ndim(w) > g[0].dim() else \
            g[0].detach().float().numpy()
        w = np.asarray(w, np.float32)
        out.append((float(np.abs(g.reshape(w.shape) - w).max()),
                    float(np.abs(w).max())))
    return out


# -- losses ---------------------------------------------------------------------

def test_ce_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 40, 97)).astype(np.float32) * 3
    tgt = rng.integers(0, 97, (2, 40))
    w = (rng.random((2, 40)) > 0.3).astype(np.float32)
    for weights in (None, w):
        want = JT.ce_loss(jnp.asarray(logits), jnp.asarray(tgt),
                          None if weights is None else jnp.asarray(weights))
        got = T.ce_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                        None if weights is None else torch.from_numpy(weights))
        assert _rel(got, want) <= LOSS_TOL


@pytest.mark.parametrize("S,chunk,shift", [(64, 16, 1), (60, 16, 1),
                                           (64, 32, 2)])
def test_ce_loss_seqchunk_matches_reference(S, chunk, shift):
    """Chunked (S a multiple of the chunk) and unchunked (60: one chunk),
    next-token and shift 2, with loss weights; and its gradient."""
    jcfg, cfg = _cfgs("yi-6b")
    jstate, state = _state("yi-6b")
    rng = np.random.default_rng(S + chunk)
    hid = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab, (2, S))
    w = (rng.random((2, S)) > 0.2).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda h: JT.ce_loss_seqchunk(jstate["params"]["embed"], h,
                                      jnp.asarray(tgt), False,
                                      weights=jnp.asarray(w), shift=shift,
                                      chunk=chunk))(jnp.asarray(hid))
    h = torch.from_numpy(hid).requires_grad_()
    got = T.ce_loss_seqchunk(state["params"]["embed"], h,
                             torch.from_numpy(tgt), False,
                             weights=torch.from_numpy(w), shift=shift,
                             chunk=chunk)
    got.backward()
    assert _rel(got, want) <= LOSS_TOL
    jg = np.asarray(jgrad)
    assert float(np.abs(h.grad.numpy() - jg).max()) \
        <= GRAD_TOL * max(1e-2, float(np.abs(jg).max()))


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-3b"])
def test_lm_loss_and_gradients_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jstate, state = _state(arch)
    toks = _tokens(1, cfg)
    (want, _), jgrads = jax.value_and_grad(JT.lm_loss, has_aux=True)(
        jstate["params"], jcfg, {"tokens": jnp.asarray(toks)})
    grads_of = TR.make_grad_fn(cfg, global_batch=4)
    grads, got = grads_of(state["params"], {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= LOSS_TOL
    for err, size in _leaf_errs(grads, jgrads):
        assert err <= GRAD_TOL * max(1e-2, size)


def test_lm_loss_raises_for_unported_branches():
    """No branch of the reference's ``lm_loss`` is left unported: a GQA
    config with the MTP head (yi-6b's smoke config with ``mtp=True``)
    gives the reference's loss, ce and MTP term, and its MTP leaves'
    gradients."""
    jcfg, cfg = (c.replace(mtp=True) for c in _cfgs("yi-6b"))
    jparams, _ = JT.init_lm(jcfg, jax.random.PRNGKey(3))
    lm = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    toks = _tokens(4, cfg, B=2, S=16)
    (want, jm), jgrads = jax.value_and_grad(JT.lm_loss, has_aux=True)(
        jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, m = T.lm_loss(lm, cfg, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= LOSS_TOL
    assert set(m) == {"ce", "aux", "mtp"} and float(m["aux"]) == 0.0
    for k in ("ce", "mtp"):
        assert _rel(m[k].detach(), jm[k]) <= LOSS_TOL
    got.backward()
    grads = [[p.grad for p in ps] for _, ps, _ in reference_leaves(lm["mtp"])]
    assert len(grads) == len(jax.tree.leaves(jgrads["mtp"])) == 11
    for err, size in _leaf_errs(grads, jgrads["mtp"]):
        assert err <= GRAD_TOL * max(1e-2, size)


def test_blocks_are_checkpointed_under_grad():
    """With grad enabled the backward recomputes every block: the flash
    wrapper runs twice per layer per loss (forward and recompute) and
    once per layer without grad."""
    from repro_torch.kernels import ops
    _, cfg = _cfgs("yi-6b")
    lm = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(2, cfg, B=2, S=32))
    calls = []
    real = ops.attention
    ops.attention = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    try:
        loss, _ = T.lm_loss(lm, cfg, {"tokens": toks})
        loss.backward()
        assert len(calls) == 2 * cfg.n_layers
        calls.clear()
        with torch.no_grad():
            T.lm_loss(lm, cfg, {"tokens": toks})
        assert len(calls) == cfg.n_layers
    finally:
        ops.attention = real


# -- optimizers ---------------------------------------------------------------

def _grad_tree(params_tree, seed, layer_density=None):
    """Seeded gradients shaped like the reference's parameter tree; with
    ``layer_density``, layer i of every stacked leaf keeps that share of
    its elements and is zero elsewhere."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        g = rng.standard_normal(a.shape).astype(np.float32) * 0.1
        if layer_density is not None and path[0].key == "segments":
            dens = np.asarray(layer_density).reshape(
                (-1,) + (1,) * (a.ndim - 1))
            g *= (rng.random(a.shape) < dens).astype(np.float32)
        return g
    return jax.tree_util.tree_map_with_path(one, params_tree)


def _port_grads(state, gtree):
    """The numpy gradient tree as the port's per-reference-leaf lists."""
    out = []
    for (path, ps, stacked), g in zip(reference_leaves(state["params"]),
                                      jax.tree.leaves(gtree)):
        out.append([torch.from_numpy(x) for x in g] if stacked
                   else [torch.from_numpy(g)])
    return out


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-3b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_opt_matches_reference(arch, kind):
    """Three steps on identical gradients: parameters and state."""
    jopt, opt = JO.OptConfig(kind=kind, lr=LR), O.OptConfig(kind=kind, lr=LR)
    jstate, state = _state(arch, kind)
    jp, js = jstate["params"], jstate["opt"]
    for i in range(3):
        g = _grad_tree(jax.tree.map(np.asarray, jp), 10 + i)
        jp, js = JO.apply_opt(jopt, jp, jax.tree.map(jnp.asarray, g), js,
                              jnp.int32(i))
        O.apply_opt(opt, state["params"], _port_grads(state, g),
                    state["opt"], torch.tensor(i, dtype=torch.int32))
    got = convert.train_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(jp)):
        assert float(np.abs(a - np.asarray(b)).max()) <= OPT_TOL
    for a, b in zip(jax.tree.leaves(got["opt"]), jax.tree.leaves(js)):
        b = np.asarray(b)
        assert float(np.abs(a - b).max()) <= 1e-6 * max(1e-6,
                                                       float(np.abs(b).max()))


def test_decay_and_clip_act_on_the_stacked_leaf():
    """Adafactor with a sparse middle layer (10% of its gradient nonzero)
    and a clip threshold of 0.5: the clip's RMS is taken over all layers
    of a leaf and each layer's norm scale is decayed, as on the
    reference's stacked leaf. The same update taken per layer (each layer
    its own leaf: its own clip, a 1-D scale not decayed) lands elsewhere,
    so this case tells the two apart."""
    cfg = dict(kind="adafactor", lr=LR, weight_decay=0.5, clip_threshold=0.5)
    jopt = JO.OptConfig(**cfg)
    jstate, state = _state("yi-6b", "adafactor")
    np_params = jax.tree.map(np.asarray, jstate["params"])
    g = _grad_tree(np_params, 3, layer_density=[1.0, 0.1, 1.0])
    want, _ = JO.apply_opt(jopt, jstate["params"],
                           jax.tree.map(jnp.asarray, g), jstate["opt"],
                           jnp.int32(0))
    O.apply_opt(O.OptConfig(**cfg), state["params"], _port_grads(state, g), state["opt"],
                torch.tensor(0, dtype=torch.int32))
    got = convert.train_state_to_numpy(state)["params"]["segments"]["seg0"]
    seg = want["segments"]["seg0"]
    per_layer = []
    for i in range(3):
        lp = jax.tree.map(lambda a: jnp.asarray(a[i]),
                          np_params["segments"]["seg0"])
        lg = jax.tree.map(lambda a: jnp.asarray(a[i]),
                          g["segments"]["seg0"])
        ls, _ = JO.init_opt(jopt, lp, jax.tree.map(lambda a: (None,) * a.ndim,
                                                    lp))
        per_layer.append(JO.apply_opt(jopt, lp, lg, ls, jnp.int32(0))[0])
    for leaf in (("mlp", "w_up"), ("attn", "wk"), ("ln1", "scale")):
        stacked = np.asarray(seg[leaf[0]][leaf[1]])
        layered = np.stack([np.asarray(p[leaf[0]][leaf[1]])
                            for p in per_layer])
        port = got[leaf[0]][leaf[1]]
        assert float(np.abs(port - stacked).max()) <= OPT_TOL
        assert float(np.abs(layered - stacked).max()) > 10 * OPT_TOL
    # ln_f ([D]) is not decayed: with a zero gradient it stays at 1
    assert np.array_equal(np.asarray(want["ln_f"]["scale"]),
                          convert.train_state_to_numpy(state)["params"]
                          ["ln_f"]["scale"])


def _functional_opt(opt, params, grads, state, step):
    """A functional optimizer step on the reference's stacked leaves (each
    leaf's layers stacked into one tensor, new tensors out, inputs
    untouched): ``{path: (new stacked param, new state)}``. Its one
    concession to the port is the order of Adafactor's sum of squares on
    a leaf of per-layer matrices (a sum of per-layer sums)."""
    stepf = step.float() + 1.0
    beta = 1.0 - stepf ** (-opt.decay_rate)
    out = {}
    for (path, ps, stacked), gs in zip(reference_leaves(params), grads):
        P = torch.stack(ps) if stacked else ps[0]
        G = (torch.stack(gs) if stacked else gs[0]).float()
        S = state
        for key in path:
            S = S[key]
        decay = P.dim() >= 2
        if opt.kind == "adamw":
            m = opt.b1 * S["m"] + (1 - opt.b1) * G
            v = opt.b2 * S["v"] + (1 - opt.b2) * torch.square(G)
            upd = (m / (1 - opt.b1 ** stepf)) / (
                torch.sqrt(v / (1 - opt.b2 ** stepf)) + opt.eps)
            news = {"m": m, "v": v}
        else:
            g2 = torch.square(G) + 1e-30
            if "vr" in S:
                vr = beta * S["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * S["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] / vr.mean(dim=-1, keepdim=True)
                         [..., None]) * vc[..., None, :]
                upd = G * torch.rsqrt(denom + 1e-30)
                news = {"vr": vr, "vc": vc}
            else:
                v = beta * S["v"] + (1 - beta) * g2
                upd = G * torch.rsqrt(v + 1e-30)
                news = {"v": v}
            sumsq = (sum(torch.square(u).sum() for u in upd)
                     if stacked and ps[0].dim() >= 2
                     else torch.square(upd).sum())
            rms = torch.sqrt(sumsq / upd.numel() + 1e-30)
            upd = upd / torch.clamp(rms / opt.clip_threshold, min=1.0)
        if decay:
            upd = upd + opt.weight_decay * P.float()
        out[path] = ((P.float() - opt.lr * upd).to(P.dtype), news)
    return out


def test_adamw_in_slices_gives_the_same_bytes(monkeypatch):
    """AdamW updates a tensor in slices of its first dim (ADAMW_CHUNK
    elements at most on the card, ADAMW_CHUNK_HOST on the CPU): with both
    at 100 every matrix goes one row at a time and the stacked norm
    scales in slices, and every parameter and moment ends with the bytes
    of the whole-tensor update."""
    opt = O.OptConfig(kind="adamw", lr=LR)
    _, cfg = _cfgs("yi-6b")
    states = []
    for chunk in (O.ADAMW_CHUNK, 100):
        monkeypatch.setattr(O, "ADAMW_CHUNK", chunk)
        monkeypatch.setattr(O, "ADAMW_CHUNK_HOST", chunk)
        state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0),
                              "cpu")
        for i in range(2):
            g = _port_grads(state, _grad_tree(
                convert.lm_params_to_numpy(state["params"]), 20 + i))
            O.apply_opt(opt, state["params"], g, state["opt"],
                        torch.tensor(i, dtype=torch.int32))
        states.append(state)
    for (_, a, _), (_, b, _) in zip(reference_leaves(states[0]["params"]),
                                    reference_leaves(states[1]["params"])):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    flat = [jax.tree.leaves(convert.train_state_to_numpy(s)["opt"])
            for s in states]
    assert all(np.array_equal(x, y) for x, y in zip(*flat))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_opt_in_place_equals_functional(kind):
    """apply_opt, which writes each layer of a leaf in place, gives the
    same bytes as a functional step on the stacked leaves, and leaves the
    gradients alone. Two steps; Adafactor with ``min_dim_factored=8`` so
    that the smoke config has factored and unfactored leaves."""
    opt = O.OptConfig(kind=kind, lr=LR, min_dim_factored=8)
    _, cfg = _cfgs("yi-6b")
    state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    for i in range(2):
        g = _port_grads(state, _grad_tree(
            convert.lm_params_to_numpy(state["params"]), 4 + i))
        g_before = [[x.clone() for x in leaf] for leaf in g]
        step = torch.tensor(i, dtype=torch.int32)
        want = _functional_opt(opt, state["params"], g, state["opt"], step)
        O.apply_opt(opt, state["params"], g, state["opt"], step)
        assert all(torch.equal(x, y) for a, b in zip(g, g_before)
                   for x, y in zip(a, b))
        for path, ps, stacked in reference_leaves(state["params"]):
            new_p, new_s = want[path]
            got = torch.stack(ps) if stacked else ps[0]
            assert torch.equal(got, new_p), (i, path)
            S = state["opt"]
            for key in path:
                S = S[key]
            assert S.keys() == new_s.keys()
            assert all(torch.equal(S[k], new_s[k]) for k in S), (i, path)
    if kind == "adafactor":
        factored = [path for path, _, _ in reference_leaves(state["params"])
                    if "vr" in want[path][1]]
        assert factored and len(factored) < len(want)


def test_init_opt_layout_matches_reference():
    """Factored (vr, vc) where the stacked leaf's last two dims are both
    >= 128, else v; AdamW m and v: the reference's keys and shapes."""
    for kind in ("adamw", "adafactor"):
        for arch in ("yi-6b", "rwkv6-3b"):
            jstate, state = _state(arch, kind)
            want = jax.tree.map(lambda a: a.shape, jstate["opt"])
            got = jax.tree.map(lambda a: a.shape,
                               convert.train_state_to_numpy(state)["opt"])
            assert got == want


def test_choose_optimizer_and_param_count():
    assert O.choose_optimizer(1e12) == JO.choose_optimizer(1e12) \
        == "adafactor"
    assert O.choose_optimizer(6e9) == "adamw"
    jstate, state = _state("yi-6b")
    from repro.models.common import param_count as jparam_count
    assert param_count(state["params"]) == jparam_count(jstate["params"])


# -- train step ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-3b"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(arch, microbatches):
    """Three AdamW steps: loss and grad_norm at each, the gradients of the
    first, and the parameters after the last."""
    jcfg, cfg = _cfgs(arch)
    jopt, opt = JO.OptConfig(lr=LR), O.OptConfig(lr=LR)
    jstate, state = _state(arch)
    jstep = jax.jit(JTR.make_train_step(jcfg, jopt, microbatches=microbatches,
                                        global_batch=4))
    step = TR.make_train_step(cfg, opt, microbatches=microbatches,
                              global_batch=4)
    toks = _tokens(7, cfg)
    # the first step's gradients: the mean of the microbatches' as the
    # reference's scan accumulates them
    grads_of = TR.make_grad_fn(cfg, microbatches=microbatches,
                               global_batch=4)
    grads, _ = grads_of(state["params"], {"tokens": torch.from_numpy(toks)})
    per_mb = [jax.grad(lambda p, t: JT.lm_loss(p, jcfg, {"tokens": t})[0])(
        jstate["params"], jnp.asarray(t))
        for t in np.split(toks, microbatches)]
    jgrads = jax.tree.map(lambda *g: sum(g) / microbatches, *per_mb)
    for err, size in _leaf_errs(grads, jgrads):
        assert err <= GRAD_TOL * max(1e-2, size)
    for i in range(3):
        batch = _tokens(7 + i, cfg)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch)})
        state, m = step(state, {"tokens": torch.from_numpy(batch)})
        assert _rel(m["loss"], jm["loss"]) <= LOSS_TOL
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
    assert int(state["step"]) == int(jstate["step"]) == 3
    got = convert.train_state_to_numpy(state)["params"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate["params"])):
        assert float(np.abs(a - np.asarray(b)).max()) <= 2 * LR + 1e-6


def test_deterministic_mode_raises_without_cublas_setting(monkeypatch):
    """On a CUDA device the step's deterministic mode refuses to start
    without a deterministic CUBLAS_WORKSPACE_CONFIG, turns PyTorch's
    deterministic algorithms on in raising mode (not warn-only) and
    restores the previous setting after. Nothing here touches a card."""
    cuda = torch.device("cuda")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with TR.deterministic(cuda):
            pass
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with TR.deterministic(cuda):
            pass
    TR.set_cublas_workspace()    # leaves a value that is already set
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":0:0"
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    TR.set_cublas_workspace()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == TR.CUBLAS_WORKSPACE
    was = torch.are_deterministic_algorithms_enabled()
    with TR.deterministic(cuda):
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert torch.are_deterministic_algorithms_enabled() == was
    with TR.deterministic(torch.device("cpu")):    # the CPU: no change
        assert torch.are_deterministic_algorithms_enabled() == was


def test_split_microbatch_matches_reference():
    x = np.arange(4 * 6 * 3).reshape(4, 6, 3)
    for gb in (4, 6):
        want = np.asarray(JTR._split_microbatch(jnp.asarray(x), 2, gb))
        got = TR._split_microbatch(torch.from_numpy(x), 2, gb).numpy()
        assert np.array_equal(got, want)
    s = torch.tensor(5)
    assert TR._split_microbatch(s, 3, 4).tolist() == [5, 5, 5]


# -- the dense GQA config copies ----------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_config_forward_and_train_step_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    assert registry.microbatches(arch, "train_4k") \
        == jregistry.microbatches(arch, "train_4k")
    jstate, state = _state(arch)
    toks = _tokens(9, cfg, B=2, S=32)
    B, S = toks.shape
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    x = jstate["params"]["embed"]["tok"][jnp.asarray(toks)]
    jh, _ = JT.backbone_forward(jstate["params"], jcfg, x, pos)
    with torch.no_grad():
        h = state["params"](torch.from_numpy(toks))
    assert float(np.abs(h.numpy() - np.asarray(jh)).max()) <= 1e-4
    jstep = jax.jit(JTR.make_train_step(jcfg, JO.OptConfig(lr=LR),
                                        global_batch=2))
    _, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
    _, m = TR.make_train_step(cfg, O.OptConfig(lr=LR), global_batch=2)(
        state, {"tokens": torch.from_numpy(toks)})
    assert _rel(m["loss"], jm["loss"]) <= LOSS_TOL
    assert _rel(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_copy_the_reference(arch):
    for port, ref in ((registry.get(arch), jregistry.get(arch)),
                      (registry.get_smoke(arch), jregistry.get_smoke(arch))):
        assert port.replace(dtype=None).__dict__ \
            == ref.replace(dtype=None).__dict__


# -- launcher -----------------------------------------------------------------

def test_launch_train_runs_on_cpu(tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--steps", "2", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=internlm2-smoke" in out and "done" in out


def test_launch_train_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--arch", "yi-6b", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    launch_train.main(args + ["--steps", "2"])
    launch_train.main(args + ["--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert "ckpt step 2 committed=True" in out
    assert "resumed from committed step 2" in out
