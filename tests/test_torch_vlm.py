"""The port's vision-language family (qwen2-vl-7b: a dense GQA backbone
with M-RoPE over stub embeddings) against the JAX package, on its smoke
config (3 layers, d 128, sections (4, 6, 6)) in f32 on the CPU.

Both packages run the same weights (the reference's ``init_lm`` or
``make_state`` tree, carried to the port through ``convert``) and the
same numpy-made embeddings and positions. Every position input has three
streams that differ: with equal streams M-RoPE is plain RoPE, and a test
could not tell the two apart. Tolerances are the repo's: layers 2e-5,
whole-model logits 1e-4, losses 2e-5 relative, gradients 1e-5 times the
leaf's largest magnitude (floored at 1e-2).

The reference's chunked ``prefill`` swaps the position streams and the
rows of a chunk of 3 rows (B = 12: 4 chunks of 3); the port's does not
(``test_prefill_chunks_of_three_rows``, ROADMAP.md queue 3).
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
from repro.runtime import data as JDATA  # noqa: E402
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

ARCH = "qwen2-vl-7b"
LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
LOSS_TOL = 2e-5
GRAD_TOL = 1e-5
LR = 1e-3
# text, an image of rows x cols patches, text: 64 positions
LAYOUT_64 = [("text", 8), ("image", 6, 8), ("text", 8)]


class Model:
    """qwen2vl-smoke in f32 in both packages, on the same weights."""

    def __init__(self):
        self.jcfg = jregistry.get_smoke(ARCH).replace(dtype=jnp.float32)
        self.cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32)
        self.jparams, _ = JT.init_lm(self.jcfg, jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.lm = convert.lm_params_from_jax(self.tree, self.cfg, "cpu")
        self.jstep = jax.jit(
            lambda p, b, c: JD.decode_step(p, self.jcfg, b, c))

    def layer(self, i: int = 0):
        jl = jax.tree.map(lambda x: x[i], self.jparams["segments"]["seg0"])
        return jl, self.lm["segments"]["seg0"][i]


@pytest.fixture(scope="module")
def model():
    return Model()


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _streams(seed, B, S, hi=64):
    """[3, B, S] int32 positions drawn independently in each stream."""
    pos = np.random.default_rng(seed).integers(0, hi, (3, B, S))
    assert not (np.array_equal(pos[0], pos[1])
                or np.array_equal(pos[1], pos[2]))
    return pos.astype(np.int32)


def _layout(layout, B):
    """The Qwen2-VL layout's positions as numpy, and the next text id."""
    pos, nxt = L.mrope_positions(layout, B, "cpu")
    return pos.numpy(), nxt


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _rel(a, b) -> float:
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _vlm_batch(seed, cfg, B, S) -> dict:
    """tokens (the labels too), stub embeddings and 3-D positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    return {"tokens": toks, "labels": toks,
            "embeds": rng.standard_normal((B, S, cfg.d_model))
            .astype(np.float32),
            "positions": _streams(seed + 1, B, S, hi=S)}


# -- config, registry, weights ------------------------------------------------

def test_registry_has_the_vlm_config():
    for port, ref in ((registry.get(ARCH), jregistry.get(ARCH)),
                      (registry.get_smoke(ARCH), jregistry.get_smoke(ARCH))):
        assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert port.replace(dtype=None).__dict__ \
            == ref.replace(dtype=None).__dict__
    assert registry.microbatches(ARCH, "train_4k") \
        == jregistry.microbatches(ARCH, "train_4k") == 2
    assert ARCH in registry.ARCHS and ARCH not in registry.NOT_PORTED


def test_convert_round_trip(model):
    """The reference's vlm tree goes to the port and back unchanged, and
    the port's initialiser draws the same layout."""
    back = convert.lm_params_to_numpy(model.lm)
    assert jax.tree.all(jax.tree.map(np.array_equal, model.tree, back))
    mine = convert.lm_params_to_numpy(T.init_lm(
        registry.get_smoke(ARCH), torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.map(np.shape, mine) == jax.tree.map(np.shape, model.tree)


# -- M-RoPE -------------------------------------------------------------------

def test_apply_rope_mrope_matches_reference():
    """3-D positions: each section takes its own stream. The result
    differs from the standard rotation by any one stream."""
    x = _rand(0, 2, 24, 4, 32)
    pos = _streams(1, 2, 24)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       (4, 6, 6))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 6, 6))
    assert _err(got, want) < LAYER_TOL
    for s in range(3):
        plain = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos[s]), 1e6)
        assert _err(got, plain) > 0.1
    with pytest.raises(ValueError, match="sum to"):
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                     (4, 6, 4))


def test_apply_rope_2d_positions_under_sections_match_reference():
    """2-D positions with sections take the standard rotation, as in the
    reference (text-only serving of the vlm config)."""
    x = _rand(2, 2, 24, 4, 32)
    pos = np.random.default_rng(3).integers(0, 500, (2, 24))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       (4, 6, 6))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 6, 6))
    assert _err(got, want) < LAYER_TOL
    assert torch.equal(got, L.apply_rope(torch.from_numpy(x),
                                         torch.from_numpy(pos), 1e6))


def test_mrope_positions_follow_the_qwen2_vl_layout():
    """Text: one id in all streams; an image's patches: temporal id s,
    s + row, s + col; the next segment at the largest id plus 1."""
    pos, nxt = _layout([("text", 2), ("image", 2, 3), ("text", 2)], 2)
    want = np.array([[0, 1, 2, 2, 2, 2, 2, 2, 5, 6],
                     [0, 1, 2, 2, 2, 3, 3, 3, 5, 6],
                     [0, 1, 2, 3, 4, 2, 3, 4, 5, 6]])
    assert pos.shape == (3, 2, 10) and pos.dtype == np.int32
    assert np.array_equal(pos[:, 0], want) and np.array_equal(pos[:, 1],
                                                              want)
    assert nxt == 7
    pos, nxt = _layout([("image", 4, 2)], 1)
    assert nxt == 4 and pos[1, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(ValueError, match="segment"):
        L.mrope_positions([("video", 2)], 1)


@pytest.mark.parametrize("Sq", [64, 1024])
def test_gqa_apply_prefill_mrope(model, Sq):
    """S = 64 takes the reference's direct softmax, S = 1024 its blockwise
    ``flash_attend``; the positions are the layout's (text, an image,
    text), whose streams differ on the image's rows."""
    jl, tl = model.layer(1)
    x = _rand(Sq, 2, Sq, model.cfg.d_model)
    layout = LAYOUT_64 if Sq == 64 else \
        [("text", 32), ("image", 30, 32), ("text", 32)]
    pos, _ = _layout(layout, 2)
    assert pos.shape[-1] == Sq
    got, nc = L.gqa_apply(tl["attn"], model.cfg, torch.from_numpy(x),
                          torch.from_numpy(pos), window=-1)
    want, _ = JL.gqa_apply(jl["attn"], model.jcfg, jnp.asarray(x),
                           jnp.asarray(pos), window=-1)
    assert nc is None
    assert _err(got, want) < LAYER_TOL


# -- prefill and decode -------------------------------------------------------

@pytest.mark.parametrize("B", [2, 8])
def test_prefill_with_embeds_matches_reference(model, B):
    """B = 8 runs as 4 chunks of 2 rows in both packages."""
    batch = _vlm_batch(20 + B, model.cfg, B, 32)
    del batch["tokens"], batch["labels"]
    got, cache = D.prefill(model.lm, model.cfg, _t(batch))
    want, _ = JD.prefill(model.jparams, model.jcfg, _j(batch))
    assert cache is None and got.shape == (B, model.cfg.vocab)
    assert _err(got, want) < MODEL_TOL


def test_prefill_chunks_of_three_rows(model):
    """B = 12 runs as 4 chunks of 3 rows. The port's chunked prefill
    equals its unchunked one and the reference's unchunked one; the
    reference's chunked one reads each chunk's positions as [rows, 3, S]
    and lands farther off than the tolerance (ROADMAP.md queue 3)."""
    B, S = 12, 16
    rng = np.random.default_rng(30)
    batch = {"embeds": rng.standard_normal((B, S, model.cfg.d_model))
             .astype(np.float32),
             "positions": rng.integers(0, 64, (3, B, S)).astype(np.int32)}
    chunked, _ = D.prefill(model.lm, model.cfg, _t(batch))
    whole, _ = D.prefill(model.lm, model.cfg, _t(batch), batch_chunks=1)
    ref_whole, _ = JD.prefill(model.jparams, model.jcfg, _j(batch),
                              batch_chunks=1)
    ref_chunked, _ = JD.prefill(model.jparams, model.jcfg, _j(batch))
    assert _err(chunked, whole) < MODEL_TOL
    assert _err(chunked, ref_whole) < MODEL_TOL
    assert _err(ref_chunked, ref_whole) > MODEL_TOL
    # the chunks of 2 rows (B = 8) are where the reference is right
    small = {"embeds": batch["embeds"][:8],
             "positions": batch["positions"][:, :8]}
    assert _err(JD.prefill(model.jparams, model.jcfg, _j(small))[0],
                JD.prefill(model.jparams, model.jcfg, _j(small),
                           batch_chunks=1)[0]) < MODEL_TOL


def _decode(model, embeds, pos, port: bool, spare: int = 0):
    """Teacher-forced decode of ``embeds`` [B,S,D] at ``pos`` [3,B,S]:
    step t writes cache slot t and rotates by pos[:, :, t]. The logits of
    every step and the final cache (of S + ``spare`` slots)."""
    B, S = embeds.shape[:2]
    outs = []
    if port:
        cache = D.cache_zeros(D.cache_spec(model.cfg, B, S + spare), "cpu")
        for t in range(S):
            lg, cache = D.decode_step(model.lm, model.cfg, {
                "embeds": torch.from_numpy(embeds[:, t:t + 1].copy()),
                "positions": torch.from_numpy(pos[:, :, t:t + 1].copy()),
                "index": t}, cache)
            outs.append(lg.numpy())
    else:
        cache = JD.cache_zeros(JD.cache_spec(model.jcfg, B, S + spare))
        for t in range(S):
            lg, cache = model.jstep(model.jparams, {
                "embeds": jnp.asarray(embeds[:, t:t + 1]),
                "positions": jnp.asarray(pos[:, :, t:t + 1]),
                "index": jnp.int32(t)}, cache)
            outs.append(np.asarray(lg))
    return np.stack(outs, axis=1), cache


def test_decode_step_with_embeds_matches_reference(model):
    """A prompt of text, an image and text: after the image the rotary
    position is below the cache index. Every step's logits and the cache
    after the last equal the reference's."""
    layout = [("text", 4), ("image", 3, 4), ("text", 4)]
    pos, _ = _layout(layout, 2)
    assert pos.shape[-1] == 20 and pos[0, 0, -1] < 19
    embeds = _rand(40, 2, 20, model.cfg.d_model)
    got, cache = _decode(model, embeds, pos, port=True)
    want, jcache = _decode(model, embeds, pos, port=False)
    assert _err(got, want) < MODEL_TOL
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, leaf in flat:
        mine = cache
        for p in path:
            mine = mine[p.key]
        assert tuple(mine.shape) == leaf.shape
        assert _err(mine, leaf) < MODEL_TOL


def test_prefill_matches_teacher_forced_decode(model):
    """Prefill over the layout's embeddings against the teacher-forced
    decode of the same prompt (the port's and the reference's), then four
    greedy text steps at positions that continue the layout: the same
    tokens in both packages."""
    B = 2
    pos, nxt = _layout(LAYOUT_64, B)
    embeds = _rand(41, B, 64, model.cfg.d_model)
    pre, _ = D.prefill(model.lm, model.cfg, _t({"embeds": embeds,
                                                "positions": pos}))
    dec, big = _decode(model, embeds, pos, port=True, spare=4)
    jdec, jbig = _decode(model, embeds, pos, port=False, spare=4)
    assert _err(pre, dec[:, -1]) < MODEL_TOL
    assert _err(pre, jdec[:, -1]) < MODEL_TOL
    assert np.array_equal(pre.argmax(-1).numpy(), jdec[:, -1].argmax(-1))
    # greedy text steps: token ids, one id in all three streams
    S = 64
    tok = jtok = pre.argmax(-1)[:, None].numpy()
    for i in range(4):
        p = np.full((3, B, 1), nxt + i, np.int32)
        lg, big = D.decode_step(model.lm, model.cfg, {
            "token": torch.from_numpy(tok), "positions": torch.from_numpy(p),
            "index": S + i}, big)
        jlg, jbig = model.jstep(model.jparams, {
            "token": jnp.asarray(jtok), "positions": jnp.asarray(p),
            "index": jnp.int32(S + i)}, jbig)
        assert _err(lg, jlg) < MODEL_TOL
        tok = lg.argmax(-1)[:, None].numpy()
        jtok = np.asarray(jlg).argmax(-1)[:, None]
        assert np.array_equal(tok, jtok)


# -- training -----------------------------------------------------------------

def _state(seed=0):
    jcfg = jregistry.get_smoke(ARCH).replace(dtype=jnp.float32)
    cfg = registry.get_smoke(ARCH).replace(dtype=torch.float32)
    jstate, _ = JTR.make_state(jcfg, JO.OptConfig(lr=LR),
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


def test_lm_loss_and_gradients_match_reference():
    """The embeds branch with 3-D positions and labels; the token table
    gets no gradient in either package (the embeddings come from the
    stub frontend)."""
    jcfg, cfg, jstate, state = _state()
    batch = _vlm_batch(50, cfg, 4, 64)
    (want, jm), jgrads = jax.value_and_grad(JT.lm_loss, has_aux=True)(
        jstate["params"], jcfg, _j(batch))
    got, metrics = T.lm_loss(state["params"], cfg, _t(batch))
    assert _rel(got, want) <= LOSS_TOL
    assert _rel(metrics["ce"], jm["ce"]) <= LOSS_TOL
    grads, loss = TR.make_grad_fn(cfg, global_batch=4)(state["params"],
                                                       _t(batch))
    assert _rel(loss, want) <= LOSS_TOL
    for err, size in _leaf_errs(grads, jgrads):
        assert err <= GRAD_TOL * max(1e-2, size)
    assert not np.asarray(jgrads["embed"]["tok"]).any()
    # the sections reach the gradients: with stream 0 in all three, the
    # key projection's gradient lands far outside its tolerance
    same = dict(batch, positions=np.broadcast_to(
        batch["positions"][:1], batch["positions"].shape))
    plain, _ = TR.make_grad_fn(cfg, global_batch=4)(state["params"],
                                                    _t(same))
    wk = [p for p, _, _ in reference_leaves(state["params"])].index(
        ("segments", "seg0", "attn", "wk"))
    err, size = _leaf_errs(plain, jgrads)[wk]
    assert err > 100 * GRAD_TOL * max(1e-2, size)


def test_split_microbatch_carries_vlm_fields():
    """positions [3, B, S] split on axis 1, embeds [B, S, D] on axis 0,
    as the reference's rule splits them."""
    pos = np.arange(3 * 4 * 5).reshape(3, 4, 5)
    emb = np.arange(4 * 5 * 2).reshape(4, 5, 2)
    for x in (pos, emb):
        want = np.asarray(JTR._split_microbatch(jnp.asarray(x), 2, 4))
        got = TR._split_microbatch(torch.from_numpy(x), 2, 4).numpy()
        assert np.array_equal(got, want)
    assert TR._split_microbatch(torch.from_numpy(pos), 2, 4).shape \
        == (2, 3, 2, 5)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Three AdamW steps on vlm batches: loss and grad_norm at each, the
    parameters after the last (2·lr + 1e-6: AdamW's first step is
    lr·sign(g))."""
    jcfg, cfg, jstate, state = _state()
    jstep = jax.jit(JTR.make_train_step(jcfg, JO.OptConfig(lr=LR),
                                        microbatches=microbatches,
                                        global_batch=4))
    step = TR.make_train_step(cfg, O.OptConfig(lr=LR),
                              microbatches=microbatches, global_batch=4)
    for i in range(3):
        batch = _vlm_batch(60 + i, cfg, 4, 32)
        jstate, jm = jstep(jstate, _j(batch))
        state, m = step(state, _t(batch))
        assert _rel(m["loss"], jm["loss"]) <= LOSS_TOL
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
    assert int(state["step"]) == int(jstate["step"]) == 3
    got = convert.train_state_to_numpy(state)["params"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate["params"])):
        assert float(np.abs(a - np.asarray(b)).max()) <= 2 * LR + 1e-6


def test_batch_source_vlm_fields():
    """The stub frontend's fields: shapes and dtypes of the reference's,
    its positions (the token index in all three streams) and labels (the
    tokens), the same content for the same (seed, index)."""
    cfg = registry.get_smoke(ARCH)
    src = ShardedBatchSource(cfg.vocab, 2, 16, seed=3, device="cpu",
                             d_model=cfg.d_model, family="vlm")
    ref = JDATA.ShardedBatchSource(cfg.vocab, 2, 16, seed=3,
                                   d_model=cfg.d_model, family="vlm") \
        .batch(5)
    got = src.batch(5)
    assert got.keys() == ref.keys()
    for k in got:
        assert tuple(got[k].shape) == ref[k].shape, k
    assert np.array_equal(got["positions"].numpy(),
                          np.asarray(ref["positions"]))
    assert got["positions"].dtype == torch.int32
    assert torch.equal(got["labels"], got["tokens"])
    again = src.batch(5)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["embeds"], src.batch(6)["embeds"])
    dense = ShardedBatchSource(cfg.vocab, 2, 16, seed=3, device="cpu")
    assert dense.batch(5).keys() == {"tokens"}
    assert torch.equal(dense.batch(5)["tokens"], got["tokens"])


# -- launchers ----------------------------------------------------------------

def test_launch_train_vlm_on_cpu(tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=qwen2vl-smoke" in out and "done" in out


def test_launch_serve_vlm_on_cpu(model, capsys):
    """Text-only serving, as the reference's launcher runs the vlm
    config; ``generate`` picks the reference's greedy tokens."""
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=qwen2vl-smoke batch=2 prompt=4 new=3" in out
    P, N = 5, 4
    prompts = np.random.default_rng(70).integers(0, model.cfg.vocab, (2, P))
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
