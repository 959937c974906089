"""The port's layout layer against the JAX package's, value for value:
logical axes (``models.transformer.param_axes``, ``train.optimizer.
opt_axes``, ``train.trainer.state_axes``), the layout rules
(``launch.sharding``: ``spec_for``, ``batch_pspec``, ``cache_shardings``,
the DTensor placements), the meshes (``launch.mesh``), the activation
constraints (``models.pconstraint``) and the small host helpers the port
took over with them (``dissem.batcher.plan_batches``/``batch_wire_sizes``,
``engine.merge.oracle_is_legal_interleaving``, the dense ticks,
``decode.cache_abstract``, ``ssm.rwkv6_state_spec``,
``common.tree_bytes``).

The reference side is abstract (``abstract=True`` trees and
``jax.sharding.AbstractMesh`` meshes: its production meshes need 512
devices); the port side is on the meta device. The port keeps one
parameter tree per layer where the reference stacks a segment's layers
along a leading "layers" axis, which no rule shards: a per-layer leaf's
axes and spec are the stacked leaf's without their first entry. One
spawned world of 4 gloo ranks (``tests/_torch_sharding_child.py``)
places the smoke states of qwen3-14b and deepseek-v3-671b on the (2, 2)
host mesh: each rank's block must equal the numpy block the reference's
spec names, and the reassembled tensor the leaf, bit for bit.
"""
from __future__ import annotations

import functools
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.dissem import batcher as JB  # noqa: E402
from repro.dissem import engine as JDE  # noqa: E402
from repro.engine import merge as JM  # noqa: E402
from repro.engine import sharded as JSH  # noqa: E402
from repro.launch import mesh as JMESH  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import pconstraint as JP  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.dissem import batcher as B  # noqa: E402
from repro_torch.dissem import engine as DE  # noqa: E402
from repro_torch.engine import merge as M  # noqa: E402
from repro_torch.engine import sharded as SHD  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import pconstraint as P  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

ARCHS = registry.ARCHS
KINDS = ("adamw", "adafactor")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "host4": ((2, 2), ("data", "model")),
          "host1": ((1, 1), ("data", "model"))}
CHILD = Path(__file__).resolve().parent / "_torch_sharding_child.py"
CHILD_ARCHS = ("qwen3-14b", "deepseek-v3-671b")
CHILD_TIMEOUT_S = 60


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _keys(path) -> tuple:
    return tuple(k.key for k in path)


def _flat(tree) -> list:
    """(key path, leaf) pairs of a reference tree whose leaves are
    logical axes or arrays."""
    return [(_keys(p), v) for p, v in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=_is_axes)[0]]


def jmesh(name):
    return AbstractMesh(*MESHES[name])


def tmesh(name):
    return MESH.ModelMesh(MESHES[name][1], MESHES[name][0])


@functools.lru_cache(maxsize=None)
def ref_state(arch, kind):
    return JTR.make_state(JR.get(arch), JO.OptConfig(kind=kind),
                          abstract=True)


@functools.lru_cache(maxsize=None)
def port_state(arch, kind):
    cfg, opt = registry.get(arch), O.OptConfig(kind=kind)
    state = TR.make_state(cfg, opt, None, "meta")
    return state, TR.state_axes(cfg, opt, state["params"])


# -- logical axes -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch):
    """Every parameter leaf's axes, full size: the port's per-layer axes
    are the reference's stacked axes without their leading "layers"."""
    _, jaxes = JT.init_lm(JR.get(arch), jax.random.PRNGKey(0), abstract=True)
    want = _flat(jaxes)
    got = C.reference_leaves(T.param_axes(registry.get(arch)))
    assert [p for p, _ in want] == [p for p, _, _ in got]
    for (path, w), (_, axes, stacked) in zip(want, got):
        assert all(a == axes[0] for a in axes), path
        assert (("layers", *axes[0]) if stacked else axes[0]) == w, path
    # and the port's parameters carry exactly these leaves, shape for shape
    lm = T.init_lm(registry.get(arch), None, "meta")
    shapes = S.tree_map(lambda p, a: len(p.shape) == len(a), lm,
                        T.param_axes(registry.get(arch)))
    assert all(S.leaves(shapes))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_axes_match_reference(arch, kind):
    """``state_axes`` against the second value of the reference's
    ``make_state``: the optimizer state's axes leaf for leaf (AdamW's m
    and v, Adafactor's factored vr and vc), and the step's ``()``."""
    _, jaxes = ref_state(arch, kind)
    _, axes = port_state(arch, kind)
    assert _flat(axes["opt"]) == _flat(jaxes["opt"])
    assert axes["step"] == jaxes["step"] == ()


def test_make_state_on_meta_matches_reference_shapes():
    """``make_state(cfg, opt, None, "meta")`` builds the state without
    storage; the optimizer state's shapes and dtypes are the reference's
    abstract ones."""
    state, _ = port_state("deepseek-v3-671b", "adafactor")
    jstate, _ = ref_state("deepseek-v3-671b", "adafactor")
    assert state["step"].device.type == "meta"
    assert all(t.device.type == "meta" for t in state["params"].parameters())
    want = _flat(jstate["opt"])
    got = _flat(state["opt"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, w) in zip(got, want):
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32, path


# -- layout rules -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_every_state_leaf_matches_reference(arch):
    """``spec_for`` on every leaf of the train state (both optimizers) on
    both production meshes and the 4-rank host mesh: the port's spec is
    ``tuple()`` of the reference's PartitionSpec (a per-layer leaf's,
    without the stacked leaf's first entry), and the per-device bytes of
    the port's per-layer leaves sum to the stacked leaf's."""
    for kind in KINDS:
        jstate, jaxes = ref_state(arch, kind)
        state, axes = port_state(arch, kind)
        jp = dict(_flat(jstate["params"]))
        ja = dict(_flat(jaxes["params"]))
        for name in ("single", "multi", "host4"):
            m, tm = jmesh(name), tmesh(name)
            for (path, tensors, stacked), (_, pax, _) in zip(
                    C.reference_leaves(state["params"]),
                    C.reference_leaves(axes["params"]), strict=True):
                want = tuple(JS.spec_for(m, jp[path].shape, ja[path]))
                for t, ax in zip(tensors, pax, strict=True):
                    got = S.spec_for(tm, tuple(t.shape), ax)
                    assert got == (want[1:] if stacked else want), \
                        (name, path)
                sh = S.Sharding(tm, got)
                whole = S.Sharding(tm, want)
                assert sum(sh.shard_bytes(t) for t in tensors) == \
                    int(np.prod(whole.shard_shape(jp[path].shape))) \
                    * tensors[0].element_size()
            want = [(p, tuple(s.spec)) for p, s in _flat(
                JS.tree_shardings(m, jstate["opt"], jaxes["opt"]))]
            got = [(p, s.spec) for p, s in _flat(S.tree_shardings(
                tm, state["opt"], axes["opt"]))]
            assert got == want, name


def test_batch_pspec_matches_reference():
    """Every batch shape of the dry run's cells, batch and sequence dims
    as the launchers pass them, on all four meshes."""
    shapes = [((256, 4096), 0, 1), ((32, 32768), 0, 1), ((128, 1), 0, 1),
              ((1, 1), 0, 1), ((1, 524288), 0, 1), ((3, 32, 32768), 1, None),
              ((3, 1, 1), 1, None), ((256, 1500, 768), 0, 1),
              ((2, 7), 0, 1), ((6, 8), 0, None), ((48, 10), 0, 1)]
    for name in MESHES:
        for shape, bdim, sdim in shapes:
            want = tuple(JS.batch_pspec(jmesh(name), shape, batch_dim=bdim,
                                        seq_dim=sdim))
            assert S.batch_pspec(tmesh(name), shape, batch_dim=bdim,
                                 seq_dim=sdim) == want, (name, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch):
    """``cache_shardings`` of the arch's decode cells (decode_32k,
    long_500k) on both production meshes, leaf for leaf, and the port's
    cache spec is the reference's."""
    for shape in ("decode_32k", "long_500k"):
        cell = C.SHAPES[shape]
        spec = D.cache_spec(registry.get(arch), cell.global_batch,
                            cell.seq_len)
        jspec = JD.cache_spec(JR.get(arch), cell.global_batch, cell.seq_len)
        for name in ("single", "multi"):
            want = [(p, tuple(s.spec)) for p, s in jax.tree_util.
                    tree_flatten_with_path(JS.cache_shardings(
                        jmesh(name), jspec))[0]]
            got = S.cache_shardings(tmesh(name), spec)
            assert len(S.leaves(got)) == len(want)
            for path, w in want:
                leaf = got
                for k in _keys(path):
                    leaf = leaf[k]
                assert leaf.spec == w, (shape, name, path)


def test_meshes_match_reference(monkeypatch):
    """The production meshes' shapes and names, ``mesh_axes`` and
    ``fsdp_axes``, and the host mesh over 1 and 4 devices, against the
    reference's functions (its ``jax.make_mesh`` and ``jax.devices``
    answered abstractly: this host has one device)."""
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, axes: AbstractMesh(shape, axes))
    for multi in (False, True):
        j = JMESH.make_production_mesh(multi_pod=multi)
        t = MESH.make_production_mesh(multi_pod=multi)
        assert t.axis_names == j.axis_names
        assert t.shape == dict(j.shape)
        assert t.device_mesh is None and t.size == (512 if multi else 256)
        stand_in = SimpleNamespace(axis_names=j.axis_names,
                                   devices=np.empty(tuple(j.shape.values())))
        assert MESH.mesh_axes(t) == JMESH.mesh_axes(stand_in)
        assert MESH.fsdp_axes(t) == JMESH.fsdp_axes(j)
    host = MESH.make_host_mesh()
    monkeypatch.setattr(jax, "devices", lambda: [None])
    assert host.shape == dict(JMESH.make_host_mesh().shape)
    assert host.device_mesh is None
    monkeypatch.setattr(jax, "devices", lambda: [None] * 4)
    assert dict(JMESH.make_host_mesh().shape) == {"data": 2, "model": 2}


def test_sharding_shapes_and_placements():
    """``shard_shape`` divides each dim by its axes' sizes; a dim split
    over ("pod", "data") takes ``Shard(d)`` on both mesh axes, in mesh
    order; an entry out of mesh order or a non-dividing dim raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh("multi")
    sh = S.Sharding(m, (("pod", "data"), None, "model"))
    assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
    assert sh.placements() == (Shard(0), Shard(0), Shard(2))
    assert S.Sharding(m, (None,)).placements() == (Replicate(),) * 3
    with pytest.raises(ValueError):
        S.Sharding(m, (("data", "pod"),)).placements()
    with pytest.raises(ValueError):
        sh.shard_shape((48, 3, 32))
    assert S.place(torch.ones(2), S.Sharding(tmesh("host1"), (None,))) \
        .device.type == "cpu"


# -- activation constraints ---------------------------------------------------

def test_pconstraint_specs_match_reference(monkeypatch):
    """``batch_spec``/``expert_spec``/``weight_spec`` (what
    ``constrain_batch``/``constrain_expert``/``weight_compute_layout``
    pin) against the spec the reference hands to
    ``jax.lax.with_sharding_constraint`` (patched to record it), on both
    production meshes and the host mesh; None where the reference
    returns its input. Without a mesh every call returns its input
    object."""
    seen = []

    def record(x, sharding):
        seen.append(tuple(sharding.spec))
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record)
    batch = [((256, 4096, 64), 0, None), ((32, 128, 40, 128), 0, None),
             ((4, 16, 8), 0, 2), ((1, 524288, 64), 0, None),
             ((48, 12, 8), 1, 0), ((512, 7, 32), 0, 2)]
    expert = [((256, 80, 64), 0), ((16, 80, 64), 0), ((8, 4, 64), 1),
              ((12, 4, 64), 0)]
    weights = [((64, 512), (1,)), ((512, 64), (0,)), ((64, 40), (1,))]
    try:
        for name in ("single", "multi", "host4"):
            JP.set_mesh(jmesh(name))
            P.set_mesh(tmesh(name))
            for shape, bdim, mdim in batch:
                seen.clear()
                x = np.zeros(shape, np.float32)
                JP.constrain_batch(x, bdim, mdim)
                assert P.batch_spec(shape, bdim, mdim) == \
                    (seen[0] if seen else None), (name, shape)
            for shape, edim in expert:
                seen.clear()
                JP.constrain_expert(np.zeros(shape, np.float32), edim)
                assert P.expert_spec(shape, edim) == \
                    (seen[0] if seen else None), (name, shape)
            for flag in (False, True):
                monkeypatch.setattr(JP, "FORCE_WEIGHT_GATHER", flag)
                monkeypatch.setattr(P, "FORCE_WEIGHT_GATHER", flag)
                for shape, dims in weights:
                    seen.clear()
                    JP.weight_compute_layout(np.zeros(shape), dims)
                    assert P.weight_spec(shape, dims) == \
                        (seen[0] if seen else None), (name, shape, flag)
            # an abstract mesh places nothing: plain tensors come back
            x = torch.ones(256, 4)
            assert P.constrain_batch(x) is x
            assert P.constrain_expert(x) is x
    finally:
        JP.set_mesh(None)
        P.set_mesh(None)
    x = torch.ones(4, 4)
    assert P.constrain_batch(x, 0, 1) is x and P.constrain_expert(x) is x
    assert P.weight_compute_layout(x, (0,)) is x
    assert P.batch_spec((4, 4)) is None and P.expert_spec((4, 4)) is None


def test_layers_call_the_constraints_where_the_reference_does(monkeypatch):
    """Each call site of the reference (q/k/v and the attention output in
    GQA, q, the expanded k/v and the output in MLA, the dispatch buffers
    in the MoE, each block's input) calls the port's constraint: counted
    through a prefill of the smoke configs on the CPU, which returns the
    same logits with and without the counting wrappers."""
    from repro_torch.models import layers as L
    calls = {"batch": 0, "expert": 0}

    def counting(kind, fn):
        def wrapped(x, *a, **kw):
            calls[kind] += 1
            return fn(x, *a, **kw)
        return wrapped
    monkeypatch.setattr(L, "constrain_batch",
                        counting("batch", P.constrain_batch))
    monkeypatch.setattr(L, "constrain_expert",
                        counting("expert", P.constrain_expert))
    monkeypatch.setattr(T, "constrain_batch",
                        counting("batch", P.constrain_batch))
    for arch, per_layer_batch, per_moe_expert in (
            ("yi-6b", 3 + 1, 0), ("deepseek-v3-671b", 3 + 1 + 1, 2)):
        cfg = registry.get_smoke(arch).replace(dtype=torch.float32)
        lm = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        calls.update(batch=0, expert=0)
        toks = torch.randint(0, cfg.vocab, (2, 8),
                             generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            lm(toks)
        n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.n_experts else 0
        assert calls["batch"] == cfg.n_layers * per_layer_batch, arch
        assert calls["expert"] == n_moe * per_moe_expert, arch


# -- 4 gloo ranks -------------------------------------------------------------

def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _block(a: np.ndarray, spec: tuple, coords: dict, sizes: dict):
    """The block of ``a`` that the mesh position ``coords`` holds under
    ``spec``: dim d split over its entry's axes, the first major (JAX's
    order for a PartitionSpec entry)."""
    idx = []
    for dim, entry in zip(a.shape, spec):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n, i = 1, 0
        for name in names:
            i = i * sizes[name] + coords[name]
            n *= sizes[name]
        step = dim // n
        idx.append(slice(i * step, (i + 1) * step))
    return a[tuple(idx)]


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), str(d / f"r{r}.json"), str(r), "4",
         str(d / "init")], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    end = time.monotonic() + CHILD_TIMEOUT_S
    errors = {}
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                errors[r] = "deadline"
                continue
            if p.returncode != 0:
                errors[r] = err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errors, errors
    return [json.loads((d / f"r{r}.json").read_text()) for r in range(4)]


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_gloo_placement_equals_reference_blocks(gloo_world):
    """4 gloo ranks: ``make_host_mesh`` is (2, 2) on ("data", "model")
    with a device mesh, rank r at (r // 2, r % 2); every leaf of the
    smoke train states of qwen3-14b and deepseek-v3-671b, placed by
    ``tree_shardings`` + ``place``, holds on each rank the numpy block
    that the reference's spec names (sha256 of the bytes), and its
    ``full_tensor()`` is the leaf bit for bit."""
    sizes = {"data": 2, "model": 2}
    m = jmesh("host4")
    for r, res in enumerate(gloo_world):
        assert res["mesh"] == sizes and res["device_mesh"]
        assert res["coords"] == [r // 2, r % 2]
    for arch in CHILD_ARCHS:
        cfg = registry.get_smoke(arch)
        state = TR.make_state(cfg, O.OptConfig(kind="adafactor"),
                              torch.Generator().manual_seed(0), "cpu")
        jstate, jaxes = JTR.make_state(JR.get_smoke(arch), JO.OptConfig(
            kind="adafactor"), abstract=True)
        jshape = dict(_flat(jstate))
        jspec = {p: tuple(s.spec) for p, s in _flat(JS.tree_shardings(
            m, jstate, jaxes))}
        want = []           # (tensor, the reference's spec), per row
        for path, tensors, stacked in C.reference_leaves(state):
            assert jshape[path].shape == ((len(tensors),) if stacked
                                          else ()) + tuple(tensors[0].shape)
            spec = jspec[path][1:] if stacked else jspec[path]
            want += [(t, spec) for t in tensors]
        for r, res in enumerate(gloo_world):
            rows = res["leaves"][arch]
            assert len(rows) == len(want)
            coords = {"data": r // 2, "model": r % 2}
            for (t, spec), row in zip(want, rows):
                got = tuple(tuple(e) if isinstance(e, list) else e
                            for e in row["spec"])
                assert got == spec, row["path"]
                assert row["full"], row["path"]
                block = _block(_numpy(t), spec, coords, sizes)
                assert list(block.shape) == row["local_shape"] \
                    == row["shard_shape"]
                assert _sha(block) == row["sha"], (arch, r, row["path"])
        n_split = sum(any(e is not None for e in s) for _, s in want)
        assert n_split > len(want) // 2, arch


def test_gloo_constraints_match_reference(gloo_world, monkeypatch):
    """``constrain_batch`` and ``constrain_expert`` on replicated DTensors
    at 4 ranks give the placements of the spec the reference constrains
    the same shape to (``with_sharding_constraint`` patched to record
    it); where the reference constrains nothing the input comes back
    itself, and a plain tensor is returned as it is."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("_child", CHILD)
    child = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(child)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    tm = tmesh("host4")

    def placements(spec):
        if spec is None:
            return "same"
        return [str(p) for p in S.Sharding(tm, spec).placements()]
    JP.set_mesh(jmesh("host4"))
    try:
        want_b, want_e = [], []
        for shape, bdim, mdim in child.BATCH_CASES:
            seen.clear()
            JP.constrain_batch(np.zeros(shape), bdim, mdim)
            want_b.append(placements(seen[0] if seen else None))
        for shape, edim in child.EXPERT_CASES:
            seen.clear()
            JP.constrain_expert(np.zeros(shape), edim)
            want_e.append(placements(seen[0] if seen else None))
    finally:
        JP.set_mesh(None)
    assert "same" in want_b and "same" in want_e
    for res in gloo_world:
        assert res["batch"] == want_b
        assert res["expert"] == want_e
        assert res["plain_same"]


# -- the small host helpers ---------------------------------------------------

@pytest.mark.parametrize("budget,max_requests", [(300, None), (300, 3),
                                                 (2000, None), (100, 2)])
def test_plan_batches_and_wire_sizes_match_reference(budget, max_requests):
    """Seeded request sizes with some far over the budget (an oversized
    request gets a batch of its own), with and without ``max_requests``;
    the empty plan; a budget below the header raises in both."""
    rng = np.random.default_rng(budget + (max_requests or 0))
    sizes = rng.integers(1, 120, 200)
    sizes[rng.integers(0, 200, 8)] = 5000
    for s in (sizes, sizes[:0], sizes[:1]):
        got = B.plan_batches(s, budget_bytes=budget, max_requests=max_requests)
        want = JB.plan_batches(s, budget_bytes=budget,
                               max_requests=max_requests)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        gw, ww = B.batch_wire_sizes(s, got), JB.batch_wire_sizes(s, want)
        assert gw.dtype == ww.dtype and np.array_equal(gw, ww)
    plan = B.plan_batches(sizes, budget_bytes=budget,
                          max_requests=max_requests)
    assert (B.batch_wire_sizes(sizes, plan) > budget).any()
    with pytest.raises(ValueError):
        B.plan_batches(sizes, budget_bytes=B.EMPTY_BATCH_BYTES)
    with pytest.raises(ValueError):
        JB.plan_batches(sizes, budget_bytes=JB.EMPTY_BATCH_BYTES)


def test_plan_batches_equals_the_accumulator():
    """The one-shot plan is the streaming accumulator's batches."""
    sizes = np.random.default_rng(3).integers(1, 400, 300)
    plan = B.plan_batches(sizes, budget_bytes=900, max_requests=5)
    acc = B.BatchAccumulator(900, max_requests=5)
    batches = [b for b in (acc.add(int(s)) for s in sizes) if b]
    batches.append(acc.flush())
    assert [len(b) for b in batches] == np.bincount(plan).tolist()


def test_legal_interleaving_oracle_matches_reference():
    """Legal merges (each group's order a prefix, any interleaving) and
    illegal ones (a reordered group, a gap, a foreign id, a duplicate)."""
    rng = np.random.default_rng(5)
    orders = [list(range(g * 100, g * 100 + 12)) for g in range(3)]
    cases = [[], M.oracle_merge(orders)]
    for _ in range(20):
        cur, merged = [0, 0, 0], []
        for g in rng.integers(0, 3, 25):
            if cur[g] < len(orders[g]):
                merged.append(orders[g][cur[g]])
                cur[g] += 1
        cases.append(merged)
    legal = list(cases)
    m = legal[-1]
    cases += [m[::-1], m[1:], m + [999], m + m[:1], [orders[0][1]]]
    for merged in cases:
        got = M.oracle_is_legal_interleaving(merged, orders)
        assert got == JM.oracle_is_legal_interleaving(merged, orders)
        assert got == (merged in legal)


def test_dense_ticks_match_reference_bit_for_bit():
    """``sharded_tick_dense`` and ``stability_tick_dense`` over seeded
    bool tiles (G = 2, W = 16, 37 acks, 5 votes, 37 holds: a partial last
    word), tick by tick: the state and every output equal the
    reference's jitted dense ticks."""
    G, W, N, SQ, T_ = 2, 16, 37, 5, 6
    rng = np.random.default_rng(11)
    acks = rng.random((T_, G, W, N)) < 0.6
    votes = rng.random((T_, G, W, SQ)) < 0.5
    holds = rng.random((T_, G, W, N)) < 0.3
    st, jst = SHD.init_sharded(G, W, N, SQ, "cpu"), \
        JSH.init_sharded(G, W, N, SQ)
    d, jd = DE.init_dissem(G, W, N, device="cpu"), JDE.init_dissem(G, W, N)
    for t in range(T_):
        st, out = SHD.sharded_tick_dense(
            st, torch.from_numpy(acks[t]), torch.from_numpy(votes[t]),
            diss_majority=N // 2 + 1, seq_majority=SQ // 2 + 1,
            order_budget=4)
        jst, jout = JSH.sharded_tick_dense(
            jst, jnp.asarray(acks[t]), jnp.asarray(votes[t]),
            diss_majority=N // 2 + 1, seq_majority=SQ // 2 + 1,
            order_budget=4)
        got = convert.engine_state_to_numpy(st)
        for f in got:
            assert np.array_equal(got[f], np.asarray(getattr(jst, f))), f
        for k in jout:
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
        d, dout = DE.stability_tick_dense(d, torch.from_numpy(holds[t]),
                                          majority=N // 2 + 1)
        jd, jdout = JDE.stability_tick_dense(jd, jnp.asarray(holds[t]),
                                             majority=N // 2 + 1)
        assert np.array_equal(convert.bits_to_numpy(d.hold_bits),
                              np.asarray(jd.hold_bits))
        assert np.array_equal(d.stable.numpy(), np.asarray(jd.stable))
        for k in jdout:
            assert np.array_equal(dout[k].numpy(), np.asarray(jdout[k])), k
        assert int(dout["newly_per_group"].sum()) == \
            int(np.asarray(jdout["newly_stable"]).sum())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-v3-671b",
                                  "whisper-small", "rwkv6-3b"])
def test_cache_abstract_and_tree_bytes_match_reference(arch):
    """``cache_abstract`` gives meta tensors of the reference's abstract
    cache's shapes and dtypes; ``tree_bytes`` of it, of the meta
    parameters and of the meta train state equals the reference's
    ``tree_bytes`` of its abstract trees."""
    cfg, jcfg = registry.get(arch), JR.get(arch)
    cache = D.cache_abstract(D.cache_spec(cfg, 4, 2048))
    jcache = JD.cache_abstract(JD.cache_spec(jcfg, 4, 2048))
    want = _flat(jcache)
    got = _flat(cache)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, w) in zip(got, want):
        assert t.device.type == "meta" and tuple(t.shape) == w.shape, path
        assert str(t.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
    assert C.tree_bytes(cache) == JC.tree_bytes(jcache)
    params, _ = JT.init_lm(jcfg, jax.random.PRNGKey(0), abstract=True)
    assert C.tree_bytes(T.init_lm(cfg, None, "meta")) == \
        JC.tree_bytes(params)
    state, _ = port_state(arch, "adafactor")
    jstate, _ = ref_state(arch, "adafactor")
    assert C.tree_bytes(state) == JC.tree_bytes(jstate)


@pytest.mark.parametrize("smoke", [False, True])
def test_rwkv6_state_spec_matches_reference(smoke):
    get, jget = ((registry.get_smoke, JR.get_smoke) if smoke
                 else (registry.get, JR.get))
    shape, dt = SSM.rwkv6_state_spec(get("rwkv6-3b"), 3)
    jshape, jdt = JSSM.rwkv6_state_spec(jget("rwkv6-3b"), 3)
    assert shape == jshape and dt == torch.float32 \
        and jnp.dtype(jdt) == jnp.float32


def test_param_factory_checks_axes():
    pf = C.ParamFactory(torch.Generator().manual_seed(0), torch.float32,
                        torch.device("cpu"))
    with pytest.raises(ValueError):
        pf.leaf((4, 4), ("embed",))
    with pytest.raises(ValueError):
        pf.ones((4,), (None, None))
    assert C.AxesFactory().leaf((4, 4), ("embed", None)) == ("embed", None)
