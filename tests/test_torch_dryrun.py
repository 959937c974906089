"""The port's dry run (``repro_torch.launch.dryrun``) and model counts
(``repro_torch.analysis.roofline``) against the JAX package's, for every
architecture × shape cell.

``input_specs`` keeps the reference's shapes (tokens, labels and the
decode index are int64 in the port, int32 in the reference);
``cell_applicable``, ``active_params`` and ``model_flops`` equal the
reference's (FLOPs within 1e-12 relative). A cell's
``argument_bytes_per_device`` equals the bytes that the reference's
specs give the port's leaves (its state's, parameters', cache's and
batch's PartitionSpecs on an ``AbstractMesh``). The whole dry run over
every arch × shape × both meshes writes no error record, and its skipped
records are the reference's ``long_500k`` skips.
"""
from __future__ import annotations

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.analysis import roofline as JRF  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import SHAPES as JSHAPES  # noqa: E402
from repro.models.common import param_count  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402

# the reference's launcher asks XLA for 512 placeholder host devices when
# it is imported (``repro/launch/dryrun.py:1-2``); this process and the
# processes it starts keep the setting they had
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JDR  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS
from repro_torch.analysis import roofline as RF  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models.common import SHAPES, tree_bytes  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

ARCHS = registry.ARCHS
FLOPS_REL = 1e-12
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


_REF_ACTIVE_PARAMS = JRF.active_params


@functools.lru_cache(maxsize=None)
def ref_active_params(arch):
    return _REF_ACTIVE_PARAMS(arch)


def test_shapes_match_reference():
    assert list(SHAPES) == list(JSHAPES)
    for name, cell in SHAPES.items():
        j = JSHAPES[name]
        assert (cell.name, cell.seq_len, cell.global_batch, cell.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_applicability_match_reference(arch):
    """Every shape cell: the same input keys and shapes as the
    reference's ``input_specs`` (on the meta device; the port's integer
    inputs other than positions are int64), the same
    ``batch_shardings`` specs on both production meshes, and the same
    ``cell_applicable``."""
    cfg, jcfg = registry.get(arch), JR.get(arch)
    for shape in SHAPES:
        assert DR.cell_applicable(cfg, shape) == \
            JDR.cell_applicable(jcfg, shape)
        got, want = DR.input_specs(cfg, shape), JDR.input_specs(jcfg, shape)
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == want[k].shape, (shape, k)
            jdt = np.dtype(want[k].dtype).name
            tdt = str(v.dtype).split(".")[-1]
            assert tdt == ("int64" if jdt == "int32" and k != "positions"
                           else jdt), (shape, k)
        for multi, (sizes, names) in MESHES.items():
            tm = MESH.ModelMesh(names, sizes)
            jsh = JDR.batch_shardings(AbstractMesh(sizes, names), want)
            tsh = DR.batch_shardings(tm, got)
            assert {k: s.spec for k, s in tsh.items()} == \
                {k: tuple(s.spec) for k, s in jsh.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_match_reference(arch, monkeypatch):
    """(total, active) parameters, and the useful FLOPs of every shape
    cell, within 1e-12 relative (the reference's ``active_params`` cached
    per arch: it builds the abstract model on each call)."""
    monkeypatch.setattr(JRF, "active_params", ref_active_params)
    jt, ja = ref_active_params(arch)
    t, a = RF.active_params(arch)
    assert t == jt and abs(a - ja) <= FLOPS_REL * ja
    for shape, cell in SHAPES.items():
        rec = dict(arch=arch, kind=cell.kind, global_batch=cell.global_batch,
                   seq_len=cell.seq_len)
        want = JRF.model_flops(rec)
        assert abs(RF.model_flops(rec) - want) <= FLOPS_REL * want, shape


def _shard_bytes(shape, spec, mesh: AbstractMesh, itemsize: int) -> int:
    n = 1
    for dim, entry in zip(shape, tuple(spec)):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        k = int(np.prod([mesh.shape[a] for a in names])) if names else 1
        assert dim % k == 0
        n *= dim // k
    return n * itemsize


def _ref_argument_bytes(arch, shape, multi) -> int:
    """Σ over the cell's arguments of the reference's spec applied to the
    port's leaf: the reference's abstract state (train) or parameters and
    cache (decode), their PartitionSpecs on the abstract production mesh,
    and its batch's specs on the port's batch leaves (whose integer
    dtypes differ)."""
    jcfg, cell = JR.get(arch), JSHAPES[shape]
    m = AbstractMesh(*MESHES[multi])
    total = 0
    port_batch = DR.input_specs(registry.get(arch), shape)
    jbatch = JDR.input_specs(jcfg, shape)
    for k, s in JDR.batch_shardings(m, jbatch).items():
        total += _shard_bytes(jbatch[k].shape, s.spec, m,
                              port_batch[k].element_size())
    if cell.kind == "train":
        params, _ = JT.init_lm(jcfg, jax.random.PRNGKey(0), abstract=True)
        kind = JO.choose_optimizer(param_count(params))
        tree, axes = JTR.make_state(jcfg, JO.OptConfig(kind=kind),
                                    abstract=True)
        shard = JS.tree_shardings(m, tree, axes)
    else:
        tree, axes = JT.init_lm(jcfg, jax.random.PRNGKey(0), abstract=True)
        shard = JS.tree_shardings(m, tree, axes)
    for leaf, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shard)):
        total += _shard_bytes(leaf.shape, s.spec, m, leaf.dtype.itemsize)
    if cell.kind == "decode":
        spec = JD.cache_spec(jcfg, cell.global_batch, cell.seq_len)
        flat = jax.tree.leaves(spec, is_leaf=lambda x: isinstance(x, tuple)
                               and len(x) == 2 and isinstance(x[0], tuple))
        for (shp, dt), s in zip(flat, jax.tree.leaves(
                JS.cache_shardings(m, spec))):
            total += _shard_bytes(shp, s.spec, m, np.dtype(dt).itemsize)
    return total


@pytest.mark.parametrize("arch,shape,multi", [
    ("deepseek-v3-671b", "train_4k", True),
    ("deepseek-v3-671b", "decode_32k", False),
    ("rwkv6-3b", "long_500k", True),
    ("hymba-1.5b", "long_500k", False),
    ("qwen2-vl-7b", "train_4k", False),
    ("whisper-small", "prefill_32k", True)])
def test_argument_bytes_match_reference_specs(arch, shape, multi):
    """``lower_cell``'s ``argument_bytes_per_device`` against the sum the
    reference's specs give, and the record's other keys against the
    reference's (optimizer, microbatches, parameter count, gradient
    dtype)."""
    rec = DR.lower_cell(arch, shape, multi)
    assert rec["status"] == "ok"
    assert rec["argument_bytes_per_device"] == \
        _ref_argument_bytes(arch, shape, multi)
    assert rec["argument_bytes_per_device"] == \
        sum(rec["argument_bytes_by_input"].values())
    assert rec["chips"] == (512 if multi else 256)
    params, _ = JT.init_lm(JR.get(arch), jax.random.PRNGKey(0), abstract=True)
    n = param_count(params)
    assert rec["params"] == n
    if rec["kind"] == "train":
        assert rec["opt"] == JO.choose_optimizer(n)
        assert rec["microbatches"] == JR.microbatches(arch, shape)
        assert rec["grad_dtype"] == ("bfloat16" if n >= 3e11 else "float32")


def test_dryrun_main_writes_no_error(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch all --shape all --mesh
    both``: every cell ``ok`` but the reference's ``long_500k`` skips, at
    the reference's reasons; a second run keeps the cached records."""
    out = tmp_path / "dry.json"
    DR.main(["--arch", "all", "--shape", "all", "--mesh", "both", "--out",
             str(out)])
    recs = json.loads(out.read_text())
    assert len(recs) == len(ARCHS) * len(SHAPES) * 2
    assert not [r for r in recs if r["status"] == "error"]
    skipped = {(r["arch"], r["shape"], r["mesh"]) for r in recs
               if r["status"] == "skipped"}
    want = set()
    for arch in ARCHS:
        for shape in SHAPES:
            ok, why = JDR.cell_applicable(JR.get(arch), shape)
            if not ok:
                want |= {(arch, shape, "single"), (arch, shape, "multi")}
                assert all(r["reason"] == why for r in recs
                           if (r["arch"], r["shape"]) == (arch, shape))
    assert skipped == want and want
    for r in recs:
        if r["status"] == "ok":
            assert r["argument_bytes_per_device"] > 0
            assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
    assert "done: 64 ok, 16 skipped(spec), 0 errors" in capsys.readouterr().out
    DR.main(["--arch", "yi-6b", "--shape", "train_4k", "--mesh", "single",
             "--out", str(out)])
    assert "[skip-cached]" in capsys.readouterr().out


def test_state_bytes_per_device_on_the_host_mesh():
    """At the (1, 1) host mesh one device holds the whole state: the
    meta state's bytes, which are those of the state on the CPU."""
    cfg = registry.get_smoke("yi-6b")
    opt = O.OptConfig(kind="adafactor")
    state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    host = MESH.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1}
    assert DR.state_bytes_per_device(cfg, opt, host) == tree_bytes(state)
