"""The port's meshed engine (repro_torch.engine.meshed, launch.mesh).

Two layers, every comparison exact:

* **World size 1 against the JAX package.** In this process, with a
  gloo process group of one rank, the port's meshed ``api.run``,
  ``api.tick`` and ``subtick_pass`` equal the reference's meshed twins
  at one device for all four families (merged log, count, committed
  length and the whole state through ``convert``), on
  ``tests/test_multidevice.py``'s seeded tiles. The reference's meshed
  ``adaptive_pass`` fails on this jax, so the port's is held against
  its own unmeshed pass.
* **World sizes 1–4 against the unmeshed port.** One gloo process per
  rank (``tests/_torch_mesh_child.py``) runs the reference's
  cross-device scenario set and the port's own (adaptive, subtick
  across a recycle, the pipeline with a flip); every rank of every
  world must equal the same scenarios without a mesh, and a
  row-position id base must change the merged prefix.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.engine import adaptive as JAD  # noqa: E402
from repro.engine import api as japi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.engine import adaptive as AD  # noqa: E402
from repro_torch.engine import api as tapi  # noqa: E402
from repro_torch.engine import meshed  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

G, W, D, SQ, T = 4, 16, 5, 3, 6
STRIDE = 1 << 16
FAMILIES = ["plain", "gated", "recycled", "gated_recycled"]
CHILD = Path(__file__).resolve().parent / "_torch_mesh_child.py"
WORLDS = (1, 2, 3, 4)
DEADLINE_S = 300


def family_kw(mod, fam):
    kw = {}
    if "recycled" in fam:
        kw["recycling"] = mod.RecyclingConfig(watermark=4, id_stride=STRIDE)
    if "gated" in fam:
        kw["gating"] = mod.GatingConfig()
    return kw


def config_pair(fam, **extra):
    """(reference meshed config, port meshed config)."""
    out = []
    for mod, ad in ((japi, JAD), (tapi, AD)):
        kw = dict(groups=G, window=W, n_diss=D, n_seq=SQ, order_budget=4,
                  merge_capacity=4096, **family_kw(mod, fam))
        if "adaptive" in extra:
            kw["adaptive"] = ad.AdaptiveConfig(**extra["adaptive"])
        out.append(mod.EngineConfig(**kw, mesh=mod.MeshConfig()))
    return out


def packed(seed, n, *, t=T, g=G, density=0.7):
    """``tests/test_multidevice.py``'s tiles: uint32[t, g, W, ⌈n/32⌉]."""
    rng = np.random.default_rng(seed)
    bits = rng.random((t, g, W, n)) < density
    out = np.zeros((t, g, W, (n + 31) // 32), np.uint32)
    for j in range(n):
        out[..., j // 32] |= bits[..., j].astype(np.uint32) << np.uint32(
            j % 32)
    return out


def traffic(cfg, seed):
    acks = packed(seed, D)
    votes = packed(seed + 1, SQ, density=0.6)
    holds = packed(seed + 2, cfg.gating.n_diss_partition, density=0.9) \
        if cfg.gating else None
    return acks, votes, holds


def to_ref(x):
    return None if x is None else jnp.asarray(x)


def to_port(x):
    return None if x is None else convert.bits_from_numpy(x, "cpu")


def ref_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return {f: ref_tree(getattr(tree, f)) for f in tree._fields}
    return np.asarray(tree)


def host_copy(tree):
    """A reference state rebuilt from host arrays (no sharding)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(host_copy(x) for x in tree))
    return jnp.asarray(np.asarray(tree))


def assert_tree_equal(port, ref, path="state"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            assert_tree_equal(port[k], ref[k], f"{path}.{k}")
    elif ref is None:
        assert port is None, path
    else:
        assert port.dtype == ref.dtype and port.shape == ref.shape, path
        assert np.array_equal(port, ref), path


@pytest.fixture
def gloo_world1(tmp_path):
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- world size 1, against the JAX package ------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_meshed_run_matches_reference(gloo_world1, fam):
    jc, tc = config_pair(fam)
    acks, votes, holds = traffic(tc, FAMILIES.index(fam))
    js, *jres = japi.run(jc, japi.create_state(jc), to_ref(acks),
                         to_ref(votes), to_ref(holds))
    ts, *tres = tapi.run(tc, tapi.create_state(tc, "cpu"), to_port(acks),
                         to_port(votes), to_port(holds))
    assert meshed.mesh_for(tc).backend == "gloo"
    assert int(tres[1]) == int(jres[1]) > 0
    assert int(tres[2]) == int(jres[2]) > 0
    assert np.array_equal(tres[0].numpy(), np.asarray(jres[0]))
    assert_tree_equal(convert.engine_state_to_numpy(ts, tc), ref_tree(js))


@pytest.mark.parametrize("fam", FAMILIES)
def test_meshed_tick_matches_reference(gloo_world1, fam):
    jc, tc = config_pair(fam)
    acks, votes, holds = traffic(tc, 10 + FAMILIES.index(fam))
    js, eng = japi.create_state(jc), tapi.Engine.create(tc, device="cpu")
    jtick = jax.jit(japi.tick, static_argnums=0)   # one trace, T calls
    for t in range(T):
        h = None if holds is None else holds[t]
        js, jout = jtick(jc, js, to_ref(acks[t]), to_ref(votes[t]),
                         to_ref(h))
        tout = eng.tick(to_port(acks[t]), to_port(votes[t]), to_port(h))
        assert set(tout) == set(jout) == {"assigned", "dropped"}
        assert np.array_equal(tout["assigned"].numpy(),
                              np.asarray(jout["assigned"])), t
        assert int(tout["dropped"]) == int(jout["dropped"]) == 0
    assert_tree_equal(convert.engine_state_to_numpy(eng.state, tc),
                      ref_tree(js))
    # the reference's merge gate rejects its meshed state's sharding on
    # this jax: its gate runs on a host copy
    jres = japi.committed_prefix(jc, host_copy(js))
    tres = eng.committed()
    assert np.array_equal(tres[0].numpy(), np.asarray(jres[0]))
    assert int(tres[1]) == int(jres[1]) and int(tres[2]) == int(jres[2])


@pytest.mark.parametrize("fam", FAMILIES)
def test_meshed_subtick_matches_reference(gloo_world1, fam):
    jc, tc = config_pair(fam, adaptive=dict(max_tiles_per_tick=2,
                                            policy="undecided"))
    js, ts = japi.create_state(jc), tapi.create_state(tc, "cpu")
    part = tc.gating.n_diss_partition if tc.gating else None
    jsub = jax.jit(JAD.subtick_pass, static_argnums=0)
    for t in range(8):
        a = packed(30 + t, D, t=1)[0]
        v = packed(60 + t, SQ, t=1, density=0.6)[0]
        h = None if part is None else packed(90 + t, part, t=1,
                                             density=0.9)[0]
        js, jout = jsub(jc, js, to_ref(a), to_ref(v), to_ref(h))
        ts, tout = AD.subtick_pass(tc, ts, to_port(a), to_port(v),
                                   to_port(h))
        assert int(tout["rounds"]) == int(jout["rounds"]), t
        assert int(tout["dropped"]) == 0
    assert_tree_equal(convert.engine_state_to_numpy(ts, tc), ref_tree(js))
    assert int(tapi.committed_prefix(tc, ts)[1]) > 0


def test_meshed_adaptive_pass_matches_unmeshed(gloo_world1):
    """The reference's meshed adaptive pass fails on this jax
    (ROADMAP.md queue 3): the port's is held against its own unmeshed
    pass, on the reference test's skewed queue."""
    _, mesh_cfg = config_pair("recycled", adaptive=dict(
        max_tiles_per_tick=3, policy="backlog"))
    base = meshed.unmeshed(mesh_cfg)
    acks = to_port(packed(20, D, t=8))
    votes = to_port(packed(21, SQ, t=8, density=0.6))
    lengths = [8, 2, 5, 1]
    sb, sm = (tapi.create_state(c, "cpu") for c in (base, mesh_cfg))
    qb, qm = (AD.queue_from_arrays(c, acks, votes, lengths=lengths)
              for c in (base, mesh_cfg))
    for i in range(5):
        sb, qb, ob = AD.adaptive_pass(base, sb, qb)
        sm, qm, om = AD.adaptive_pass(mesh_cfg, sm, qm)
        assert int(ob["rounds"]) == int(om["rounds"]), i
        assert torch.equal(ob["consumed"], om["consumed"]), i
        assert int(om["dropped"]) == 0
    assert torch.equal(qb.head, qm.head)
    assert_tree_equal(convert.engine_state_to_numpy(sm, mesh_cfg),
                      convert.engine_state_to_numpy(sb))
    rb, rm = (tapi.committed_prefix(c, s) for c, s in ((base, sb),
                                                       (mesh_cfg, sm)))
    assert all(torch.equal(x, y) for x, y in zip(rb, rm))
    assert int(rm[1]) > 0


def test_meshed_state_from_reference(gloo_world1):
    """A reference state carried into a meshed config and back."""
    jc, tc = config_pair("gated_recycled")
    acks, votes, holds = traffic(tc, 3)
    js, *_ = japi.run(jc, japi.create_state(jc), to_ref(acks),
                      to_ref(votes), to_ref(holds))
    st = convert.engine_state_from_numpy(tc, ref_tree(js), "cpu")
    assert_tree_equal(convert.engine_state_to_numpy(st, tc), ref_tree(js))
    jres = japi.committed_prefix(jc, host_copy(js))
    tres = tapi.committed_prefix(tc, st)
    assert np.array_equal(tres[0].numpy(), np.asarray(jres[0]))
    assert int(tres[2]) == int(jres[2]) > 0


# -- the mesh and its config --------------------------------------------------

def test_make_group_mesh_without_process_group():
    assert not dist.is_initialized()
    m = tmesh.make_group_mesh(6, n_devices=4)
    assert (m.size, m.rank, m.rows, m.pad, m.backend) == (1, 0, 6, 0, None)
    assert tmesh.group_padding(6, m) == 0
    x = torch.arange(6)
    assert tmesh.all_gather_rows(x, m) is x
    with pytest.raises(ValueError, match="n_groups >= 1"):
        tmesh.make_group_mesh(0)


@pytest.mark.parametrize("n_groups,size,pad", [(6, 4, 2), (4, 3, 2),
                                               (4, 4, 0), (3, 2, 1),
                                               (1, 1, 0)])
def test_group_padding(n_groups, size, pad):
    m = tmesh.GroupMesh(size=size, rank=0, rows=(n_groups + pad) // size,
                        pad=pad, backend=None, group=None)
    assert tmesh.group_padding(n_groups, m) == pad


def test_make_group_mesh_clamps_in_a_world_of_one(gloo_world1):
    for n_devices in (None, 1, 64):
        m = tmesh.make_group_mesh(4, n_devices=n_devices)
        assert (m.size, m.rank, m.rows, m.pad) == (1, 0, 4, 0)
        assert m.backend == "gloo"
    x = torch.arange(8).view(4, 2)
    assert torch.equal(tmesh.all_gather_rows(x, m), x)


def test_mesh_config_validation():
    kw = dict(groups=G, window=W, n_diss=D, n_seq=SQ, order_budget=4,
              merge_capacity=256)
    with pytest.raises(ValueError, match="n_devices must be >= 1"):
        tapi.EngineConfig(**kw, mesh=tapi.MeshConfig(n_devices=0))
    with pytest.raises(ValueError, match="must be a MeshConfig"):
        tapi.EngineConfig(**kw, mesh="group")
    # n_devices beyond the world clamps instead of failing
    cfg = tapi.EngineConfig(**kw, mesh=tapi.MeshConfig(n_devices=64))
    assert cfg.mesh == tapi.MeshConfig(64, "group")
    acks, votes, _ = traffic(cfg, 0)
    res = tapi.run(cfg, tapi.create_state(cfg, "cpu"), to_port(acks),
                   to_port(votes))[1:]
    base = meshed.unmeshed(cfg)
    want = tapi.run(base, tapi.create_state(base, "cpu"), to_port(acks),
                    to_port(votes))[1:]
    assert all(torch.equal(x, y) for x, y in zip(res, want))
    assert int(res[1]) > 0


def test_imports_create_no_process_group_and_touch_no_device():
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.engine.meshed, repro_torch.launch.mesh\n"
            "import repro_torch.pipeline.closed, repro_torch.convert\n"
            "assert not dist.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('inert')\n")
    src = str(Path(__file__).resolve().parent.parent / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "inert"


# -- world sizes 1–4, against the unmeshed port ------------------------------

@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    """Every world size at once (one gloo process per rank) and the
    unmeshed oracle; each process has a deadline."""
    d = tmp_path_factory.mktemp("mesh")
    jobs = {("unmeshed", 0): [str(d / "unmeshed.json"), "--unmeshed"]}
    for n in WORLDS:
        for r in range(n):
            jobs[(n, r)] = [str(d / f"w{n}r{r}.json"), str(r), str(n),
                            str(d / f"init{n}")]
    procs = {k: subprocess.Popen([sys.executable, str(CHILD)] + args,
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
             for k, args in jobs.items()}
    end = time.monotonic() + DEADLINE_S
    errors = {}
    try:
        for k, p in procs.items():
            try:
                _, err = p.communicate(
                    timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                errors[k] = "deadline"
                continue
            if p.returncode != 0:
                errors[k] = err[-3000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, errors
    return {k: json.loads(Path(args[0]).read_text())
            for k, args in jobs.items()}


SCENARIOS = ("plain", "gated", "recycled", "gated_recycled", "padded",
             "reconfig", "ticks", "adaptive", "adaptive_enqueue", "subtick",
             "pipeline", "pipeline_subtick", "convert")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_equals_unmeshed(world_runs, world):
    want = world_runs[("unmeshed", 0)]
    for r in range(world):
        got = world_runs[(world, r)]
        assert got["world"] == world
        for key in SCENARIOS:
            if world == 4 and r == 3 and key == "reconfig":
                # 3 groups clamp the mesh to ranks 0-2
                assert got[key] == "outside"
                continue
            assert got[key] == want[key], (world, r, key)


def test_scenarios_are_substantive(world_runs):
    """The equalities above would hold vacuously on empty logs: every
    scenario ordered and committed ids, the recycled runs retired
    (fresh ids were minted mid-run), the flips moved or sealed rows,
    the adaptive and subtick passes took more than one round."""
    r = world_runs[("unmeshed", 0)]
    for key in SCENARIOS[:-1]:
        assert r[key]["count"] > 0 and r[key]["committed"] > 0, key
    for key in ("recycled", "gated_recycled", "subtick"):
        assert sum(r[key]["retired"]) > 0, key
    assert r["reconfig"]["moved"] > 0
    assert max(r["adaptive"]["rounds"]) > 1
    assert max(r["adaptive_enqueue"]["rounds"]) > 1
    assert max(r["subtick"]["rounds"]) > 1
    for key in ("pipeline", "pipeline_subtick"):
        p = r[key]
        assert p["committed"] == p["admitted"] > 0 and p["bids_unique"]
        assert p["removed"] == [3] and p["moved"] == 0 and p["sealed"]
        assert p["dropped"] == 0
    assert r["convert"]["round_trip"] and r["convert"]["queue_round_trip"]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shape_and_logical_id_bases(world_runs, world):
    """Each rank's mesh (size clamped to the world and to G, pad rows)
    and its rows' fresh-id bases: logical ``g · stride`` on every rank,
    pad rows past the last group."""
    for groups in (3, 4, 6):
        size = min(world, groups)
        pad = (-groups) % size
        rows = (groups + pad) // size
        bases = []
        for r in range(world):
            m = world_runs[(world, r)][f"mesh/{groups}"]
            assert (m["size"], m["rows"], m["pad"], m["backend"]) == \
                (size, rows, pad, "gloo")
            assert m["rank"] == (r if r < size else -1)
            if r < size:
                bases += m["id_base"]
        assert bases == [g * STRIDE for g in range(groups + pad)]


@pytest.mark.parametrize("world", WORLDS)
def test_row_position_id_base_changes_merged_prefix(world_runs, world):
    """The recycled scenario catches the fault the logical base
    prevents: with row-position bases, rank r > 0 mints fresh ids from
    the wrong, colliding ranges, and the merged prefix differs (at one
    rank, row position and logical group coincide)."""
    right = world_runs[("unmeshed", 0)]["recycled"]
    for r in range(world):
        wrong = world_runs[(world, r)]["wrong_base"]
        assert wrong["count"] == right["count"]
        assert (wrong["merged"] == right["merged"]) == (world == 1)
