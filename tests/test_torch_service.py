"""The port's training service (``repro_torch.runtime.coordinator``)
against the reference's (``repro.runtime.coordinator``), on the CPU.

Both services train ``qwen3-smoke`` in f32 with AdamW from the same state
(the reference's ``make_state`` tree, carried to the port through
``convert.train_state_from_jax``) on the same numpy-made batches, and run
the same schedules: the four service tests of tests/test_runtime.py
(bitwise consistency, crash and restart from the committed checkpoint,
leader failover, the ordered ``SCALE`` command) and the end-to-end test of
tests/test_system.py. The ordering is the same discrete-event run in both,
so each pod's applied log and step must be equal, and the ordering
leader's LAN-1 bytes 0. Losses are held at ``LOSS_TOL`` = 2e-5 relative
and parameters at ``PARAM_TOL`` = 1e-4 an element per step applied and
``PARAM_REL_TOL`` = 1e-3 of the reference's change in the L2 norm (see
``PARAM_TOL``). The port's pods must end bitwise equal to each other.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.runtime import coordinator as jcoord  # noqa: E402
from repro.runtime.statemachine import Command as JCommand  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.runtime import coordinator  # noqa: E402
from repro_torch.runtime.checkpoint import latest_committed_step  # noqa: E402
from repro_torch.runtime.statemachine import Command  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

LR = 1e-3
LOSS_TOL = 2e-5
# tests/test_torch_train.py's OPT_TOL is 2e-6 on the optimizer alone, on
# identical gradients; end to end the gradients' f32 rounding passes
# through AdamW's normalised update, and these schedules differ from the
# reference by 4.5e-6 to 2.2e-5 an element a step applied. PARAM_TOL is
# 1e-4 an element a step applied: under a tenth of an update (lr = 1e-3
# an element a step), so a port that skips or botches an update fails.
# The whole tree's difference is held, in the L2 norm, at PARAM_REL_TOL of
# the reference's change from the start (measured 2.5e-5 to 7.8e-5; a
# port that never updated would read 1).
PARAM_TOL = 1e-4
PARAM_REL_TOL = 1e-3
B, S = 4, 32


@pytest.fixture(scope="module")
def setup():
    jcfg = jregistry.get_smoke("qwen3-14b").replace(dtype=jnp.float32)
    cfg = registry.get_smoke("qwen3-14b").replace(dtype=torch.float32)
    jopt, opt = JO.OptConfig(kind="adamw", lr=LR), O.OptConfig(kind="adamw",
                                                               lr=LR)
    jstep = jax.jit(JTR.make_train_step(jcfg, jopt, microbatches=1,
                                        global_batch=B))
    step = TR.make_train_step(cfg, opt, microbatches=1, global_batch=B)
    tree = jax.tree.map(
        np.asarray, JTR.make_state(jcfg, jopt, key=jax.random.PRNGKey(7))[0])

    def jinit():
        return jax.tree.map(jnp.asarray, tree)

    def init():
        return convert.train_state_from_jax(tree, cfg, "cpu")

    return cfg, (jstep, jinit), (step, init)


def _batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (B, S)) for _ in range(n)]


class Side:
    """One package's service and the calls a schedule makes on it."""

    def __init__(self, coord, command, step, init, ckpt_dir, jax_side):
        self.command, self.jax_side = command, jax_side
        self.init = init
        self.svc = coord.TrainingService(
            coord.ServiceConfig(n_pods=2, ckpt_dir=str(ckpt_dir)), step, init)

    def submit(self, tokens) -> None:
        t = jnp.asarray(tokens) if self.jax_side else torch.from_numpy(tokens)
        self.svc.submit_command(self.svc.submit_batch({"tokens": t}))

    def cmd(self, kind, arg) -> None:
        self.svc.submit_command(self.command(kind, arg))


def sched_consistency(side, cfg):
    """test_runtime.py:106: five steps, every pod at step 5."""
    for b in _batches(cfg, 5, 0):
        side.submit(b)
    side.svc.run(until=400)
    return 5


def sched_crash_restart(side, cfg):
    """test_runtime.py:118: CKPT(3), pod1 crashes, three more steps,
    pod1 restarts from the committed checkpoint and catches up."""
    for b in _batches(cfg, 3, 1):
        side.submit(b)
    side.cmd("CKPT", 3)
    side.svc.run(until=400)
    side.svc.crash_pod("pod1")
    for b in _batches(cfg, 3, 9):
        side.submit(b)
    side.svc.run(until=900)
    side.svc.restart_pod("pod1", template_state=side.init())
    assert side.svc.pods["pod1"].step == 3
    side.svc.run(until=2000)
    return 6


def sched_failover(side, cfg):
    """test_runtime.py:135: the ordering leader crashes after two steps;
    a new leader orders two more."""
    for b in _batches(cfg, 2, 2):
        side.submit(b)
    side.svc.run(until=300)
    side.old_leader = side.svc.leader_id()
    side.svc.crash_leader()
    for b in _batches(cfg, 2, 5):
        side.submit(b)
    side.svc.run(until=2500)
    assert side.svc.leader_id() not in (None, side.old_leader)
    return 4


def sched_scale(side, cfg):
    """test_runtime.py:150: SCALE(4) between two pairs of steps."""
    for b in _batches(cfg, 2, 3):
        side.submit(b)
    side.cmd("SCALE", 4)
    for b in _batches(cfg, 2, 7):
        side.submit(b)
    side.svc.run(until=600)
    assert all(sm.n_pods == 4 for sm in side.svc.pods.values())
    return 4


def sched_system(side, cfg):
    """test_system.py:16: one fixed batch submitted as four STEP
    commands; the loss falls."""
    tokens = _batches(cfg, 1, 11)[0]
    for _ in range(4):
        side.submit(tokens)
    side.svc.run(until=500)
    ml = side.svc.pods["pod0"].metrics_log
    assert ml[-1]["loss"] < ml[0]["loss"]
    return 4


SCHEDULES = {"consistency": sched_consistency,
             "crash-restart": sched_crash_restart,
             "failover": sched_failover, "scale": sched_scale,
             "system": sched_system}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_service_equals_reference(setup, name, tmp_path):
    cfg, (jstep, jinit), (step, init) = setup
    ref = Side(jcoord, JCommand, jstep, jinit, tmp_path / "ref", True)
    port = Side(coordinator, Command, step, init, tmp_path / "port", False)
    n_steps = SCHEDULES[name](ref, cfg)
    assert SCHEDULES[name](port, cfg) == n_steps

    # the same ordered log applied at every pod, in both packages
    for p in ref.svc.pods:
        rsm, psm = ref.svc.pods[p], port.svc.pods[p]
        assert psm.applied == rsm.applied, p
        assert psm.step == rsm.step == n_steps, p
        assert len(psm.metrics_log) == len(rsm.metrics_log)
        for m, jm in zip(psm.metrics_log, rsm.metrics_log):
            assert abs(m["loss"] - jm["loss"]) <= LOSS_TOL * abs(jm["loss"])
    assert port.svc.leader_id() == ref.svc.leader_id()

    # the leader carries no payload; every disseminator does
    for side in (ref, port):
        sim = side.svc.sim
        assert sim.lan1._stats(side.svc.leader_id()).total_bytes() == 0
        assert min(sim.lan1._stats(d).total_bytes()
                   for d in sim.diss_ids) > 0
    assert port.svc.sim.sched.now == ref.svc.sim.sched.now

    # the port's pods are bitwise equal, and near the reference's
    assert port.svc.consistent()
    assert len(set(port.svc.digests().values())) == 1
    assert ref.svc.consistent()
    got = convert.train_state_to_numpy(port.svc.pods["pod0"].state)["params"]
    want = ref.svc.pods["pod0"].state["params"]
    start = convert.train_state_to_numpy(init())["params"]
    diff_sq = change_sq = 0.0
    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(start)):
        b = np.asarray(b, dtype=np.float64)
        assert float(np.abs(a - b).max()) <= n_steps * PARAM_TOL
        diff_sq += float(((a - b) ** 2).sum())
        change_sq += float(((b - c) ** 2).sum())
    assert change_sq > 0.0
    assert np.sqrt(diff_sq / change_sq) <= PARAM_REL_TOL


def test_restart_reads_committed_manifest(setup, tmp_path):
    """The restarted pod's state comes from the step-3 checkpoint (its
    digest is pod0's at step 3) before it replays the decided suffix."""
    cfg, _, (step, init) = setup
    side = Side(coordinator, Command, step, init, tmp_path, False)
    for b in _batches(cfg, 3, 1):
        side.submit(b)
    side.cmd("CKPT", 3)
    side.svc.run(until=400)
    at3 = side.svc.pods["pod0"].digest()
    side.svc.crash_pod("pod1")
    for b in _batches(cfg, 3, 9):
        side.submit(b)
    side.svc.run(until=900)
    assert latest_committed_step(str(tmp_path)) == 3
    side.svc.restart_pod("pod1", template_state=init())
    assert side.svc.pods["pod1"].digest() == at3
    side.svc.run(until=2000)
    assert side.svc.pods["pod1"].digest() == side.svc.pods["pod0"].digest()


def test_batches_live_on_the_pods_device(setup, tmp_path):
    """``submit_batch`` stores a batch where the pods' state is."""
    cfg, _, (step, init) = setup
    side = Side(coordinator, Command, step, init, tmp_path, False)
    assert side.svc.device == torch.device("cpu")
    cmd = side.svc.submit_batch({"tokens": torch.zeros(B, S,
                                                       dtype=torch.int64)})
    assert cmd == Command("STEP", "batch0")
    assert side.svc.batch_store["batch0"]["tokens"].device == side.svc.device


def test_example_twin_runs_on_cpu(tmp_path, capsys):
    """examples/torch_train_smr_service.py at smoke size: six steps, pod1
    crashed and restarted, the leader failed over."""
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "examples"
            / "torch_train_smr_service.py")
    spec = importlib.util.spec_from_file_location("torch_smr_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    svc = mod.main(["--steps", "6", "--device", "cpu",
                    "--ckpt", str(tmp_path / "ckpt")])
    assert {sm.step for sm in svc.pods.values()} == {6}
    assert svc.consistent() and len(set(svc.digests().values())) == 1
    assert svc.leader_id() not in (None, "s0")
    out = capsys.readouterr().out
    assert "pods bitwise consistent: True" in out
    assert "!! crashing ordering leader s0" in out
