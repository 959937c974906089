"""One rank of a meshed-engine scenario run (``tests/test_torch_meshed.py``).

Run as a script, one process per rank:

    python tests/_torch_mesh_child.py OUT_JSON RANK WORLD INIT_FILE
    python tests/_torch_mesh_child.py OUT_JSON --unmeshed

Each rank joins a gloo process group (``file://INIT_FILE``, a 60 s
timeout), runs the scenario set on the CPU with ``MeshConfig()`` and
writes what it saw as JSON. ``--unmeshed`` runs the same scenarios
without a process group and without a mesh: the oracle. The scenarios
are the reference's cross-device set (``tests/test_multidevice.py``):
the four families with saturated recycled traffic that mints fresh ids
mid-run, 6 groups on 4 ranks, the (0, 1) → (0, 1, 2) epoch flip on 3
groups; and the port's own: adaptive passes over a skewed queue
(``queue_from_arrays`` and ``Engine.enqueue``), subtick passes across
a recycle, ``Engine.tick``/``recycle``, the closed pipeline with a
4 → 3 row flip in both modes, the state through ``convert``, and the
recycled run with a row-position id base (the fault the logical base
prevents). Imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import hashlib
import json
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.core import tilesim  # noqa: E402
from repro_torch.engine import adaptive as AD  # noqa: E402
from repro_torch.engine import api, meshed  # noqa: E402
from repro_torch.engine import epochs as EP  # noqa: E402
from repro_torch.engine.api import (Engine, EngineConfig,  # noqa: E402
                                    GatingConfig, MeshConfig,
                                    RecyclingConfig)
from repro_torch.pipeline import closed as PC  # noqa: E402

G, W, D, SQ, T = 4, 16, 5, 3, 10
STRIDE = 1 << 16
CPU = "cpu"
FAMS = {
    "plain": {},
    "gated": dict(gating=GatingConfig()),
    "recycled": dict(recycling=RecyclingConfig(watermark=8,
                                               id_stride=STRIDE)),
    "gated_recycled": dict(recycling=RecyclingConfig(watermark=8,
                                                     id_stride=STRIDE),
                           gating=GatingConfig()),
}


def words(n):
    return (n + 31) // 32


def tiles(seed, g, n, t=T, density=0.7):
    rng = np.random.default_rng(seed)
    return tilesim.pack_tile(torch.from_numpy(
        rng.random((t, g, W, n)) < density))


def saturated(g, n, t=T):
    return torch.full((t, g, W, words(n)), -1, dtype=torch.int32)


def digest_tree(tree) -> str:
    h = hashlib.sha256()

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}.{k}")
        elif x is None:
            h.update(f"{path}=None;".encode())
        else:
            h.update(f"{path}:{x.dtype}{x.shape};".encode())
            h.update(np.ascontiguousarray(x).tobytes())
    walk(tree, "")
    return h.hexdigest()


def state_digest(cfg, state) -> str:
    return digest_tree(convert.engine_state_to_numpy(state, cfg))


def prefix(merged, count) -> list:
    return merged[:int(count)].tolist()


def logical(cfg, state):
    return meshed.gather_state(cfg, state) if cfg.mesh is not None \
        else state


class Scenarios:
    def __init__(self, mesh: bool):
        self.mesh = MeshConfig() if mesh else None
        self.out = {}

    def cfg(self, **kw):
        base = dict(groups=G, window=W, n_diss=D, n_seq=SQ, order_budget=4,
                    merge_capacity=4096)
        base.update(kw)
        mesh = base.pop("mesh", self.mesh)
        return EngineConfig(**base, mesh=mesh)

    def families(self):
        for fam, kw in FAMS.items():
            cfg = self.cfg(**kw)
            if cfg.recycling is not None:
                acks, votes = saturated(G, D), saturated(G, SQ)
            else:
                seed = {"plain": 11, "gated": 13}[fam]
                acks = tiles(seed, G, D)
                votes = tiles(seed + 1, G, SQ, density=0.6)
            holds = saturated(G, cfg.gating.n_diss_partition) \
                if cfg.gating else None
            st, merged, cnt, com = api.run(cfg, api.create_state(cfg, CPU),
                                           acks, votes, holds)
            rec = {"merged": prefix(merged, cnt), "count": int(cnt),
                   "committed": int(com), "state": state_digest(cfg, st)}
            if cfg.recycling is not None:
                core = logical(cfg, st).core
                rs = core.rs if cfg.family == "gated_recycled" else core
                rec["retired"] = rs.retired.tolist()
            self.out[fam] = rec

    def padded(self):
        """6 groups on (at most) 4 ranks: 2 inert pad rows at 4."""
        cfg = self.cfg(groups=6, mesh=None if self.mesh is None
                       else MeshConfig(n_devices=4))
        st, merged, cnt, com = api.run(
            cfg, api.create_state(cfg, CPU), tiles(7, 6, D),
            tiles(8, 6, SQ, density=0.6))
        self.out["padded"] = {"merged": prefix(merged, cnt),
                              "count": int(cnt), "committed": int(com),
                              "state": state_digest(cfg, st)}

    def reconfig(self):
        """Epoch flip (0, 1) → (0, 1, 2) on 3 groups (on 4 ranks the
        mesh clamps to 3 and rank 3 sits out)."""
        table = EP.EpochTable(((0, 1), (0, 1, 2)), n_rows=3)
        cfg = self.cfg(groups=3, epochs=table,
                       recycling=RecyclingConfig(watermark=8,
                                                 id_stride=STRIDE))
        if cfg.mesh is not None and meshed.mesh_for(cfg).rank < 0:
            self.out["reconfig"] = "outside"
            return
        acks0 = torch.zeros((T, 3, W, words(D)), dtype=torch.int32)
        acks0[:, :2] = -1
        eng = Engine.create(cfg, device=CPU)
        eng.run(acks0, saturated(3, SQ))
        za = torch.zeros((3, W, words(D)), dtype=torch.int32)
        zv = torch.full((3, W, words(SQ)), -1, dtype=torch.int32)
        drain = 0
        while not EP.is_drained(logical(cfg, eng.state).core.q) \
                and drain < 32:
            eng.tick(za, zv)
            drain += 1
        report = eng.reconfigure(1)
        eng.run(saturated(3, D), saturated(3, SQ))
        merged, cnt, com = eng.committed()
        self.out["reconfig"] = {
            "merged": prefix(merged, cnt), "count": int(cnt),
            "committed": int(com), "moved": int(report["moved"]),
            "drain_ticks": drain, "state": state_digest(cfg, eng.state)}

    def wrong_base(self):
        """The recycled run with each rank minting fresh ids from its
        rows' positions (``arange(rows) · stride``), not their logical
        groups: the fault ``meshed.local_id_base`` prevents."""
        cfg = self.cfg(**FAMS["recycled"])
        good = meshed.local_id_base
        if cfg.mesh is not None:
            meshed.local_id_base = lambda c, device: torch.arange(
                meshed.mesh_for(c).rows, dtype=torch.int32,
                device=device) * c.recycling.id_stride
        try:
            _, merged, cnt, com = api.run(
                cfg, api.create_state(cfg, CPU), saturated(G, D),
                saturated(G, SQ))
        finally:
            meshed.local_id_base = good
        self.out["wrong_base"] = {"merged": prefix(merged, cnt),
                                  "count": int(cnt), "committed": int(com)}

    def ticks(self):
        """Engine.tick, then Engine.recycle and the commit gate."""
        cfg = self.cfg(**FAMS["gated_recycled"])
        eng = Engine.create(cfg, device=CPU)
        acks, votes = tiles(21, G, D), tiles(22, G, SQ, density=0.6)
        holds = tiles(23, G, cfg.gating.n_diss_partition, density=0.9)
        assigned = []
        for t in range(T):
            out = eng.tick(acks[t], votes[t], holds[t])
            assigned.append(out["assigned"].tolist())
            assert int(out["dropped"]) == 0
        n_ret = eng.recycle()
        merged, cnt, com = eng.committed()
        sids = logical(cfg, eng.state).core.rs.slot_ids
        self.out["ticks"] = {
            "assigned": assigned, "n_retired": n_ret.tolist(),
            "merged": prefix(merged, cnt), "count": int(cnt),
            "committed": int(com), "slot_ids": sids.tolist(),
            "state": state_digest(cfg, eng.state)}

    def adaptive(self):
        """Skewed queues: pre-loaded (recycled, backlog policy) and
        enqueued per tick with a mask (gated recycled, unstable)."""
        ad = AD.AdaptiveConfig(max_tiles_per_tick=3, policy="backlog")
        cfg = self.cfg(adaptive=ad, recycling=RecyclingConfig(
            watermark=4, id_stride=STRIDE))
        acks, votes = saturated(G, D, t=12), tiles(31, G, SQ, t=12,
                                                   density=0.6)
        st = api.create_state(cfg, CPU)
        q = AD.queue_from_arrays(cfg, acks, votes, lengths=[12, 2, 7, 1])
        rounds, consumed = [], []
        for _ in range(12):
            st, q, out = AD.adaptive_pass(cfg, st, q, inplace=True)
            rounds.append(int(out["rounds"]))
            consumed.append(out["consumed"].tolist())
            assert int(out["dropped"]) == 0
        merged, cnt, com = api.committed_prefix(cfg, st)
        self.out["adaptive"] = {
            "rounds": rounds, "consumed": consumed,
            "merged": prefix(merged, cnt), "count": int(cnt),
            "committed": int(com), "state": state_digest(cfg, st),
            "queue": digest_tree(convert.queue_to_numpy(q, cfg))}

        ad = AD.AdaptiveConfig(max_tiles_per_tick=4, policy="unstable")
        cfg = self.cfg(adaptive=ad, **FAMS["gated_recycled"])
        eng = Engine.create(cfg, device=CPU)
        acks, votes = tiles(41, G, D, t=8), tiles(42, G, SQ, t=8)
        holds = tiles(43, G, cfg.gating.n_diss_partition, t=8)
        for t in range(8):
            mask = None if t < 1 else torch.tensor(
                [True, t < 3, t % 2 == 0, False])
            eng.enqueue(acks[t], votes[t], holds[t], mask=mask)
        rounds = []
        while True:
            r = int(eng.adaptive_pass()["rounds"])
            rounds.append(r)
            if r == 0 or len(rounds) > 40:
                break
        merged, cnt, com = eng.committed()
        self.out["adaptive_enqueue"] = {
            "rounds": rounds, "merged": prefix(merged, cnt),
            "count": int(cnt), "committed": int(com),
            "state": state_digest(cfg, eng.state)}

    def subtick(self):
        """Subtick passes with skewed traffic (groups 2, 3 acked late)
        and a low watermark: rounds after a mid-pass recycle re-address
        the tiles."""
        ad = AD.AdaptiveConfig(max_tiles_per_tick=3, policy="undecided")
        cfg = self.cfg(adaptive=ad, recycling=RecyclingConfig(
            watermark=6, id_stride=STRIDE), gating=GatingConfig())
        part = cfg.gating.n_diss_partition
        st = api.create_state(cfg, CPU)
        rounds = []
        for t in range(12):
            a = saturated(G, D, t=1)[0]
            if t % 3:
                a[2:] = 0
            v = tiles(60 + t, G, SQ, t=1, density=0.8)[0]
            h = saturated(G, part, t=1)[0]
            st, out = AD.subtick_pass(cfg, st, a, v, h)
            rounds.append(int(out["rounds"]))
            assert int(out["dropped"]) == 0
        merged, cnt, com = api.committed_prefix(cfg, st)
        rs = logical(cfg, st).core.rs
        self.out["subtick"] = {
            "rounds": rounds, "merged": prefix(merged, cnt),
            "count": int(cnt), "committed": int(com),
            "retired": rs.retired.tolist(), "state": state_digest(cfg, st)}

    def pipeline(self, adaptive):
        """The closed pipeline, 16 ticks at epoch 0, a drain, the flip
        from rows (0, 1, 2, 3) to (0, 1, 2), 8 ticks, a drain."""
        table = EP.EpochTable(((0, 1, 2, 3), (0, 1, 2)), n_rows=4)
        ecfg = self.cfg(window=16, n_diss=8, n_seq=3, merge_capacity=2048,
                        recycling=RecyclingConfig(watermark=8,
                                                  id_stride=4096),
                        gating=GatingConfig(), epochs=table,
                        adaptive=None if not adaptive else
                        AD.AdaptiveConfig(3, policy="unstable"))
        pcfg = PC.PipelineConfig(
            engine=ecfg, n_clients=16, budget_bytes=2500, capacity=256,
            seq_capacity=64, ack_lag=(1, 2, 1, 3, 2, 1, 1, 2),
            hold_lag=(1, 1, 2, 1, 3, 1, 2, 1), vote_lag=(1, 2, 1))
        rng = np.random.default_rng(5)
        arrived = torch.from_numpy(rng.random((24, 16)) < 0.3)
        sizes = torch.where(arrived, torch.from_numpy(
            rng.integers(100, 900, (24, 16)).astype(np.int32)), 0)
        rts = [torch.from_numpy(PC.build_route_table(pcfg, epoch=e))
               for e in (0, 1)]
        quiet = torch.zeros((16,), dtype=torch.bool), \
            torch.zeros((16,), dtype=torch.int32)

        def drain(st, rt):
            for n in range(64):
                if int(PC.committed(pcfg, st)[2]) == \
                        int(st.admit_count.sum()):
                    return st, n
                st, _ = PC.pipeline_tick(pcfg, st, *quiet, rt)
            raise AssertionError("the pipeline did not drain")

        st, o1 = PC.run_pipeline(pcfg, PC.init_pipeline(pcfg, CPU),
                                 arrived[:16], sizes[:16], rts[0],
                                 inplace=True)
        st, d1 = drain(st, rts[0])
        st, report = PC.reconfigure_pipeline(pcfg, st, 0, 1)
        rs = logical(ecfg, st.engine).core.rs
        sealed = int(rs.retired[3]) == int(rs.q.next_instance[3])
        st, o2 = PC.run_pipeline(pcfg, st, arrived[16:], sizes[16:], rts[1])
        st, d2 = drain(st, rts[1])
        merged, cnt, com = PC.committed(pcfg, st)
        bids = PC.decode_merged(pcfg, st, merged, com)
        self.out["pipeline_subtick" if adaptive else "pipeline"] = {
            "merged": prefix(merged, cnt), "count": int(cnt),
            "committed": int(com), "admitted": int(st.admit_count.sum()),
            "bids_unique": len(set(bids)) == len(bids),
            "removed": list(report["removed"]), "moved": report["moved"],
            "sealed": sealed, "drain": [d1, d2],
            "rounds": o1["rounds"].tolist() + o2["rounds"].tolist()
            if adaptive else None,
            "dropped": int(o1["dropped"].sum() + o2["dropped"].sum()),
            "state": state_digest(ecfg, st.engine)}

    def convert(self):
        """A logical state and queue cross in and out of a meshed
        engine."""
        ad = AD.AdaptiveConfig(max_tiles_per_tick=2, queue_capacity=4)
        cfg = self.cfg(adaptive=ad, **FAMS["gated_recycled"])
        plain = meshed.unmeshed(cfg)
        st = api.create_state(plain, CPU)
        acks, votes = saturated(G, D), tiles(51, G, SQ, density=0.5)
        holds = saturated(G, cfg.gating.n_diss_partition)
        st, *_ = api.run(plain, st, acks, votes, holds)
        tree = convert.engine_state_to_numpy(st)
        mst = convert.engine_state_from_numpy(cfg, tree, CPU)
        back = convert.engine_state_to_numpy(mst, cfg)
        q = AD.queue_from_arrays(plain, acks[:4], votes[:4], holds[:4],
                                 lengths=[4, 1, 3, 0])
        qtree = convert.queue_to_numpy(q)
        mq = convert.queue_from_numpy(cfg, qtree, CPU)
        qback = convert.queue_to_numpy(mq, cfg)
        self.out["convert"] = {
            "round_trip": digest_tree(back) == digest_tree(tree),
            "queue_round_trip": digest_tree(qback) == digest_tree(qtree)}

    def mesh_shape(self):
        if self.mesh is None:
            return
        for groups in (3, 4, 6):
            cfg = self.cfg(groups=groups, **FAMS["recycled"])
            m = meshed.mesh_for(cfg)
            self.out[f"mesh/{groups}"] = {
                "size": m.size, "rank": m.rank, "rows": m.rows,
                "pad": m.pad, "backend": m.backend,
                "id_base": None if m.rank < 0 else
                meshed.local_id_base(cfg, CPU).tolist()}

    def all(self):
        self.mesh_shape()
        self.families()
        self.padded()
        self.reconfig()
        self.wrong_base()
        self.ticks()
        self.adaptive()
        self.subtick()
        self.pipeline(adaptive=False)
        self.pipeline(adaptive=True)
        self.convert()
        return self.out


def main(argv) -> int:
    torch.set_num_threads(1)
    out_path = argv[1]
    if argv[2] == "--unmeshed":
        out = Scenarios(mesh=False).all()
    else:
        import torch.distributed as dist
        rank, world, init = int(argv[2]), int(argv[3]), argv[4]
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        out = Scenarios(mesh=True).all()
        out["world"] = dist.get_world_size()
        dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
