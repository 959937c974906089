"""The closed pipeline: workload → batcher → stability → ordering.

One :func:`pipeline_tick` spans the four decoupled HT-Paxos stages
(§4.1), all on the state's device:

1. **workload** — the tick's client arrivals (one row of a
   :class:`~repro_torch.pipeline.workload.Workload`) are gathered to
   their statically assigned disseminator lanes (client ``c`` → lane
   ``c mod n_diss``);
2. **batcher** — each lane runs the byte-budget accumulator
   (:mod:`repro_torch.pipeline.vbatch`, §4.1 step 13) and flushes
   batches, each stamped ``(lane d, seq)``, the simulator's
   ``(node_id, next_batch)`` identity;
3. **delivery / stability** — flushed batches are admitted to their
   owner ordering group (an epoch-aware route table, crc32 of the bid:
   the hash the simulator routes with), and a per-node lag schedule
   models replication: a batch admitted at tick ``t`` is held, acked
   and vote-acknowledged by node ``j`` once its age reaches
   ``hold_lag[j]`` / ``ack_lag[j]`` / ``vote_lag[j]``. The tiles are
   recomputed from the ages every tick against the engine's live
   slot→id map, so the model stays exact across window recycling
   (absorption is an idempotent OR);
4. **ordering** — one ``engine.api.tick`` of the gated, epoch-aware
   engine absorbs the tiles and appends to the merged log (with
   ``EngineConfig.adaptive``, one ``engine.adaptive.subtick_pass``).
   With ``EngineConfig.mesh``, stages 1–3a run replicated on every rank
   (the same inputs give the same tables), stage 3b builds the tiles of
   the rank's group rows only, and the meshed tick or subtick pass
   orders them (``engine.meshed``).

Engine slots are addressed by **global rank**: group ``g``'s ``k``-th
admitted batch is engine id ``g·stride + k`` (``stride`` = ``id_stride``
for recycled families, ``window`` otherwise), the id sequence the engine
assigns in admission order. ``admit_tick[g, k]`` / ``bid_code[g, k]``
record each rank's admission tick and batch identity;
:func:`decode_merged` maps the merged log back to ``(lane, seq)`` bids.

A lock-step tick does no host sync (the adaptive subtick mode reads its
round count once per tick): ``overflowed`` and ``dropped`` stay device
tensors for the caller to check once at the end of a run. The per-config
constants a tick needs on the device (lane gather, lag masks) are built
once per (config, device), by the capture's warm-up when the tick is
captured: :func:`run_pipeline` steps one loop of the lock-step tick
(``engine.graphs``), on a CUDA device one captured CUDA graph, replayed.
A functional call modifies no input unless it is given ``inplace=True``,
which lets the engine's kernels write into the state's buffers (the
counterpart of the reference's donation).

Reconfiguration is drain-then-switch at quiescent boundaries:
:func:`reconfigure_pipeline` refuses to re-home in-flight ids (rank
addressing is per row; a moved id would be unreachable by the delivery
model).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..dissem.batcher import BatchAccumulator, EMPTY_BATCH_BYTES
from ..engine import adaptive as adaptive_mod
from ..engine import api
from ..engine import graphs
from ..engine import meshed
from ..engine.api import EngineConfig, EngineState
from ..engine.epochs import EpochTable, route_id_epoch
from .vbatch import BatchState, init_batch_state, tick_flushes
from .workload import Workload

_I32 = torch.int32


def lane_bid(lane: int, seq: int) -> tuple[str, int]:
    """The simulator's batch id of lane ``lane``'s ``seq``-th batch:
    ``("d<lane>", seq)`` — same tuple, same repr, same crc32 route."""
    return (f"d{lane}", seq)


@dataclass(frozen=True)
class PipelineConfig:
    """Static shape and delivery model of one closed pipeline (hashable).

    ``engine`` must be a gated family. ``ack_lag`` / ``hold_lag`` /
    ``vote_lag`` are the per-node delivery lags in ticks (lengths
    ``n_diss`` / ``gating.n_diss_partition`` / ``n_seq``; empty → all
    0). ``capacity`` bounds the per-group admission record;
    ``seq_capacity`` bounds per-lane batch sequence numbers (the route
    table's width)."""
    engine: EngineConfig
    n_clients: int
    budget_bytes: int
    max_requests: int | None = None
    ack_lag: tuple[int, ...] = ()
    hold_lag: tuple[int, ...] = ()
    vote_lag: tuple[int, ...] = ()
    capacity: int = 1024
    seq_capacity: int = 1024

    def __post_init__(self):
        e = self.engine
        if e.gating is None:
            raise ValueError(
                "PipelineConfig.engine must be a gated family (gating="
                "GatingConfig(...)): the closed pipeline's delivery model "
                "drives the dissemination-stability gate")
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        if self.budget_bytes <= EMPTY_BATCH_BYTES:
            raise ValueError(
                f"budget_bytes={self.budget_bytes} cannot fit the batch "
                f"header ({EMPTY_BATCH_BYTES} B) plus any request")
        if self.max_requests is not None and self.max_requests < 1:
            raise ValueError(
                f"max_requests must be >= 1 or None, got {self.max_requests}")

        def norm_lags(name, lags, n, role):
            lags = tuple(int(x) for x in lags) if lags else (0,) * n
            if len(lags) != n:
                raise ValueError(
                    f"PipelineConfig.{name} has {len(lags)} entries, needs "
                    f"one per {role} ({n})")
            if any(x < 0 for x in lags):
                raise ValueError(f"PipelineConfig.{name} has negative lags: "
                                 f"{lags}")
            object.__setattr__(self, name, lags)
        norm_lags("ack_lag", self.ack_lag, e.n_diss, "disseminator")
        norm_lags("hold_lag", self.hold_lag, e.gating.n_diss_partition,
                  "gating-partition node")
        norm_lags("vote_lag", self.vote_lag, e.n_seq, "sequencer")
        if self.capacity < e.window:
            raise ValueError(
                f"capacity={self.capacity} < window={e.window}: the engine "
                "can hold more live ranks than the admission record")
        if self.capacity > self.id_stride:
            raise ValueError(
                f"capacity={self.capacity} > id stride={self.id_stride}: "
                "rank g*stride+k would alias into the next group's id range "
                "before the admission record fills")
        if self.seq_capacity < 1:
            raise ValueError(
                f"seq_capacity must be >= 1, got {self.seq_capacity}")

    @property
    def id_stride(self) -> int:
        """Engine-id stride between group rows (rank k ↔ id g·stride+k)."""
        e = self.engine
        return e.recycling.id_stride if e.recycling is not None else e.window

    @property
    def n_lanes(self) -> int:
        return self.engine.n_diss

    @property
    def lane_slots(self) -> int:
        """Request slots per lane per tick (clients are dealt round-robin
        over lanes)."""
        return -(-self.n_clients // self.n_lanes)

    def lane_clients(self) -> tuple[np.ndarray, np.ndarray]:
        """Static client index/mask per lane: int[D, K], bool[D, K] —
        lane d serves clients d, d+D, d+2D, ..."""
        D, K = self.n_lanes, self.lane_slots
        idx = np.zeros((D, K), np.int32)
        mask = np.zeros((D, K), bool)
        for d in range(D):
            cs = np.arange(d, self.n_clients, D)
            idx[d, :len(cs)] = cs
            mask[d, :len(cs)] = True
        return idx, mask


class PipelineState(NamedTuple):
    """The closed pipeline's carried state."""
    engine: EngineState
    batch: BatchState
    admit_count: torch.Tensor    # int32[G] ranks admitted per group
    admit_tick: torch.Tensor     # int32[G, R] admission tick per rank
    bid_code: torch.Tensor       # int32[G, R] lane*seq_capacity+seq, -1 empty
    flushed_bytes: torch.Tensor  # int32[D] cumulative wire bytes per lane
    n_flushed: torch.Tensor      # int32[D] cumulative batches per lane
    tick: torch.Tensor           # int32 scalar
    overflowed: torch.Tensor     # bool scalar: capacity/seq_capacity blown


def init_pipeline(cfg: PipelineConfig, device=None) -> PipelineState:
    """Fresh pipeline state on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    G, R, D = cfg.engine.groups, cfg.capacity, cfg.n_lanes
    return PipelineState(
        engine=api.create_state(cfg.engine, dev),
        batch=init_batch_state(D, dev),
        admit_count=torch.zeros((G,), dtype=_I32, device=dev),
        admit_tick=torch.zeros((G, R), dtype=_I32, device=dev),
        bid_code=torch.full((G, R), -1, dtype=_I32, device=dev),
        flushed_bytes=torch.zeros((D,), dtype=_I32, device=dev),
        n_flushed=torch.zeros((D,), dtype=_I32, device=dev),
        tick=torch.zeros((), dtype=_I32, device=dev),
        overflowed=torch.zeros((), dtype=torch.bool, device=dev))


def build_route_table(cfg: PipelineConfig, epoch: int = 0,
                      table: EpochTable | None = None) -> np.ndarray:
    """Owner group of every possible bid ``(lane, seq)`` at ``epoch``:
    int32[D, seq_capacity], with the simulator's own hash
    (``route_id_epoch``: crc32 of the bid tuple's repr). ``table``
    defaults to ``engine.epochs`` or, absent that, the static all-rows
    table. Pass it to :func:`pipeline_tick` as a tensor on the state's
    device."""
    if table is None:
        table = cfg.engine.epochs
    if table is None:
        table = EpochTable((tuple(range(cfg.engine.groups)),),
                           n_rows=cfg.engine.groups)
    out = np.empty((cfg.n_lanes, cfg.seq_capacity), np.int32)
    for d in range(cfg.n_lanes):
        for s in range(cfg.seq_capacity):
            out[d, s] = route_id_epoch(lane_bid(d, s), table, epoch)
    return out


def _lag_masks(lags: tuple[int, ...]) -> list[tuple[int, np.ndarray]]:
    """Static pack of a lag schedule: ``[(lag, node_mask), ...]`` with one
    packed uint32[words] mask per distinct lag value (low bit = node 0),
    so the tile build costs one compare and select per distinct lag."""
    words = (len(lags) + 31) // 32
    out = []
    for lag in sorted(set(lags)):
        mask = np.zeros((words,), np.uint32)
        for j, x in enumerate(lags):
            if x == lag:
                mask[j // 32] |= np.uint32(1 << (j % 32))
        out.append((lag, mask))
    return out


class _Consts(NamedTuple):
    """A config's per-tick constants on one device."""
    lane_idx: torch.Tensor    # int64[D, K] client of each lane slot
    lane_mask: torch.Tensor   # bool[D, K]
    flush_lane: torch.Tensor  # int64[D*(K+1)] lane of each flush position
    groups: torch.Tensor      # int32[G] 0..G-1
    id_base: torch.Tensor     # int32[G] g*stride
    lags: tuple               # ack, vote, hold: ((lag, int32[words]), ...)


@functools.lru_cache(maxsize=8)
def _consts(cfg: PipelineConfig, device: torch.device) -> _Consts:
    idx, mask = cfg.lane_clients()
    D, K, G = cfg.n_lanes, cfg.lane_slots, cfg.engine.groups

    def packed(lags):
        return tuple((lag, torch.from_numpy(m.view(np.int32)).to(device))
                     for lag, m in _lag_masks(lags))
    groups = torch.arange(G, dtype=_I32, device=device)
    return _Consts(
        lane_idx=torch.from_numpy(idx).long().to(device),
        lane_mask=torch.from_numpy(mask).to(device),
        flush_lane=torch.arange(D, device=device).repeat_interleave(
            K + 1, output_size=D * (K + 1)),
        groups=groups, id_base=groups * cfg.id_stride,
        lags=tuple(packed(x) for x in (cfg.ack_lag, cfg.vote_lag,
                                       cfg.hold_lag)))


def _lag_tiles(cfg: PipelineConfig, state: PipelineState, c: _Consts)\
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recompute (acks, votes, holds) packed tiles from admission ages
    against the engine's live slot→id map. Under a mesh, the tiles of
    the rank's rows only: the admission record (replicated on every
    rank) is sliced to them, and pad rows, with nothing admitted, get
    zero tiles."""
    sids = api.slot_ids(state.engine)                       # int32[G, W]
    admit_count, admit_tick, id_base = (state.admit_count,
                                        state.admit_tick, c.id_base)
    if cfg.engine.mesh is not None:
        admit_count, admit_tick, id_base = (
            meshed.local_rows(cfg.engine, x)
            for x in (admit_count, admit_tick, id_base))
    rank = sids - id_base[:, None]
    admitted = rank < admit_count[:, None]
    at = torch.gather(admit_tick, 1, rank.clamp(0, cfg.capacity - 1).long())
    age = state.tick - at                                   # int32[G, W]

    def tiles(lags):
        out = torch.zeros(sids.shape + lags[0][1].shape, dtype=_I32,
                          device=sids.device)
        for lag, mask in lags:
            cond = admitted & (age >= lag)
            out = out | torch.where(cond[..., None], mask, 0)
        return out
    return tuple(tiles(lags) for lags in c.lags)


def _set_dropping(table: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, values) -> torch.Tensor:
    """``table`` with ``table[rows, cols] = values``; row index G (one
    past the end) is dropped: it lands on a sink row that is sliced
    off, so duplicate indices only ever meet there."""
    out = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    out[rows, cols] = values
    return out[:-1]


def pipeline_tick(cfg: PipelineConfig, state: PipelineState,
                  arrived: torch.Tensor, sizes: torch.Tensor,
                  route_table: torch.Tensor, *, inplace: bool = False)\
        -> tuple[PipelineState, dict]:
    """One tick through all four stages. ``arrived``/``sizes`` are one
    row of the workload (bool[C] / int32[C]); ``route_table`` is
    :func:`build_route_table` for the current epoch, as an int32 tensor
    on the state's device. Returns ``(state, out)``; ``out`` holds
    device scalars ``flushed``, ``admitted``, ``dropped`` and
    ``overflowed``, and ``rounds`` (the subtick pass's R) when
    ``cfg.engine.adaptive`` is set. Only the adaptive subtick mode reads
    a value back to the host (its R)."""
    G, R = cfg.engine.groups, cfg.capacity
    c = _consts(cfg, arrived.device)
    lane_sizes = sizes[c.lane_idx].to(_I32)                 # [D, K]
    lane_valid = arrived[c.lane_idx] & c.lane_mask

    # stage 2: byte-budget batching, linger-0 tail flush
    bstate, fl = tick_flushes(
        state.batch, lane_sizes, lane_valid,
        budget_bytes=cfg.budget_bytes, max_requests=cfg.max_requests)

    # stage 3a: admission — flushes lane-major (lane order, then stream
    # position: the order a simulator tick multicasts them), each bid
    # routed and recorded at its group's next dense rank
    fvalid = fl.valid.reshape(-1)                           # [D*(K+1)]
    fseq = fl.seq.reshape(-1)
    seq_over = fvalid & (fseq >= cfg.seq_capacity)
    fseq_safe = fseq.clamp(0, cfg.seq_capacity - 1)
    fgroup = route_table[c.flush_lane, fseq_safe.long()]    # int32
    # group-major [G, N], so the scan runs along the contiguous dim
    onehot = ((c.groups[:, None] == fgroup) & fvalid).to(_I32)
    prior = torch.cumsum(onehot, dim=1, dtype=_I32) - onehot
    g_long = fgroup.long()
    rank = state.admit_count[g_long] \
        + torch.gather(prior, 0, g_long[None, :])[0]
    cap_over = fvalid & (rank >= R)
    ok = fvalid & ~cap_over & ~seq_over
    g_idx = torch.where(ok, g_long, G)                      # G → dropped
    r_idx = rank.clamp(0, R - 1).long()
    admit_tick = _set_dropping(state.admit_tick, g_idx, r_idx, state.tick)
    bid_code = _set_dropping(
        state.bid_code, g_idx, r_idx,
        c.flush_lane.to(_I32) * cfg.seq_capacity + fseq)
    admitted = onehot.sum(dim=1, dtype=_I32)
    overflowed = state.overflowed | cap_over.any() | seq_over.any()

    state = state._replace(
        batch=bstate, admit_count=state.admit_count + admitted,
        admit_tick=admit_tick, bid_code=bid_code,
        flushed_bytes=state.flushed_bytes
        + torch.where(fl.valid, fl.bytes, 0).sum(dim=1, dtype=_I32),
        n_flushed=state.n_flushed + fl.valid.sum(dim=1, dtype=_I32),
        overflowed=overflowed)

    # stage 3b: delivery tiles from admission ages (live slot→id map)
    acks, votes, holds = _lag_tiles(cfg, state, c)

    # stage 4: gated ordering + merge, through the facade. With
    # EngineConfig.adaptive set, the subtick variant re-absorbs the tick's
    # tiles (idempotent OR, re-addressed after a recycle) for up to K-1
    # extra masked assignment rounds, so a group whose lag has spread
    # ahead of the others drains at R x order_budget ids per tick: size
    # merge_capacity for up to K x max_entries appended entries per tick.
    # Under a mesh the tiles are the rank's rows, which the ``*_rows``
    # verbs take (the batcher and admission run replicated).
    if cfg.engine.adaptive is not None:
        estate, eout = adaptive_mod.subtick_rows(
            cfg.engine, state.engine, acks, votes, holds, inplace=inplace)
    elif cfg.engine.mesh is not None:
        estate, eout = meshed.tick_rows(cfg.engine, state.engine, acks,
                                        votes, holds, inplace=inplace)
    else:
        estate, eout = api.tick(cfg.engine, state.engine, acks, votes,
                                holds, inplace=inplace)
    state = state._replace(engine=estate, tick=state.tick + 1)
    out = {"flushed": fvalid.sum(dtype=_I32),
           "admitted": admitted.sum(dtype=_I32),
           "dropped": eout["dropped"],
           "overflowed": overflowed}
    if "rounds" in eout:
        out["rounds"] = eout["rounds"]
    return state, out


_SUMMARIES = ("flushed", "admitted", "dropped")


def run_pipeline(cfg: PipelineConfig, state: PipelineState,
                 arrived: torch.Tensor, sizes: torch.Tensor,
                 route_table: torch.Tensor, *, inplace: bool = False,
                 capture: bool | None = None, loops: dict | None = None)\
        -> tuple[PipelineState, dict]:
    """:func:`pipeline_tick` over whole workload arrays (bool[T, C] /
    int32[T, C]). Per-tick summaries come back on the device (int32[T]
    each): ``flushed``, ``admitted``, ``dropped``, and ``rounds`` in the
    adaptive subtick mode.

    In lock-step and unmeshed the T ticks step one loop of the tick
    (``engine.graphs``): the route table is an input of the run, copied
    into the loop's buffer (an epoch flip does not rebuild the loop), and
    the summaries are written into int32 buffers at the tick's index.
    ``capture`` (``None``: on a CUDA device) makes the loop one captured
    CUDA graph, replayed; without it the loop runs the tick eagerly.
    ``loops``: a dict the caller keeps, in which the loop stays for later
    runs of the same shapes and no more ticks (``None``: a loop for this
    call alone). The subtick mode and the meshed pipeline tick from a
    Python loop, eagerly; ``capture=True`` raises there."""
    eager_only = ("in the adaptive subtick mode"
                  if cfg.engine.adaptive is not None else
                  "under a mesh (the captured meshed tick is not ported)"
                  if cfg.engine.mesh is not None else None)
    graph = graphs.resolve_capture(capture, arrived.device, "run_pipeline",
                                   eager_only)
    if eager_only is None:
        def body(st, tiles, consts):
            return pipeline_tick(cfg, st, *tiles, *consts, inplace=True)
        state, loop = graphs.run_functional(
            loops, ("pipeline", cfg), body, state, (arrived, sizes),
            (route_table,), inplace=inplace, graph=graph,
            series=_SUMMARIES)
        T = arrived.shape[0]
        return state, {k: loop.series[k][:T].clone() for k in _SUMMARIES}
    outs = []
    for a, s in zip(arrived, sizes):
        state, out = pipeline_tick(cfg, state, a, s, route_table,
                                   inplace=inplace)
        outs.append(out)
    keys = ("flushed", "admitted", "dropped") + \
        (("rounds",) if cfg.engine.adaptive is not None else ())
    return state, {k: torch.stack([o[k] for o in outs]) for k in keys}


def committed(cfg: PipelineConfig, state: PipelineState)\
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(merged, merged_count, committed_count) of the pipeline's engine."""
    return api.committed_prefix(cfg.engine, state.engine)


def decode_merged(cfg: PipelineConfig, state: PipelineState,
                  merged, count) -> list[tuple[str, int]]:
    """Map the engine's merged prefix back to batch bids.

    Control entries (SKIP/PAD/RECONFIG, all negative) are dropped, as
    learners never execute the simulator's control bids. Returns
    ``[("d<lane>", seq), ...]`` in merged order."""
    codes = state.bid_code.cpu().numpy()
    stride = cfg.id_stride
    out = []
    for e in merged[:int(count)].tolist():
        if e < 0:
            continue
        g, k = divmod(e, stride)
        if not (0 <= g < codes.shape[0] and k < codes.shape[1]):
            raise ValueError(f"merged id {e} outside the admission record "
                             f"(rank {k} ≥ capacity {codes.shape[1]})")
        code = int(codes[g, k])
        if code < 0:
            raise ValueError(f"merged id {e} (group {g} rank {k}) was "
                             "never admitted")
        out.append(lane_bid(*divmod(code, cfg.seq_capacity)))
    return out


def reconfigure_pipeline(cfg: PipelineConfig, state: PipelineState,
                         old_epoch: int, new_epoch: int)\
        -> tuple[PipelineState, dict]:
    """Quiescent drain-then-switch: ``engine.api.reconfigure``, plus the
    pipeline's refusal to re-home. Callers drain first (tick with no
    arrivals until every admitted batch is ordered). Raises if the
    engine had to move any id. Modifies no input."""
    estate, report = api.reconfigure(cfg.engine, state.engine,
                                     old_epoch, new_epoch)
    if int(report.get("moved", 0)) != 0:
        raise ValueError(
            f"reconfigure moved {report['moved']} in-flight ids between "
            "rows; the closed pipeline requires a drained engine at the "
            "epoch switch (no admitted-but-unordered batches)")
    return state._replace(engine=estate), report


def plan_admissions(cfg: PipelineConfig, workload: Workload,
                    route_table) -> dict:
    """Host-side twin of stages 1–3a: replay the workload through one
    streaming ``BatchAccumulator`` per lane (tail-flushed every tick) and
    the same route table (array or tensor). Returns ``{group: [{"lane",
    "seq", "tick", "rank"}, ...]}`` in admission order. Independent of
    the tensor path, which must give the same ranks, ticks and codes."""
    arrived = workload.arrived.cpu().numpy()
    sizes = workload.sizes.cpu().numpy()
    route_table = np.asarray(route_table.cpu() if isinstance(
        route_table, torch.Tensor) else route_table)
    D = cfg.n_lanes
    accs = [BatchAccumulator(cfg.budget_bytes, cfg.max_requests)
            for _ in range(D)]
    seqs = [0] * D
    admits = {g: [] for g in range(cfg.engine.groups)}

    def admit(d, t):
        s = seqs[d]
        seqs[d] += 1
        if s >= cfg.seq_capacity:
            raise ValueError(f"lane {d} overflowed seq_capacity="
                             f"{cfg.seq_capacity}")
        g = int(route_table[d, s])
        admits[g].append({"lane": d, "seq": s, "tick": t,
                          "rank": len(admits[g])})

    for t in range(arrived.shape[0]):
        closures = [0] * D                # overflow closures per lane
        for c in np.nonzero(arrived[t])[0].tolist():
            if accs[c % D].add(int(sizes[t, c])) is not None:
                closures[c % D] += 1
        # lane-major: a lane's overflow closures, then its tail
        for d in range(D):
            for _ in range(closures[d]):
                admit(d, t)
            if accs[d].flush() is not None:
                admit(d, t)
    return admits
