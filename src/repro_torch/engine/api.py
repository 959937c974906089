"""Unified Engine facade over the four engine families.

One configuration object and one facade over ``engine.sharded``'s
``plain``, ``recycled``, ``gated`` and ``gated_recycled`` families:

    cfg = EngineConfig(groups=4, window=2048, n_diss=1000, n_seq=16,
                       order_budget=64, merge_capacity=16384,
                       recycling=RecyclingConfig(watermark=1024,
                                                 id_stride=1 << 22),
                       gating=GatingConfig(n_diss_partition=250))
    eng = Engine.create(cfg)                 # state on the CUDA device
    out = eng.tick(acks, votes, holds)       # one step, merge-appended
    merged, count, committed = eng.run(acks_seq, votes_seq, holds_seq)

Every knob is normalized and validated once, in
``EngineConfig.__post_init__``, with the reference's rules and messages.
The family is implied by which sub-configs are present. Tiles are packed
``torch.int32`` bitsets on the state's device.

Two layers: the functional ``create_state``/``tick``/``run``/
``recycle``/``reconfigure``/``committed_prefix`` over an
:class:`EngineState`, which modify no input unless called with
``inplace=True``; and :class:`Engine`, which owns its state and advances
it in place (the kernels write their bitset outputs into the state's
buffers, the counterpart of the reference's buffer donation).

``EngineConfig.epochs`` takes an ``engine.epochs.EpochTable``
(drain-then-switch membership: :func:`reconfigure`,
:meth:`Engine.reconfigure`); ``adaptive`` takes an
``engine.adaptive.AdaptiveConfig`` (adaptive tick batching:
:meth:`Engine.enqueue`, :meth:`Engine.adaptive_pass`); ``mesh`` takes a
:class:`MeshConfig` (the group rows spread over ``torch.distributed``
ranks, ``engine.meshed``): every verb then runs on the rank's rows and
gives the unmeshed results bit for bit, the same on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..dissem.engine import init_dissem
from . import adaptive as adaptive_mod
from . import epochs as epochs_mod
from . import graphs
from . import merge as merge_mod
from . import meshed as meshed_mod
from . import sharded as sharded_mod
from .adaptive import AdaptiveConfig
from .epochs import EpochTable


@dataclass(frozen=True)
class RecyclingConfig:
    """Window-recycling knobs (the ``recycled_*`` family).

    ``watermark``: a group compacts when its free-slot count drops below
    this. ``id_stride``: width of each group's private id range; must be
    explicit for ``groups > 1``; ``None`` resolves to ``window`` for a
    single group."""
    watermark: int
    id_stride: int | None = None


@dataclass(frozen=True)
class GatingConfig:
    """Dissemination-stability gating knobs (the ``gated_*`` family).

    ``n_diss_partition``: per-group disseminator partition size (``None``
    → ``n_diss``). ``stab_majority``: holds needed for stability
    (``None`` → majority of the partition). ``pre_stable`` seeds every
    slot stable; ``fresh_stable`` is what recycled slots are reborn
    with."""
    stab_majority: int | None = None
    n_diss_partition: int | None = None
    pre_stable: bool = False
    fresh_stable: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-sharded group execution knobs (``engine.meshed``).

    When set on :class:`EngineConfig`, every verb partitions the G group
    rows across the ranks of the initialised default process group
    (one process per rank; ``launch.mesh.make_group_mesh``): per-group
    quorum, stability and adaptive work runs on each rank's own rows,
    and only the round-robin merge crosses ranks (one gather of
    fixed-width entry rows per tick or pass). The merged learner log is
    bit-identical to the unmeshed path for any world size. Without a
    process group the mesh is one rank.

    ``n_devices``: mesh size; ``None`` → the world size. Clamped at
    first use to the world size and to ``groups`` (when the clamped size
    does not divide ``groups``, inert pad rows are added and sliced off
    before the merge). ``axis_name``: the mesh axis name."""
    n_devices: int | None = None
    axis_name: str = "group"


def _majority(n: int) -> int:
    return n // 2 + 1


@dataclass(frozen=True)
class EngineConfig:
    """Single source of truth for one engine instance.

    Construction normalizes every defaultable field (no ``None`` is left
    in ``diss_majority``/``seq_majority``/``max_entries``/
    ``recycling.id_stride``/``gating.*``) and raises ``ValueError`` on any
    inconsistency, before any tensor is allocated. Hashable."""
    groups: int
    window: int
    n_diss: int
    n_seq: int
    order_budget: int
    merge_capacity: int
    diss_majority: int | None = None
    seq_majority: int | None = None
    max_entries: int | None = None
    recycling: RecyclingConfig | None = None
    gating: GatingConfig | None = None
    epochs: EpochTable | None = None
    adaptive: AdaptiveConfig | None = None
    mesh: MeshConfig | None = None

    def __post_init__(self):
        def norm(field, value):
            object.__setattr__(self, field, value)

        for f in ("groups", "window", "n_diss", "n_seq", "order_budget",
                  "merge_capacity"):
            if int(getattr(self, f)) < 1:
                raise ValueError(f"EngineConfig.{f} must be >= 1, got "
                                 f"{getattr(self, f)}")
            norm(f, int(getattr(self, f)))
        if self.diss_majority is None:
            norm("diss_majority", _majority(self.n_diss))
        if self.seq_majority is None:
            norm("seq_majority", _majority(self.n_seq))
        for f, n in (("diss_majority", self.n_diss),
                     ("seq_majority", self.n_seq)):
            v = int(getattr(self, f))
            if not 1 <= v <= n:
                raise ValueError(f"EngineConfig.{f}={v} out of range "
                                 f"[1, {n}]")
            norm(f, v)
        # merge-buffer width, enforced at config time so no tick can ever
        # silently truncate
        if self.max_entries is None:
            norm("max_entries", self.order_budget)
        elif int(self.max_entries) < self.order_budget:
            raise ValueError(
                f"max_entries={self.max_entries} < order_budget="
                f"{self.order_budget}: a tick could assign more ids than "
                "the merge buffer holds — truncated entries desynchronize "
                "the commit gate's instance ranks")
        else:
            norm("max_entries", int(self.max_entries))
        if self.recycling is not None:
            r = self.recycling
            if int(r.watermark) < 1:
                raise ValueError(
                    f"RecyclingConfig.watermark must be >= 1, got "
                    f"{r.watermark}")
            if r.id_stride is None:
                if self.groups > 1:
                    raise ValueError(
                        "RecyclingConfig.id_stride must be explicit for "
                        "groups > 1: recycling issues fresh ids past "
                        "g*id_stride + window, so a defaulted stride of "
                        "`window` would collide with the next group's id "
                        "range at the first recycle")
                r = RecyclingConfig(int(r.watermark), self.window)
            elif int(r.id_stride) < self.window:
                raise ValueError(
                    f"RecyclingConfig.id_stride={r.id_stride} < window="
                    f"{self.window}: a group's initial window would "
                    "already overlap the next group's id range")
            else:
                r = RecyclingConfig(int(r.watermark), int(r.id_stride))
            norm("recycling", r)
        if self.gating is not None:
            g = self.gating
            part = self.n_diss if g.n_diss_partition is None \
                else int(g.n_diss_partition)
            if part < 1:
                raise ValueError(
                    f"GatingConfig.n_diss_partition must be >= 1, got "
                    f"{g.n_diss_partition}")
            stab = _majority(part) if g.stab_majority is None \
                else int(g.stab_majority)
            if not 1 <= stab <= part:
                raise ValueError(
                    f"GatingConfig.stab_majority={stab} out of range "
                    f"[1, {part}]")
            norm("gating", GatingConfig(stab, part, bool(g.pre_stable),
                                        bool(g.fresh_stable)))
        if self.adaptive is not None and \
                not isinstance(self.adaptive, AdaptiveConfig):
            raise ValueError(
                f"EngineConfig.adaptive must be an AdaptiveConfig, got "
                f"{type(self.adaptive).__name__}")
        if self.mesh is not None:
            m = self.mesh
            if not isinstance(m, MeshConfig):
                raise ValueError(
                    f"EngineConfig.mesh must be a MeshConfig, got "
                    f"{type(m).__name__}")
            if m.n_devices is not None and int(m.n_devices) < 1:
                raise ValueError(
                    f"MeshConfig.n_devices must be >= 1, got "
                    f"{m.n_devices}")
            norm("mesh", MeshConfig(
                None if m.n_devices is None else int(m.n_devices),
                str(m.axis_name)))
        if self.epochs is not None and self.epochs.n_rows != self.groups:
            raise ValueError(
                f"EpochTable.n_rows={self.epochs.n_rows} must equal "
                f"groups={self.groups}: physical rows are allocated once "
                "and epochs activate subsets")

    @property
    def family(self) -> str:
        """Which engine family this config resolves to."""
        if self.recycling is not None:
            return "gated_recycled" if self.gating is not None \
                else "recycled"
        return "gated" if self.gating is not None else "plain"


class EngineState(NamedTuple):
    """The facade's engine state.

    ``core`` is the family state (QuorumState / RecycleState /
    GatedRecycleState); ``dissem`` the DissemState of the non-recycled
    gated family (``None`` otherwise); ``slot_ids`` the slot→id map of
    the non-recycled families (``None`` otherwise — it lives in
    RecycleState); ``merge`` the deterministic merge log.

    Under a mesh, ``core``, ``dissem`` and ``slot_ids`` hold the rank's
    rows (pad rows included) and ``merge`` is the full replica;
    ``meshed.gather_state`` gives the logical state."""
    core: Any
    dissem: Any
    slot_ids: Any
    merge: merge_mod.MergeState


def create_state(cfg: EngineConfig, device=None) -> EngineState:
    """Fresh engine state for a validated config, on ``device`` (default
    ``cuda``, the current CUDA device; raises when there is none). Under
    a mesh, the rank's rows and a full merge replica."""
    dev = resolve_device(device)
    ms = merge_mod.init_merge(cfg.groups, cfg.merge_capacity, dev)
    if cfg.mesh is not None:
        mesh = meshed_mod.member_mesh(cfg)
        core, dissem, sids = meshed_mod.fresh_rows(cfg, mesh.rows,
                                                   mesh.first, dev)
        return EngineState(core=core, dissem=dissem, slot_ids=sids,
                           merge=ms)
    if cfg.family in ("plain", "gated"):
        dissem = None if cfg.gating is None else init_dissem(
            cfg.groups, cfg.window, cfg.gating.n_diss_partition,
            pre_stable=cfg.gating.pre_stable, device=dev)
        return EngineState(
            core=sharded_mod.init_sharded(cfg.groups, cfg.window,
                                          cfg.n_diss, cfg.n_seq, dev),
            dissem=dissem,
            slot_ids=sharded_mod.default_slot_ids(cfg.groups, cfg.window,
                                                  dev),
            merge=ms)
    if cfg.family == "recycled":
        core = sharded_mod.init_recycled(
            cfg.groups, cfg.window, cfg.n_diss, cfg.n_seq,
            id_stride=cfg.recycling.id_stride, device=dev)
    else:
        core = sharded_mod.init_gated_recycled(
            cfg.groups, cfg.window, cfg.n_diss, cfg.n_seq,
            n_diss_partition=cfg.gating.n_diss_partition,
            id_stride=cfg.recycling.id_stride,
            pre_stable=cfg.gating.pre_stable, device=dev)
    return EngineState(core=core, dissem=None, slot_ids=None, merge=ms)


def slot_ids(state: EngineState) -> torch.Tensor:
    """Live slot→global-id map, whichever family holds it (under a mesh,
    the rank's rows)."""
    if state.slot_ids is not None:
        return state.slot_ids
    core = state.core
    if isinstance(core, sharded_mod.GatedRecycleState):
        return core.rs.slot_ids
    return core.slot_ids


def _need_holds(cfg: EngineConfig, holds) -> None:
    if (cfg.gating is not None) == (holds is None):
        raise ValueError(
            "hold tiles are required exactly when gating is configured: "
            f"family={cfg.family!r}, holds "
            f"{'missing' if holds is None else 'given'}")


def _family_kw(cfg: EngineConfig) -> dict:
    kw = dict(diss_majority=cfg.diss_majority, seq_majority=cfg.seq_majority,
              order_budget=cfg.order_budget, max_entries=cfg.max_entries)
    if cfg.recycling is not None:
        kw.update(watermark=cfg.recycling.watermark,
                  id_stride=cfg.recycling.id_stride)
    if cfg.gating is not None:
        kw.update(stab_majority=cfg.gating.stab_majority)
        if cfg.recycling is not None:
            kw.update(fresh_stable=cfg.gating.fresh_stable)
    return kw


def tick(cfg: EngineConfig, state: EngineState, acks: torch.Tensor,
         votes: torch.Tensor, holds: torch.Tensor | None = None, *,
         inplace: bool = False) -> tuple[EngineState, dict]:
    """One merge-appended engine step (recycled families also recycle).
    The host-driven entry point for id-addressed traffic: re-read
    :func:`slot_ids` between calls. Returns ``(state, out)`` with the
    family tick's outputs plus ``out["dropped"]``; under a mesh, the
    reduced ``{"assigned", "dropped"}`` (``meshed.tick``)."""
    _need_holds(cfg, holds)
    if cfg.mesh is not None:
        return meshed_mod.tick(cfg, state, acks, votes, holds,
                               inplace=inplace)
    fam = cfg.family
    kw = _family_kw(cfg)
    if fam == "recycled":
        rs, ms, out = sharded_mod.recycled_tick_merged(
            state.core, state.merge, acks, votes, inplace=inplace, **kw)
        return state._replace(core=rs, merge=ms), out
    if fam == "gated_recycled":
        gs, ms, out = sharded_mod.gated_recycled_tick_merged(
            state.core, state.merge, acks, holds, votes, inplace=inplace,
            **kw)
        return state._replace(core=gs, merge=ms), out
    max_entries = kw.pop("max_entries")
    if fam == "gated":
        core, d, out = sharded_mod.gated_tick(
            state.core, state.dissem, acks, holds, votes, inplace=inplace,
            **kw)
    else:
        core, out = sharded_mod.sharded_tick(state.core, acks, votes,
                                             inplace=inplace, **kw)
        d = None
    ms, dropped = sharded_mod._append(state.merge, out["assigned"],
                                      state.slot_ids, max_entries)
    return (state._replace(core=core, dissem=d, merge=ms),
            dict(out, dropped=dropped))


def run(cfg: EngineConfig, state: EngineState, acks_seq: torch.Tensor,
        votes_seq: torch.Tensor, holds_seq: torch.Tensor | None = None, *,
        inplace: bool = False)\
        -> tuple[EngineState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-tick hot loop over [T, G, W, WORDS] tile sequences through
    the family's ``run_*_ticks_merged``. Returns ``(state, merged,
    merged_count, committed_count)``; recycled families need
    position-uniform traffic inside a run. Under a mesh, ``meshed.run``
    over the same logical traffic."""
    _need_holds(cfg, holds_seq)
    if cfg.mesh is not None:
        return meshed_mod.run(cfg, state, acks_seq, votes_seq, holds_seq,
                              inplace=inplace)
    fam = cfg.family
    kw = dict(_family_kw(cfg), inplace=inplace)
    if fam == "plain":
        core, ms, merged, count, committed = \
            sharded_mod.run_sharded_ticks_merged(
                state.core, state.merge, acks_seq, votes_seq,
                state.slot_ids, **kw)
        return (state._replace(core=core, merge=ms), merged, count,
                committed)
    if fam == "gated":
        core, d, ms, merged, count, committed = \
            sharded_mod.run_gated_ticks_merged(
                state.core, state.dissem, state.merge, acks_seq,
                holds_seq, votes_seq, state.slot_ids, **kw)
        return (state._replace(core=core, dissem=d, merge=ms), merged,
                count, committed)
    if fam == "recycled":
        core, ms, merged, count, committed = \
            sharded_mod.run_recycled_ticks_merged(
                state.core, state.merge, acks_seq, votes_seq, **kw)
    else:
        core, ms, merged, count, committed = \
            sharded_mod.run_gated_recycled_ticks_merged(
                state.core, state.merge, acks_seq, holds_seq, votes_seq,
                **kw)
    return state._replace(core=core, merge=ms), merged, count, committed


def recycle(cfg: EngineConfig, state: EngineState)\
        -> tuple[EngineState, torch.Tensor]:
    """Explicit watermark-gated compaction pass (normally implicit in
    :func:`tick`/:func:`run` for recycled families). Returns
    ``(state, n_retired int32[G])`` (under a mesh, gathered)."""
    if cfg.recycling is None:
        raise ValueError(
            f"recycle() needs recycling configured (family={cfg.family!r}"
            " has a single-use window)")
    id_base = None
    if cfg.mesh is not None:
        id_base = meshed_mod.local_id_base(cfg, state.merge.logs.device)
    if cfg.family == "gated_recycled":
        core, n = sharded_mod.gated_recycle_groups(
            state.core, watermark=cfg.recycling.watermark,
            id_stride=cfg.recycling.id_stride,
            fresh_stable=cfg.gating.fresh_stable, id_base=id_base)
    else:
        core, n = sharded_mod.recycle_groups(
            state.core, watermark=cfg.recycling.watermark,
            id_stride=cfg.recycling.id_stride, id_base=id_base)
    if cfg.mesh is not None:
        n = meshed_mod.gather_rows(cfg, n)
    return state._replace(core=core), n


def reconfigure(cfg: EngineConfig, state: EngineState, old_epoch: int,
                new_epoch: int) -> tuple[EngineState, dict]:
    """Drain-then-switch epoch change (host-side control plane, between
    ticking segments). Requires ``cfg.epochs``; dispatches to the
    family's ``epochs.reconfigure_*``. Modifies no input. Returns
    ``(state, report)``. Under a mesh every rank gathers the logical
    state, switches it as the unmeshed engine does, and takes its rows
    back: the reference's host gather and re-shard."""
    if cfg.epochs is None:
        raise ValueError("reconfigure() needs EngineConfig.epochs set")
    if cfg.mesh is not None:
        logical, report = reconfigure(
            meshed_mod.unmeshed(cfg), meshed_mod.gather_state(cfg, state),
            old_epoch, new_epoch)
        return meshed_mod.shard_state(cfg, logical), report
    fam = cfg.family
    if fam == "plain":
        core, sids, ms, report = epochs_mod.reconfigure_plain(
            state.core, state.slot_ids, state.merge, cfg.epochs,
            old_epoch, new_epoch)
        return state._replace(core=core, slot_ids=sids, merge=ms), report
    if fam == "recycled":
        core, ms, report = epochs_mod.reconfigure_recycled(
            state.core, state.merge, cfg.epochs, old_epoch, new_epoch,
            id_stride=cfg.recycling.id_stride)
        return state._replace(core=core, merge=ms), report
    if fam == "gated_recycled":
        core, ms, report = epochs_mod.reconfigure_gated_recycled(
            state.core, state.merge, cfg.epochs, old_epoch, new_epoch,
            id_stride=cfg.recycling.id_stride,
            fresh_stable=cfg.gating.fresh_stable)
        return state._replace(core=core, merge=ms), report
    raise ValueError(
        "reconfigure() is not defined for the gated non-recycled family "
        "(no legacy reconfigure_* exists: sealing removed rows needs the "
        "recycled retired-base commit gate) — add recycling")


def committed_prefix(cfg: EngineConfig, state: EngineState)\
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(merged, merged_count, committed_count) of the current state,
    without ticking — recycle-aware for recycled families."""
    if cfg.mesh is not None:
        return meshed_mod.committed_prefix(cfg, state)
    if cfg.recycling is not None:
        rs = state.core.rs if cfg.family == "gated_recycled" \
            else state.core
        return sharded_mod.recycled_committed_prefix(rs, state.merge)
    return sharded_mod._live_committed(state.core, state.merge)


class Engine:
    """Stateful facade: one engine instance, any family.

    ``Engine.create(cfg)`` builds fresh state; ``.tick()``/``.run()``
    advance it in place and return the outputs; ``.recycle()`` and
    ``.reconfigure()`` are the explicit control-plane entry points;
    ``.enqueue()``/``.adaptive_pass()``/``.run_adaptive()`` drive
    adaptive tick batching (``cfg.adaptive``) over :attr:`queue`,
    created on first use.

    ``run`` (unmeshed) steps one loop of the tick (``engine.graphs``)
    whose static buffers are this engine's state: a later run with the
    same shapes steps the same loop, and what ``tick``, ``recycle``,
    ``reconfigure`` or ``enqueue`` changed in between is copied into
    the buffers first. With ``capture`` (:meth:`create`) the loop is one
    captured CUDA graph, replayed, and ``adaptive_pass`` and
    ``run_adaptive`` replay one of the fixed-K pass; without it the loop
    runs the same tick eagerly and the adaptive passes run R rounds.
    ``tick`` stays eager."""

    def __init__(self, cfg: EngineConfig, state: EngineState,
                 epoch: int = 0, capture: bool = False) -> None:
        self.cfg = cfg
        self.state = state
        self.epoch = int(epoch)
        self.queue: adaptive_mod.TrafficQueue | None = None
        self.capture = bool(capture)
        self._loops: dict = {}

    @classmethod
    def create(cls, cfg: EngineConfig, *, device=None, epoch: int = 0,
               capture: bool | None = None) -> "Engine":
        """Build a fresh engine for ``cfg`` on ``device`` (default
        ``cuda``; raises when there is no CUDA device). ``epoch`` must
        index ``cfg.epochs`` when an :class:`EpochTable` is
        configured. ``capture``: ``None`` captures on a CUDA device and
        runs eagerly on the CPU (CUDA graphs do not exist there) and
        under a mesh (the captured meshed tick is not ported); ``True``
        raises there. A failed capture or replay raises: nothing falls
        back to the eager loop."""
        if cfg.epochs is not None and \
                not 0 <= int(epoch) < cfg.epochs.n_epochs:
            raise ValueError(f"epoch {epoch} not in EpochTable "
                             f"(n={cfg.epochs.n_epochs})")
        state = create_state(cfg, device)
        capture = graphs.resolve_capture(
            capture, state.merge.logs.device, "Engine",
            None if cfg.mesh is None else
            "under a mesh (the captured meshed tick is not ported)")
        return cls(cfg, state, epoch=epoch, capture=capture)

    def tick(self, acks, votes, holds=None) -> dict:
        """One engine step on packed tiles — ``acks`` int32[G, W,
        WORDS_diss], ``votes`` int32[G, W, WORDS_seq], ``holds`` int32[G,
        W, WORDS_part] iff ``cfg.gating`` is set. Re-read :attr:`slot_ids`
        afterwards (recycling remaps slots). Returns the tick's
        outputs."""
        self.state, out = tick(self.cfg, self.state, acks, votes, holds,
                               inplace=True)
        return out

    def run(self, acks_seq, votes_seq, holds_seq=None)\
            -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Multi-tick run over [T, G, W, WORDS] tile sequences →
        ``(merged, merged_count, committed_count)``: T steps of the
        engine's loop (T replays of the captured tick with
        ``capture``); under a mesh, the meshed ``run``."""
        if self.cfg.mesh is None:
            return graphs.engine_run(self, acks_seq, votes_seq, holds_seq)
        self.state, merged, count, committed = run(
            self.cfg, self.state, acks_seq, votes_seq, holds_seq,
            inplace=True)
        return merged, count, committed

    def recycle(self) -> torch.Tensor:
        """Explicit watermark-gated compaction (recycled families).
        Returns retired-per-group int32[G]."""
        self.state, n = recycle(self.cfg, self.state)
        return n

    def reconfigure(self, new_epoch: int) -> dict:
        """Drain-then-switch to ``new_epoch`` (requires ``cfg.epochs``).
        Rows leaving the active set must be drained (``ValueError``
        otherwise). Appends one aligned RECONFIG marker round, seals
        removed rows, re-homes in-flight ids. Returns the move report."""
        self.state, report = reconfigure(self.cfg, self.state, self.epoch,
                                         int(new_epoch))
        self.epoch = int(new_epoch)
        return report

    def committed(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(merged, merged_count, committed_count)`` for the current
        state — ``merged[:committed_count]`` is the executable prefix."""
        return committed_prefix(self.cfg, self.state)

    # -- adaptive tick batching (cfg.adaptive) -------------------------------

    def _queue(self, what: str) -> adaptive_mod.TrafficQueue:
        if self.cfg.adaptive is None:
            raise ValueError(f"{what}() needs EngineConfig.adaptive set")
        if self.queue is None:
            self.queue = adaptive_mod.init_queue(
                self.cfg, device=self.state.merge.logs.device)
        return self.queue

    def enqueue(self, acks, votes, holds=None, mask=None) -> None:
        """Queue one pre-packed tile set per group (rows where ``mask``)
        for adaptive passes, in place; a full ring counts the tile in
        ``queue.dropped``. Under a mesh the tiles are logical and the
        rank queues its rows."""
        queue = self._queue("enqueue")
        if self.cfg.mesh is not None:
            if mask is None:       # pad rows stay empty
                mask = torch.ones((self.cfg.groups,), dtype=torch.bool,
                                  device=acks.device)
            acks, votes, holds, mask = (
                meshed_mod.local_rows(self.cfg, x)
                for x in (acks, votes, holds, mask))
        self.queue = adaptive_mod.enqueue(queue, acks, votes, holds=holds,
                                          mask=mask, inplace=True)

    def adaptive_pass(self) -> dict:
        """One adaptive merged pass over the queued traffic, in place:
        lagging groups consume up to ``cfg.adaptive.max_tiles_per_tick``
        tiles, caught-up groups one (or none, padded with SKIP rounds).
        Returns ``rounds``/``consumed``/``dropped``; ``rounds == 0``
        means the engine is drained. With ``capture``, one replay of the
        captured fixed-K pass (no host read)."""
        if self.capture:
            return graphs.engine_adaptive(self)
        self.state, self.queue, out = adaptive_mod.adaptive_pass(
            self.cfg, self.state, self._queue("adaptive_pass"),
            inplace=True)
        return out

    def run_adaptive(self, n_passes: int)\
            -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``n_passes`` adaptive passes over the queued traffic, then the
        commit gate → ``(merged, merged_count, committed_count)``
        (``adaptive.run_adaptive``); with ``capture``, ``n_passes``
        replays of the captured pass with no host read between them."""
        if self.capture:
            return graphs.engine_adaptive(self, n_passes)
        self.state, self.queue, merged, count, committed = \
            adaptive_mod.run_adaptive(
                self.cfg, self.state, self._queue("run_adaptive"),
                n_passes=n_passes, inplace=True, capture=False)
        return merged, count, committed

    @property
    def slot_ids(self) -> torch.Tensor:
        """Live slot→id map int32[G, W] (re-read between ticks; under
        a mesh, the rank's rows)."""
        return slot_ids(self.state)

    @property
    def merge_state(self) -> merge_mod.MergeState:
        """The round-robin merge logs."""
        return self.state.merge

    def __repr__(self) -> str:
        return (f"Engine(family={self.cfg.family!r}, "
                f"groups={self.cfg.groups}, window={self.cfg.window}, "
                f"epoch={self.epoch})")
