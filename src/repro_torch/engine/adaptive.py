"""Per-group adaptive tick batching: lagging groups absorb extra tiles.

The engine ticks all G groups in lock-step, one traffic tile per group
per tick, so one lagging group (a deep unconsumed backlog, unstable
dissemination, stalled votes) sets the pace for all of them. An adaptive
pass lets a lagging group absorb ``k_g ∈ {1..K}`` queued tiles while a
caught-up group absorbs at most one, without changing the merged
learner output by a single bit.

How exactness works (as in the reference): the round-robin merge
interleaves per-group logs by round, and lock-step ticking appends one
round per group per tick. A pass advances every group by the same
``R ∈ {1..K}`` rounds, each ``max_entries`` wide; group g really ticks
in round j only when it consumes a queued tile (``j < k_g``) or has
stable-but-unassigned slots that a zero-tile tick would assign, and
otherwise its round is pure SKIP, bit for bit what a lock-step tick
over a zero tile would have logged. So for pre-loaded traffic any
pacing gives the lock-step merged prefix at quiescence, in all four
families.

Port notes:

* **R on the host, or K rounds on the card.** The reference runs K
  masked iterations inside one jit. Eagerly each round launches a whole
  tick, so a pass reads R once (``int(R)``, the only host sync of a
  pass) and runs exactly R rounds: a pass launches the quorum kernel 2R
  times and, in the gated families, the stability kernel R times. A
  round in which no group is active (the reference's ``lax.cond`` skip)
  still runs the masked tick, which then leaves the state unchanged and
  writes all-SKIP entries. The captured pass (``fixed=True``,
  ``engine.graphs``) is the reference's form: K rounds every pass, each
  row masked with ``active = (j < R) & (consume | assignable)``, so a
  round j >= R changes nothing and R never leaves the card.
* **Masked rounds.** Each round's family tick runs functionally; the
  active groups' rows are then selected into the live state
  (``torch.where``), written back in place when the pass is in place.
  An inactive group's rows are never overwritten.
* **Out-of-range drops.** ``enqueue``'s rejected rows are a masked
  write: the slot index is clamped and the row written back unchanged.

Entry points: :func:`init_queue` / :func:`enqueue` /
:func:`queue_from_arrays` (the per-group ring of pre-packed tiles),
:func:`plan_rounds` (the policy), :func:`adaptive_pass`,
:func:`run_adaptive` and :func:`subtick_pass` (the queue-less variant
the closed pipeline wires in). All of them run under
``EngineConfig.mesh`` too, as the reference's ``meshed`` twins do: the
queue holds the rank's rows, R comes from the gathered lag, the rounds
run on the rank's rows and one gather feeds the merge replica
(``engine.meshed``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..core.tilesim import QuorumState, _words, admitted_mask
from ..device import resolve_device
from ..dissem.engine import unstable_backlog
from . import graphs
from . import merge as merge_mod
from . import meshed as meshed_mod
from . import sharded as sharded_mod

POLICIES = ("backlog", "undecided", "unstable")

_I32 = torch.int32


@dataclass(frozen=True)
class AdaptiveConfig:
    """Adaptive tick-batching knobs (hashable).

    ``max_tiles_per_tick`` (K): the most rounds of one pass.
    ``policy``: the per-group lag metric that sets the round count —
    ``"backlog"`` (unconsumed queued tiles; ``"undecided"`` in the
    queue-less pipeline wiring), ``"undecided"`` (admitted but not yet
    decided slots) or ``"unstable"`` (admitted but not dissemination-
    stable slots; quorum-side stability for ungated families).
    ``threshold``: lag units per extra round — a pass runs
    ``1 + clip((max(lag) − min(lag)) // threshold, 0, K−1)`` rounds.
    ``queue_capacity``: tiles per group the :class:`TrafficQueue`
    ring holds."""
    max_tiles_per_tick: int
    policy: str = "backlog"
    threshold: int = 1
    queue_capacity: int = 64

    def __post_init__(self):
        if int(self.max_tiles_per_tick) < 1:
            raise ValueError("AdaptiveConfig.max_tiles_per_tick must be "
                             f">= 1, got {self.max_tiles_per_tick}")
        if self.policy not in POLICIES:
            raise ValueError(f"AdaptiveConfig.policy={self.policy!r} not "
                             f"in {POLICIES}")
        if int(self.threshold) < 1:
            raise ValueError("AdaptiveConfig.threshold must be >= 1, got "
                             f"{self.threshold}")
        if int(self.queue_capacity) < 1:
            raise ValueError("AdaptiveConfig.queue_capacity must be >= 1, "
                             f"got {self.queue_capacity}")


class TrafficQueue(NamedTuple):
    """Per-group ring buffer of pre-packed traffic tiles.

    ``acks`` int32[G, C, W, WORDS_D], ``votes`` int32[G, C, W, WORDS_S],
    ``holds`` int32[G, C, W, WORDS_P] for gated families (``None``
    otherwise), C = ``AdaptiveConfig.queue_capacity``. ``head`` /
    ``tail`` are per-group int32 cursors (tile t lives at slot t % C);
    ``dropped`` counts tiles rejected by a full ring."""
    acks: torch.Tensor
    votes: torch.Tensor
    holds: Any
    head: torch.Tensor     # int32[G]
    tail: torch.Tensor     # int32[G]
    dropped: torch.Tensor  # int32[G]


def init_queue(cfg, capacity: int | None = None,
               device=None) -> TrafficQueue:
    """Empty :class:`TrafficQueue` shaped for ``cfg`` (an ``EngineConfig``
    with ``adaptive`` set) on ``device`` (default ``cuda``); ``capacity``
    overrides ``cfg.adaptive.queue_capacity``. Under a mesh, the queue
    of the rank's rows."""
    if cfg.adaptive is None:
        raise ValueError("init_queue() needs EngineConfig.adaptive set")
    dev = resolve_device(device)
    C = int(cfg.adaptive.queue_capacity if capacity is None else capacity)
    G, W = cfg.groups, cfg.window
    if cfg.mesh is not None:
        G = meshed_mod.member_mesh(cfg).rows

    def ring(n):
        return torch.zeros((G, C, W, _words(n)), dtype=_I32, device=dev)
    return TrafficQueue(
        acks=ring(cfg.n_diss), votes=ring(cfg.n_seq),
        holds=None if cfg.gating is None
        else ring(cfg.gating.n_diss_partition),
        head=torch.zeros((G,), dtype=_I32, device=dev),
        tail=torch.zeros((G,), dtype=_I32, device=dev),
        dropped=torch.zeros((G,), dtype=_I32, device=dev))


def backlog(queue: TrafficQueue) -> torch.Tensor:
    """int32[G]: unconsumed tiles per group (the ``"backlog"`` lag)."""
    return queue.tail - queue.head


def enqueue(queue: TrafficQueue, acks: torch.Tensor, votes: torch.Tensor,
            holds: torch.Tensor | None = None,
            mask: torch.Tensor | None = None, *,
            inplace: bool = False) -> TrafficQueue:
    """Append one tile set per group (rows where ``mask``, default all).

    acks int32[G, W, WORDS_D], votes int32[G, W, WORDS_S], holds required
    exactly when the queue carries them; under a mesh, the rank's rows
    (``meshed.local_rows``). A full ring rejects the tile
    and counts it in ``queue.dropped`` (dropping traffic is lossy:
    callers size ``queue_capacity`` for the worst burst and check
    ``dropped``). ``inplace`` writes the tiles into the queue's own
    buffers; otherwise no input is modified."""
    if (queue.holds is None) != (holds is None):
        raise ValueError(
            "hold tiles are required exactly when the queue carries them: "
            f"queue {'has' if queue.holds is not None else 'lacks'} holds, "
            f"enqueue() {'got' if holds is not None else 'missing'} them")
    G, C = queue.acks.shape[:2]
    dev = queue.acks.device
    if mask is None:
        mask = torch.ones((G,), dtype=torch.bool, device=dev)
    fits = (queue.tail - queue.head) < C
    write = mask & fits
    g = torch.arange(G, device=dev)
    pos = (queue.tail % C).long()

    def put(buf, tile):
        # one row per group, so (g, pos) never repeats: a rejected row
        # writes its old contents back
        out = buf if inplace else buf.clone()
        m = write.view(-1, *(1,) * (tile.dim() - 1))
        out[g, pos] = torch.where(m, tile, out[g, pos])
        return out
    return TrafficQueue(
        acks=put(queue.acks, acks), votes=put(queue.votes, votes),
        holds=None if holds is None else put(queue.holds, holds),
        head=queue.head, tail=queue.tail + write.to(_I32),
        dropped=queue.dropped + (mask & ~fits).to(_I32))


def queue_from_arrays(cfg, acks_seq: torch.Tensor, votes_seq: torch.Tensor,
                      holds_seq: torch.Tensor | None = None,
                      lengths=None) -> TrafficQueue:
    """Pre-loaded queue from lock-step traffic tensors.

    acks_seq int32[T, G, W, WORDS_D] (the input of ``api.run``), likewise
    votes and holds; the queue lives on their device. ``lengths`` int[G]
    gives each group's true tile count (≤ T; default T for all): tiles
    past a group's length are never consumed, which is how a skewed
    workload is expressed. Pre-loading is the regime in which adaptive
    pacing is bit-identical to lock-step. Under a mesh the tensors are
    logical and the queue holds the rank's rows (pad rows empty)."""
    if (cfg.gating is not None) != (holds_seq is not None):
        raise ValueError(
            "hold traffic is required exactly when gating is configured: "
            f"family={cfg.family!r}, holds_seq "
            f"{'missing' if holds_seq is None else 'given'}")
    T, G = acks_seq.shape[:2]
    dev = acks_seq.device
    tail = torch.full((G,), T, dtype=_I32, device=dev) if lengths is None \
        else torch.as_tensor(lengths, dtype=_I32).to(dev)
    if cfg.mesh is not None:
        acks_seq, votes_seq, holds_seq = (
            meshed_mod.local_rows(cfg, x, 1)
            for x in (acks_seq, votes_seq, holds_seq))
        tail = meshed_mod.local_rows(cfg, tail)
        G = tail.shape[0]

    def ring(x):
        return None if x is None else x.transpose(0, 1).contiguous()
    return TrafficQueue(
        acks=ring(acks_seq), votes=ring(votes_seq), holds=ring(holds_seq),
        head=torch.zeros((G,), dtype=_I32, device=dev), tail=tail,
        dropped=torch.zeros((G,), dtype=_I32, device=dev))


# -- lag metrics --------------------------------------------------------------

def _quorum(cfg, core) -> QuorumState:
    """The QuorumState of any family's core state."""
    fam = cfg.family
    if fam in ("plain", "gated"):
        return core
    if fam == "recycled":
        return core.q
    return core.rs.q


def _dissem(cfg, core, dissem):
    """The DissemState of a gated family's state (None for ungated)."""
    if cfg.family == "gated":
        return dissem
    if cfg.family == "gated_recycled":
        return core.d
    return None


def undecided_depth(q: QuorumState) -> torch.Tensor:
    """int32[G]: admitted-but-undecided slots per group — the ordering-
    side lag (``"undecided"`` policy)."""
    return (admitted_mask(q) & ~q.decided).sum(dim=-1, dtype=_I32)


def _assignable(q: QuorumState) -> torch.Tensor:
    """int32[G]: stable-but-unassigned slots — what a zero-tile tick
    would still make progress on."""
    return (q.stable & (q.instance < 0)).sum(dim=-1, dtype=_I32)


def _state_lag(cfg, core, dissem, policy: str) -> torch.Tensor:
    """Per-group lag from the engine state alone (no queue)."""
    q = _quorum(cfg, core)
    if policy == "undecided":
        return undecided_depth(q)
    d = _dissem(cfg, core, dissem)
    if d is not None:
        return unstable_backlog(d)
    # ungated families: quorum-side stability plays the dissemination role
    return (admitted_mask(q) & ~q.stable).sum(dim=-1, dtype=_I32)


def _rounds_from_spread(ad: AdaptiveConfig, lag: torch.Tensor)\
        -> torch.Tensor:
    spread = lag.max() - lag.min()
    return (1 + (spread // ad.threshold).clamp(
        0, ad.max_tiles_per_tick - 1)).to(_I32)


def plan_rounds(cfg, state, queue: TrafficQueue)\
        -> tuple[torch.Tensor, torch.Tensor]:
    """The batching policy: (R int32 scalar, k int32[G]) on the device.

    ``R ∈ {0..K}`` is the round count of the next pass (0 iff every
    group is drained and has no assignable backlog: a no-op pass);
    ``k = min(R, backlog)`` is how many queued tiles each group
    consumes. Under a mesh, the lag and need of every rank's rows are
    gathered first (pad rows sliced off, so they cannot distort the
    spread): R is the same on every rank, ``k`` covers the rank's
    rows."""
    ad = cfg.adaptive
    rem = backlog(queue)
    lag = rem if ad.policy == "backlog" \
        else _state_lag(cfg, state.core, state.dissem, ad.policy)
    need = (rem > 0) | (_assignable(_quorum(cfg, state.core)) > 0)
    if cfg.mesh is not None:
        got = meshed_mod.gather_rows(cfg, torch.stack(
            [lag.to(_I32), need.to(_I32)], dim=1))
        lag, need = got[:, 0], got[:, 1].bool()
    R = _rounds_from_spread(ad, lag)
    R = torch.where(need.any(), R, 0).to(_I32)
    return R, torch.minimum(R, rem).to(_I32)


# -- the masked pass ----------------------------------------------------------

def _select_groups(mask: torch.Tensor, new, old, inplace: bool):
    """Per-group select over a state tree whose leaves have a leading G
    axis: ``new`` where ``mask``, else ``old`` (written into ``old``'s
    buffers when ``inplace``)."""
    if isinstance(old, tuple):
        return type(old)(*(_select_groups(mask, n, o, inplace)
                           for n, o in zip(new, old)))
    m = mask.view(-1, *(1,) * (old.dim() - 1))
    return torch.where(m, new, old, out=old) if inplace \
        else torch.where(m, new, old)


def _family_tick(cfg, core, dissem, slot_ids, acks, votes, holds,
                 id_base=None, inplace: bool = False):
    """One engine tick of all rows, any family: absorb → assign → vote
    (→ recycle). Returns (core', dissem', assigned int32[G, W], sids
    int32[G, W] — the slot→id map at assignment time, before any
    recycle, which is what merge entries snapshot).

    Any number of leading rows; ``id_base`` is the recycled families'
    fresh-id range override (``sharded.recycle_groups``), which the
    meshed engine sets to its rows' logical group offsets. ``inplace``
    lets the kernels write the bitsets into the state's buffers."""
    fam = cfg.family
    kw = dict(diss_majority=cfg.diss_majority, seq_majority=cfg.seq_majority,
              order_budget=cfg.order_budget, inplace=inplace)
    if fam == "plain":
        q, out = sharded_mod.sharded_tick(core, acks, votes, **kw)
        return q, None, out["assigned"], slot_ids
    if fam == "gated":
        q, d, out = sharded_mod.gated_tick(
            core, dissem, acks, holds, votes,
            stab_majority=cfg.gating.stab_majority, **kw)
        return q, d, out["assigned"], slot_ids
    rc = cfg.recycling
    if fam == "recycled":
        q, out = sharded_mod.sharded_tick(core.q, acks, votes, **kw)
        sids = core.slot_ids
        rs, _ = sharded_mod.recycle_groups(
            sharded_mod.RecycleState(q=q, slot_ids=sids,
                                     retired=core.retired),
            watermark=rc.watermark, id_stride=rc.id_stride,
            id_base=id_base)
        return rs, None, out["assigned"], sids
    q, d, out = sharded_mod.gated_tick(
        core.rs.q, core.d, acks, holds, votes,
        stab_majority=cfg.gating.stab_majority, **kw)
    sids = core.rs.slot_ids
    gs, _ = sharded_mod.gated_recycle_groups(
        sharded_mod.GatedRecycleState(
            rs=sharded_mod.RecycleState(q=q, slot_ids=sids,
                                        retired=core.rs.retired), d=d),
        watermark=rc.watermark, id_stride=rc.id_stride,
        fresh_stable=cfg.gating.fresh_stable, id_base=id_base)
    return gs, None, out["assigned"], sids


def _masked_rounds(cfg, state, R: torch.Tensor, n_rounds: int, tile_fn,
                   consume_of, inplace: bool, extra=None,
                   fixed: bool = False):
    """The rounds of one pass (``n_rounds`` = ``int(R)``; with ``fixed``,
    K rounds whose rows are masked by ``j < R`` too, the reference's
    form), then one wide merge append of ``R·rw`` entries per group.

    Round j ticks exactly the rows ``consume_of(j) | assignable``,
    masked per row, over ``tile_fn(j, consume, core)`` (``core`` is the
    live family state), and writes its fixed-width entries into a
    SKIP-initialized [rows, K·rw] buffer. The rows are all G groups, or
    under a mesh the rank's rows: those mint fresh ids from their
    logical groups' ranges, and the buffer reaches the merge replica
    through ``meshed.append_rounds``. Returns ``(state, dropped,
    extra)``, ``extra`` (int32[rows] or None) gathered to [G] under a
    mesh."""
    rw = cfg.max_entries
    core, dissem = state.core, state.dissem
    rows = _quorum(cfg, core).decided.shape[0]
    dev = state.merge.logs.device
    id_base = None
    if cfg.mesh is not None:
        id_base = meshed_mod.local_id_base(cfg, dev)
    buf = torch.full((rows, cfg.adaptive.max_tiles_per_tick * rw),
                     merge_mod.SKIP, dtype=_I32, device=dev)
    dropped = torch.zeros((rows,), dtype=_I32, device=dev)
    for j in range(n_rounds):
        consume = consume_of(j)                               # bool[rows]
        active = consume | (_assignable(_quorum(cfg, core)) > 0)
        if fixed:
            active = active & (j < R)
        acks, votes, holds = tile_fn(j, consume, core)
        ncore, ndissem, assigned, sids = _family_tick(
            cfg, core, dissem, state.slot_ids, acks, votes, holds,
            id_base=id_base)
        assigned = torch.where(active[:, None], assigned, -1)
        entries, _, drop_g = merge_mod.round_entries(assigned, sids, rw)
        buf[:, j * rw:(j + 1) * rw] = entries
        dropped = dropped + torch.where(active, drop_g, 0)
        core = _select_groups(active, ncore, core, inplace)
        if dissem is not None:
            dissem = _select_groups(active, ndissem, dissem, inplace)
    state = state._replace(core=core, dissem=dissem)
    if cfg.mesh is not None:
        return meshed_mod.append_rounds(cfg, state, buf, R, n_rounds,
                                        dropped, extra)
    counts = (R * rw).to(_I32).expand(cfg.groups)
    ms = merge_mod.append_entries(state.merge, buf, counts)
    return state._replace(merge=ms), dropped.sum(dtype=_I32), extra


def _check_adaptive(cfg, what: str) -> None:
    if cfg.adaptive is None:
        raise ValueError(f"{what}() needs EngineConfig.adaptive set")


def adaptive_pass(cfg, state, queue: TrafficQueue, *,
                  inplace: bool = False,
                  fixed: bool = False) -> tuple[Any, TrafficQueue, dict]:
    """One adaptive merged pass: consume up to K queued tiles per group.

    Reads R to the host once, then runs R masked rounds (R = 0: nothing
    ticks, nothing appends). ``fixed=True`` is the form a CUDA graph
    holds (``engine.graphs``): no host read, K rounds, a round j >= R
    masked off entirely, with the same result bit for bit. Returns
    ``(state, queue, out)`` with ``out["rounds"]`` (R, 0 = engine
    drained), ``out["consumed"]`` int32[G] tiles dequeued and
    ``out["dropped"]`` (merge truncations, 0 whenever ``max_entries ≥
    order_budget``), all on the device.
    ``inplace`` writes the engine state into its own buffers; the
    queue's tiles are never written."""
    _check_adaptive(cfg, "adaptive_pass")
    if fixed and cfg.mesh is not None:
        raise ValueError("adaptive_pass(fixed=True) is the captured "
                         "pass, which the meshed engine does not take")
    if (queue.holds is None) != (cfg.gating is None):
        raise ValueError(
            "queue hold tiles are required exactly when gating is "
            f"configured: family={cfg.family!r}")
    C = queue.acks.shape[1]
    R, k = plan_rounds(cfg, state, queue)
    g = torch.arange(queue.acks.shape[0], device=queue.acks.device)

    def tile_fn(j, consume, core):
        slot = ((queue.head + j) % C).long()

        def take(ring):
            m = consume.view(-1, *(1,) * (ring.dim() - 2))
            return torch.where(m, ring[g, slot], 0)
        return (take(queue.acks), take(queue.votes),
                None if queue.holds is None else take(queue.holds))

    K = cfg.adaptive.max_tiles_per_tick
    state, dropped, consumed = _masked_rounds(
        cfg, state, R, K if fixed else int(R), tile_fn, lambda j: j < k,
        inplace, extra=k, fixed=fixed)
    queue = queue._replace(head=queue.head + k)
    return state, queue, {"rounds": R, "consumed": consumed,
                          "dropped": dropped}


def run_adaptive(cfg, state, queue: TrafficQueue, *, n_passes: int,
                 inplace: bool = False, capture: bool | None = None)\
        -> tuple[Any, TrafficQueue, torch.Tensor, torch.Tensor,
                 torch.Tensor]:
    """Up to ``n_passes`` adaptive passes, then the commit gate: returns
    ``(state, queue, merged, count, committed)``, the adaptive twin of
    ``api.run``. A pass with R = 0 changes nothing, so every later pass
    would too: the eager loop stops at the first. ``n_passes`` only
    needs to be an upper bound. Position-addressed traffic caveat as
    ``api.run``: only position-uniform traffic is id-sound under
    recycling. Raises if any ordered id was truncated out of the merge
    entries.

    ``capture`` (``None``: on a CUDA device, unmeshed): the passes replay
    one captured CUDA graph of the fixed-K pass (``engine.graphs``, a
    loop for this call) with no host read between them, as the
    reference's scan; the R = 0 passes past quiescence are no-ops."""
    eager_only = None if cfg.mesh is None else \
        "under a mesh (the captured meshed pass is not ported)"
    if graphs.resolve_capture(capture, state.merge.logs.device,
                              "run_adaptive", eager_only):
        _check_adaptive(cfg, "run_adaptive")
        (state, queue), loop = graphs.run_functional(
            None, "adaptive", graphs.adaptive_body(cfg), (state, queue),
            steps=n_passes, inplace=inplace, graph=True)
        sharded_mod._assert_no_dropped(loop.dropped)
        from . import api as api_mod   # api imports this module
        return (state, queue) + api_mod.committed_prefix(cfg, state)
    dropped = torch.zeros((), dtype=_I32, device=state.merge.logs.device)
    for _ in range(n_passes):
        state, queue, out = adaptive_pass(cfg, state, queue,
                                          inplace=inplace)
        dropped = dropped + out["dropped"]
        if int(out["rounds"]) == 0:
            break
    sharded_mod._assert_no_dropped(dropped)
    from . import api as api_mod   # api imports this module
    merged, count, committed = api_mod.committed_prefix(cfg, state)
    return state, queue, merged, count, committed


def _readdress(tiles, sids0: torch.Tensor, sids: torch.Tensor):
    """Tiles addressed by the slot map ``sids0`` (int32[G, W]), re-addressed
    to the slot map ``sids``: each slot gets the tile row of its id in
    ``sids0``, and zero where ``sids0`` does not hold its id."""
    W = sids0.shape[1]
    order = sids0.argsort(dim=1)
    ranked = sids0.gather(1, order)
    pos = torch.searchsorted(ranked, sids).clamp(max=W - 1)
    found = ranked.gather(1, pos) == sids
    src = order.gather(1, pos)

    def one(t):
        if t is None:
            return None
        rows = t.gather(1, src[..., None].expand(-1, -1, t.shape[-1]))
        return torch.where(found[..., None], rows, 0)
    return tuple(one(t) for t in tiles)


def subtick_pass(cfg, state, acks: torch.Tensor, votes: torch.Tensor,
                 holds: torch.Tensor | None = None, *,
                 inplace: bool = False) -> tuple[Any, dict]:
    """The queue-less pipeline wiring: one tile set, up to K rounds.

    ``pipeline.closed.pipeline_tick`` rebuilds its tiles from the live
    slot map every tick, so there is nothing to queue: when lag has
    spread across groups, the same tiles are re-absorbed (idempotent OR)
    for up to K−1 extra assignment rounds, so a lagging group's stable
    backlog drains at ``R × order_budget`` ids per pipeline tick while
    caught-up groups pad SKIP rounds. ``"backlog"`` resolves to
    ``"undecided"`` here. Every group ticks round 0, so R ≥ 1 and R = 1
    is the lock-step facade tick, fixed round width aside. Reads R to
    the host once. Returns ``(state, out)`` like ``api.tick``, with
    ``out["rounds"]`` and ``out["dropped"]``.

    The tiles address slots of the slot map at the start of the pass. A
    recycle in an earlier round remaps slots, so each later round
    re-addresses the tiles to the live map: every id gets its own bits,
    and an id the tiles did not cover gets none. The reference
    re-absorbs them by position instead, which hands a surviving slot's
    bits to the fresh ids a recycle refilled it with, so that
    never-admitted ids are ordered (ROADMAP queue 3); the two agree
    bit for bit wherever no round follows a recycle.

    Under a mesh the tiles are logical, every rank passes the same, and
    the pass runs on the rank's rows (:func:`subtick_rows`)."""
    _check_adaptive(cfg, "subtick_pass")
    if cfg.mesh is not None:
        acks, votes, holds = (meshed_mod.local_rows(cfg, x)
                              for x in (acks, votes, holds))
    return subtick_rows(cfg, state, acks, votes, holds, inplace=inplace)


def subtick_rows(cfg, state, acks: torch.Tensor, votes: torch.Tensor,
                 holds: torch.Tensor | None = None, *,
                 inplace: bool = False) -> tuple[Any, dict]:
    """:func:`subtick_pass` over tiles of the state's own rows: all G
    groups, or under a mesh the rank's rows (the closed pipeline builds
    only those). Under a mesh the lag is gathered before R, so every
    rank reads the same R once."""
    _check_adaptive(cfg, "subtick_pass")
    policy = "undecided" if cfg.adaptive.policy == "backlog" \
        else cfg.adaptive.policy
    lag = _state_lag(cfg, state.core, state.dissem, policy)
    if cfg.mesh is not None:
        lag = meshed_mod.gather_rows(cfg, lag)
    R = _rounds_from_spread(cfg.adaptive, lag)
    first = torch.ones((acks.shape[0],), dtype=torch.bool,
                       device=state.merge.logs.device)
    from . import api as api_mod   # api imports this module
    tiles = (acks, votes, holds)
    n_rounds = int(R)
    # the map the tiles address (a copy: an in-place pass rewrites the
    # live one); only recycling remaps slots within a pass
    sids0 = None if n_rounds == 1 or cfg.recycling is None else \
        api_mod.slot_ids(state).clone()

    def consume_of(j):
        return first if j == 0 else ~first

    def tile_fn(j, consume, core):
        if sids0 is None or j == 0:
            return tiles
        return _readdress(tiles, sids0,
                          api_mod.slot_ids(state._replace(core=core)))

    state, dropped, _ = _masked_rounds(cfg, state, R, n_rounds, tile_fn,
                                       consume_of, inplace)
    return state, {"rounds": R, "dropped": dropped}
