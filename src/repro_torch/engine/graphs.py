"""One captured CUDA graph per engine run, pipeline run and adaptive pass.

The reference runs a whole engine run as one jitted ``lax.scan``
(``engine/sharded.py``, ``pipeline/closed.py``) and an adaptive pass as a
fixed-K ``fori_loop`` (``engine/adaptive.py``). The port's counterpart:
the step body (one merge-appended engine tick, one pipeline tick, one
adaptive pass) is captured once as a ``torch.cuda.CUDAGraph`` and
replayed, so a step costs the host one graph launch instead of a few
hundred kernel launches. The hand-written quorum and stability kernels
run inside the graph: their launchers take the current raw stream, which
during the capture is the capture stream, and allocate nothing.

A :class:`CapturedLoop` owns:

* **static state buffers**, one per leaf of the step's state tree: a
  step reads them and writes its new state back into them (``copy_``,
  or in place where a kernel or a masked select already wrote there);
* **static per-step inputs**: one step's tiles, copied in before each
  replay, and inputs that hold for the whole run (the pipeline's route
  table), copied in once per run;
* **a device step counter**, **a static int32 accumulator of
  ``dropped``** and the per-step summaries (int32, one entry a step,
  written at the counter's index), all updated inside the graph.

Nothing in a step reads a value back to the host. The one host read of a
run is the no-drop check (``sharded._assert_no_dropped``), once after the
replays, as the reference's ``jax.debug.callback``; the commit gate runs
once after the replays, eagerly.

A loop is built with ``graph=False`` on the CPU, where CUDA graphs do
not exist: each step then runs the same body on the same static buffers
eagerly. That is the CPU's (and ``capture=False``'s) lock-step engine
run and pipeline run, so one loop serves both. There is no fallback: a
capture or replay that fails raises.

Whoever calls keeps the loops: the ``Engine`` facade in ``Engine._loops``
(:func:`engine_run`, :func:`engine_adaptive`; the buffers are the
engine's own state), a functional caller in a dict it passes to
:func:`run_functional` (``run_pipeline(loops=...)``), or nobody, and then
the loop lives for one call.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels import dissem as kernels_dissem
from ..kernels import quorum as kernels_quorum

KERNELS = {"quorum_update_grouped": kernels_quorum.KERNEL,
           "stability_update_grouped": kernels_dissem.KERNEL}

_I32 = torch.int32


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a state tree (nested tuples and NamedTuples, None
    leaves skipped), in field order."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return None if tree is None else fn(tree)


def _structure(tree):
    if isinstance(tree, tuple):
        return (type(tree), tuple(_structure(v) for v in tree))
    return None if tree is None else (tuple(tree.shape), tree.dtype)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def write_back(dst: list[torch.Tensor], src: list[torch.Tensor]) -> None:
    """``d.copy_(s)`` for every pair that is not one buffer already. A
    source that still reads one of the destinations' storages is cloned
    first, so that no copy reads a buffer an earlier copy wrote."""
    if len(dst) != len(src):
        raise ValueError(f"state trees differ: {len(dst)} leaves against "
                         f"{len(src)}")
    pairs = []
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"a step changed a state leaf from "
                             f"{tuple(d.shape)} {d.dtype} to "
                             f"{tuple(s.shape)} {s.dtype}")
        if not _same(d, s):
            pairs.append((d, s))
    held = {d.untyped_storage().data_ptr() for d in dst}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in held
              else s) for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


def launch_counts() -> dict[str, int]:
    return {k: v.launches for k, v in KERNELS.items()}


class CapturedLoop:
    """A step body over static buffers, captured once as a CUDA graph.

    ``body(state, tiles, consts) -> (state', out)``: one step on the
    state tree, this step's ``tiles`` and the run's ``consts``; ``out``
    holds ``"dropped"`` (an int32 scalar) and the summaries named in
    ``series``. ``state`` is the tree of static buffers: the loop writes
    every step's new state into these tensors. ``tiles`` and ``consts``
    give the shapes and dtypes of one step's inputs and of the run's.
    ``length`` (the most steps a run takes) sizes ``series``. ``keep``
    names outputs whose last value stays readable in :attr:`last` after
    a step. ``graph=True`` captures (CUDA only); ``graph=False`` runs
    the body eagerly on the same buffers."""

    def __init__(self, body: Callable, state, tiles=(), consts=(), *,
                 graph: bool, length: int | None = None, series=(),
                 keep=()) -> None:
        if series and length is None:
            raise ValueError("series need the run length")
        ptrs = [x.untyped_storage().data_ptr() for x in leaves(state)
                if x.numel()]
        if len(set(ptrs)) < len(ptrs):
            seen = set()

            def own(x):      # a leaf sharing another's storage is copied
                ptr = x.untyped_storage().data_ptr()
                if x.numel() and ptr in seen:
                    return x.clone()
                seen.add(ptr)
                return x
            state = tree_map(own, state)
        self.body, self.state, self.length = body, state, length
        self._leaves = leaves(state)
        dev = self._leaves[0].device
        if graph and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, the state "
                             f"is on {dev}")

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.tiles = [zeros(tuple(x.shape), x.dtype) for x in tiles]
        self.consts = [zeros(tuple(x.shape), x.dtype) for x in consts]
        self.counter = zeros((1,), torch.int64)
        self.dropped = zeros((), _I32)
        self.series = {k: zeros((length,), _I32) for k in series}
        self.keep = tuple(keep)
        self.last: dict[str, torch.Tensor] = {}
        self.recorded: dict[str, int] = {}
        self.replays = 0
        self.graph = None
        if graph:
            self._capture()

    # -- the step ------------------------------------------------------------

    def _record(self) -> None:
        """One step on the static buffers: what the graph holds."""
        new, out = self.body(self.state, self.tiles, self.consts)
        write_back(self._leaves, leaves(new))
        self.dropped.add_(out["dropped"])
        for k, buf in self.series.items():
            buf.index_copy_(0, self.counter, out[k].reshape(1).to(_I32))
        self.last = {k: out[k] for k in self.keep}
        self.counter.add_(1)

    def _capture(self) -> None:
        """Warm up once on clones, on a side stream (loads the kernel
        libraries and fills the per-config caches without touching the
        live state), then capture one step."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            scratch = tree_map(torch.clone, self.state)
            self.body(scratch, [x.clone() for x in self.tiles],
                      [x.clone() for x in self.consts])
        main.wait_stream(side)
        del scratch
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._record()
        after = launch_counts()
        self.recorded = {k: after[k] - before[k] for k in after}

    def step(self) -> None:
        """One step: a replay, or the body run eagerly."""
        if self.graph is None:
            self._record()
        else:
            self.graph.replay()
        self.replays += 1

    # -- a run ----------------------------------------------------------------

    def load(self, state) -> None:
        """Copy each leaf of ``state`` that is not already the static
        buffer into it: a state changed outside the loop (an eager tick,
        a recycle, a reconfigure) is what the next step sees."""
        if _structure(state) != _structure(self.state):
            raise ValueError("the state's shapes differ from the captured "
                             "loop's")
        write_back(self._leaves, leaves(state))

    def begin(self, consts=()) -> None:
        """Start a run: zero the counter and ``dropped``, copy in the
        run's inputs."""
        self.counter.zero_()
        self.dropped.zero_()
        for buf, x in zip(self.consts, consts):
            buf.copy_(x)

    def run(self, seqs=(), consts=(), steps: int | None = None) -> None:
        """``steps`` steps (default: the sequences' length) over the
        [T, ...] tile sequences ``seqs``, each step's row copied into the
        static tiles before it."""
        seqs = [x for x in seqs if x is not None]
        if steps is None:
            steps = seqs[0].shape[0]
        if len(seqs) != len(self.tiles):
            raise ValueError(f"{len(seqs)} tile sequences for a loop of "
                             f"{len(self.tiles)}")
        for buf, x in zip(self.tiles, seqs):
            want = (steps,) + tuple(buf.shape)
            if tuple(x.shape) != want or x.dtype != buf.dtype:
                raise ValueError(f"tile sequence {tuple(x.shape)} "
                                 f"{x.dtype}, the loop takes {want} "
                                 f"{buf.dtype}")
        if self.series and steps > self.length:
            raise ValueError(f"a run of {steps} steps on a loop of "
                             f"{self.length}")
        self.begin(consts)
        for t in range(steps):
            for buf, x in zip(self.tiles, seqs):
                buf.copy_(x[t])
            self.step()


def _row(x: torch.Tensor) -> torch.Tensor:
    """A [T, ...] sequence's one-step template (shape and dtype; T may
    be 0)."""
    return x.new_empty(tuple(x.shape[1:]))


def _kept(loops: dict, key, make: Callable) -> CapturedLoop:
    """The loop kept in ``loops`` under ``key``, built by ``make()`` at
    first use."""
    loop = loops.get(key)
    if loop is None:
        loop = loops[key] = make()
    return loop


# -- the Engine facade's loops ------------------------------------------------

def engine_body(cfg):
    """One merge-appended engine step of any family (``api.tick``: the
    family's tick body), in place: the body of an engine run's loop."""
    from . import api

    def body(state, tiles, consts):
        return api.tick(cfg, state, *tiles, inplace=True)
    return body


def adaptive_body(cfg):
    """One fixed-K adaptive pass over ``(state, queue)``, in place: the
    body of a captured adaptive pass."""
    from . import adaptive

    def body(tree, tiles, consts):
        state, queue = tree
        state, queue, out = adaptive.adaptive_pass(
            cfg, state, queue, inplace=True, fixed=True)
        return (state, queue), out
    return body


def engine_run(eng, acks_seq, votes_seq, holds_seq=None):
    """``Engine.run`` of an unmeshed engine: :func:`engine_body` stepped
    T times over the engine's own state (replays of one CUDA graph when
    ``eng.capture``, the body run eagerly otherwise), then the no-drop
    check and the commit gate. The loop is kept in ``eng._loops`` by
    tile shapes, and the engine's current state is loaded into it first
    (what ``tick``, ``recycle`` or ``reconfigure`` changed). Returns
    ``(merged, merged_count, committed_count)``."""
    from . import api
    from . import sharded
    cfg = eng.cfg
    api._need_holds(cfg, holds_seq)
    seqs = [x for x in (acks_seq, votes_seq, holds_seq) if x is not None]
    key = ("run", tuple((tuple(x.shape[1:]), x.dtype) for x in seqs))
    loop = _kept(eng._loops, key, lambda: CapturedLoop(
        engine_body(cfg), eng.state, [_row(x) for x in seqs],
        graph=eng.capture))
    loop.load(eng.state)
    eng.state = loop.state
    loop.run(seqs)
    sharded._assert_no_dropped(loop.dropped)
    return api.committed_prefix(cfg, eng.state)


def engine_adaptive(eng, passes: int | None = None):
    """The fixed-K adaptive pass over the engine's state and queue, the
    reference's form (:func:`adaptive_body`): captured when
    ``eng.capture``, else run eagerly (the loop's CPU form; the eager
    facade runs the R-round pass instead). ``passes=None``: one pass,
    returning ``rounds``/``consumed``/``dropped`` (copies, so the next
    replay leaves them alone). Else ``passes`` passes with no host read
    between them, then the no-drop check and the commit gate:
    ``(merged, merged_count, committed_count)``, as ``run_adaptive``."""
    from . import api
    from . import sharded
    queue = eng._queue("adaptive_pass")
    key = ("adaptive", _structure(queue))   # a queue per capacity
    loop = _kept(eng._loops, key, lambda: CapturedLoop(
        adaptive_body(eng.cfg), (eng.state, queue), graph=eng.capture,
        keep=("rounds", "consumed", "dropped")))
    loop.load((eng.state, queue))
    eng.state, eng.queue = loop.state
    loop.begin()
    for _ in range(1 if passes is None else passes):
        loop.step()
    if passes is None:
        return {k: v.clone() for k, v in loop.last.items()}
    sharded._assert_no_dropped(loop.dropped)
    return api.committed_prefix(eng.cfg, eng.state)


# -- the functional entry points ----------------------------------------------

def run_functional(loops: dict | None, key, body: Callable, state, seqs=(),
                   consts=(), *, steps: int | None = None, inplace: bool,
                   graph: bool, series=()):
    """A functional run (``run_pipeline``, ``adaptive.run_adaptive``)
    through a loop: ``steps`` steps (default: the sequences' length).

    ``loops``: the caller's dict, in which the loop is kept by ``key``
    and the shapes of the state and the inputs (a later run with the
    same shapes and no more steps replays it; a longer one builds a new
    loop in its place); ``None``: a loop for this call alone. The loop's
    buffers are the state's own tensors when ``inplace`` (a kept loop's:
    its first run's), else copies; the caller's state is loaded into
    them before the run. Returns ``(state, loop)``: the buffers (copied
    out of a kept loop when not ``inplace``), and the loop, whose
    ``dropped`` and ``series[:steps]`` hold the run's accumulator and
    summaries until its next run."""
    seqs = [x for x in seqs if x is not None]
    steps = seqs[0].shape[0] if steps is None else steps
    full = (key, graph, _structure(state),
            tuple((tuple(x.shape[1:]), x.dtype) for x in seqs),
            tuple((tuple(x.shape), x.dtype) for x in consts), tuple(series))

    def make():
        buffers = state if inplace else tree_map(
            lambda x: x.clone(memory_format=torch.contiguous_format), state)
        return CapturedLoop(body, buffers, [_row(x) for x in seqs], consts,
                            graph=graph, length=steps, series=series)
    loop = None if loops is None else loops.get(full)
    if loop is None or (series and loop.length < steps):
        loop = make()
        if loops is not None:
            loops[full] = loop
    else:
        loop.load(state)           # a kept loop: the caller's state in
    loop.run(seqs, consts, steps=steps)
    if inplace or loops is None:
        return loop.state, loop
    return tree_map(torch.clone, loop.state), loop


def resolve_capture(capture: bool | None, device: torch.device,
                    what: str, eager_only: str | None = None) -> bool:
    """``None`` → captured on a CUDA device, eager elsewhere and on
    paths that stay eager (``eager_only`` names why); ``True`` raises
    where it cannot capture."""
    if capture is None:
        return device.type == "cuda" and eager_only is None
    if capture:
        if eager_only is not None:
            raise ValueError(f"{what}: capture=True is not available "
                             f"{eager_only}")
        if device.type != "cuda":
            raise ValueError(f"{what}: capture=True needs a CUDA device "
                             f"(CUDA graphs do not exist on {device})")
    return bool(capture)
