#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage, from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (set-up);
2. kernel phase: each kernel against its plain PyTorch version on the
   card, bit-exact, at the engine's shapes, the edge shapes of the
   reference kernel tests, random words with bit 31 set, and in place;
3. engine phase: the repo's documented deployment (G=4 ordering groups
   x W=2048 slots, 1000 disseminators in partitions of 250, 16
   sequencers, order budget 64, recycling watermark 1024, id stride
   2**22) in the gated-recycled family, driven through ``Engine.tick``
   and ``Engine.run`` for >= 6 window generations of seeded traffic; the
   merged log, its sha256, count and committed length must equal the
   same run on the CPU, and the kernel launch counts must be exactly 2T
   (quorum) and T (stability). The plain, recycled and gated families
   run once each at the same width, also against the CPU;
4. timing with CUDA events: each kernel at the engine's shapes beside its
   bound and its plain version (plus each one's device time from
   ``torch.profiler``), and the engine's ticks/s and ids/s;
5. a ``torch.profiler`` pass over 32 host-driven ticks of the main path:
   kernels per tick, device time per tick, device busy share, and the
   heaviest kernels and PyTorch ops.

The next-to-last line is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# the deployment of README.md's sharded-engine example and the sustained
# engine bench: 8192 ids in flight over 4 groups
G, W, N_DISS, PART, N_SEQ, BUDGET = 4, 2048, 1000, 250, 16, 64
WATERMARK, STRIDE = 1024, 1 << 22
T_MAIN = 288          # 9 windows at the order budget: >= 6 generations
T_FAMILY = 48         # plain/recycled/gated families, once each
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor 32-bit rate
WARMUP, REPS = 20, 200


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(**kv) -> None:
    print(json.dumps(kv), flush=True)


# -- traffic ------------------------------------------------------------------

def sparse_words(rng, shape, n_and: int, n_bits: int) -> np.ndarray:
    """Random uint32 words with bit density 2**-n_and, bits past
    ``n_bits`` in the last word cleared (they hold no node)."""
    w = rng.integers(0, 2**32, shape, dtype=np.uint32)
    for _ in range(n_and - 1):
        w &= rng.integers(0, 2**32, shape, dtype=np.uint32)
    tail = n_bits - 32 * (shape[-1] - 1)
    if tail < 32:
        w[..., -1] &= np.uint32((1 << tail) - 1)
    return w


def make_traffic(ticks: int, seed: int):
    """Seeded per-tick tiles: acks at density 1/8 (an id reaches the 501
    ack majority after ~6 ticks), holds at 1/4 (126 of 250 after ~3
    ticks, ahead of the acks), votes at 0.4 per sequencer."""
    rng = np.random.default_rng(seed)
    acks = np.empty((ticks, G, W, (N_DISS + 31) // 32), np.uint32)
    holds = np.empty((ticks, G, W, (PART + 31) // 32), np.uint32)
    votes = np.empty((ticks, G, W, 1), np.uint32)
    weights = (np.uint32(1) << np.arange(N_SEQ, dtype=np.uint32))
    for t in range(ticks):
        acks[t] = sparse_words(rng, acks.shape[1:], 3, N_DISS)
        holds[t] = sparse_words(rng, holds.shape[1:], 2, PART)
        v = rng.random((G, W, N_SEQ)) < 0.4
        votes[t, ..., 0] = (v * weights).sum(-1, dtype=np.uint32)
    return acks, votes, holds


# -- phases -------------------------------------------------------------------

def build_kernels() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(["quorum.cu", "dissem.cu"])
    seconds = time.perf_counter() - t0
    for source, text in logs.items():
        ptxas = [ln.strip() for ln in text.splitlines() if "ptxas" in ln]
        log(build=source, ptxas=ptxas)
    log(phase="build", seconds=seconds)
    return seconds


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over all outputs; bitsets compared as
    their uint32 values."""
    err = 0
    for g, w in zip(got, want):
        g64, w64 = g.to(torch.int64), w.to(torch.int64)
        if g.dtype == torch.int32 and g.dim() == 3:
            g64, w64 = g64 & 0xFFFFFFFF, w64 & 0xFFFFFFFF
        err = max(err, int((g64 - w64).abs().max()) if g.numel() else 0)
    return err


def kernel_phase(dev) -> dict:
    """Every kernel against its plain version on the card; returns the
    worst error per kernel (0 = bit-exact)."""
    from repro_torch.kernels import dissem as kd
    from repro_torch.kernels import quorum as kq
    rng = np.random.default_rng(SEED + 1)
    # (G, W, n): the engine's ack, vote and hold tiles, then the edge
    # shapes of tests/test_kernels.py (odd windows, word boundaries, D=1)
    shapes = [(G, W, N_DISS), (G, W, N_SEQ), (G, W, PART), (2, 12, 32),
              (3, 20, 33), (1, 7, 31), (2, 36, 65), (4, 10, 1), (2, 24, 64)]
    worst = {"quorum_update_grouped": 0, "stability_update_grouped": 0}
    cases = 0
    for (g, w, n) in shapes:
        words = (n + 31) // 32
        for n_and in (1, 3):          # dense random words (bit 31 set
            #                           often) and sparse ones
            bits = torch.from_numpy(sparse_words(rng, (g, w, words), n_and,
                                                 32 * words).view(np.int32))
            upd = torch.from_numpy(sparse_words(rng, (g, w, words), n_and,
                                                32 * words).view(np.int32))
            stable = torch.from_numpy(rng.random((g, w)) < 0.3)
            bits, upd, stable = bits.to(dev), upd.to(dev), stable.to(dev)
            maj = n // 2 + 1
            for name, fn, plain in (
                    ("quorum_update_grouped", kq.quorum_update_grouped,
                     kq.quorum_update_grouped_plain),
                    ("stability_update_grouped",
                     kd.stability_update_grouped,
                     kd.stability_update_grouped_plain)):
                want = plain(bits, upd, stable, majority=maj)
                got = fn(bits, upd, stable, majority=maj)
                buf = bits.clone()
                got_in = fn(buf, upd, stable, majority=maj, inplace=True)
                check(got_in[0].data_ptr() == buf.data_ptr(),
                      f"{name}: in-place output is not the input buffer")
                torch.cuda.synchronize()
                err = max(max_abs_err(got, want), max_abs_err(got_in, want))
                worst[name] = max(worst[name], err)
                check(err == 0, f"{name} differs from its plain version "
                      f"at {(g, w, n)}: max abs err {err}")
                cases += 1
            if g == 1:                 # the single-group form (G=1 launch)
                got = kq.quorum_update(bits[0], upd[0], stable[0],
                                       majority=maj)
                want = kq.quorum_update_grouped_plain(bits, upd, stable,
                                                      majority=maj)
                check(max_abs_err([x[None] for x in got], want) == 0,
                      "quorum_update (G=1) differs from its plain version")
    log(phase="kernels", cases=cases, max_abs_err=worst)
    return worst


def engine_config(family: str):
    from repro_torch.engine.api import (EngineConfig, GatingConfig,
                                        RecyclingConfig)
    recycled = family in ("recycled", "gated_recycled")
    gated = family in ("gated", "gated_recycled")
    ticks = T_MAIN if family == "gated_recycled" else T_FAMILY
    return EngineConfig(
        groups=G, window=W, n_diss=N_DISS, n_seq=N_SEQ,
        order_budget=BUDGET, merge_capacity=ticks * BUDGET,
        recycling=RecyclingConfig(watermark=WATERMARK, id_stride=STRIDE)
        if recycled else None,
        gating=GatingConfig(n_diss_partition=PART, fresh_stable=False)
        if gated else None)


def reset_counts() -> None:
    from repro_torch.kernels import dissem as kd
    from repro_torch.kernels import quorum as kq
    kq.KERNEL.launches = 0
    kd.KERNEL.launches = 0


def read_counts() -> tuple[int, int]:
    from repro_torch.kernels import dissem as kd
    from repro_torch.kernels import quorum as kq
    return kq.KERNEL.launches, kd.KERNEL.launches


def digest(merged, count) -> tuple[str, int]:
    head = merged[:int(count)].to("cpu").numpy().astype("<i4")
    return hashlib.sha256(head.tobytes()).hexdigest(), int(count)


def states_equal(a, b) -> bool:
    from repro_torch.convert import engine_state_to_numpy

    def eq(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        if x is None or y is None:
            return x is y
        return x.dtype == y.dtype and np.array_equal(x, y)
    return eq(engine_state_to_numpy(a), engine_state_to_numpy(b))


def run_family(family: str, tiles_cpu, tiles_dev, dev, *, host_ticks: bool):
    """One family through ``Engine.run`` on the card, the same run on the
    CPU, and (``host_ticks``) ``Engine.tick`` on the card. Returns the
    results and the card run's wall time and launch counts."""
    from repro_torch.engine.api import Engine
    cfg = engine_config(family)
    gated = cfg.gating is not None
    ticks = T_MAIN if family == "gated_recycled" else T_FAMILY
    cpu_in = [x[:ticks] for x in tiles_cpu]
    dev_in = [x[:ticks] for x in tiles_dev]
    if not gated:
        cpu_in, dev_in = cpu_in[:2], dev_in[:2]

    t0 = time.perf_counter()
    ref = Engine.create(cfg, device="cpu")
    ref_out = ref.run(*cpu_in)
    cpu_s = time.perf_counter() - t0
    want = digest(ref_out[0], ref_out[1]) + (int(ref_out[2]),)

    results = {}
    runs = [("run", lambda e: e.run(*dev_in))]
    if host_ticks:
        def by_tick(e):
            for t in range(ticks):
                e.tick(*(x[t] for x in dev_in))
            return e.committed()
        runs.append(("tick", by_tick))
    for how, drive in runs:
        eng = Engine.create(cfg, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = drive(eng)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        got = digest(out[0], out[1]) + (int(out[2]),)
        check(got == want, f"{family}/{how}: card {got} != CPU {want}")
        check(states_equal(eng.state, ref.state),
              f"{family}/{how}: final state differs from the CPU run")
        check(launches == (2 * ticks, ticks if gated else 0),
              f"{family}/{how}: launches {launches}, expected "
              f"{(2 * ticks, ticks if gated else 0)}")
        overflow = int(eng.state.merge.overflowed.sum())
        check(got[2] > 0 and overflow == 0,
              f"{family}/{how}: committed {got[2]}, overflowed {overflow}")
        results[how] = dict(seconds=seconds, launches=launches, engine=eng)
    log(phase=f"engine/{family}", ticks=ticks, sha256=want[0],
        count=want[1], committed=want[2], cpu_seconds=cpu_s,
        **{f"{how}_first_seconds": r["seconds"]
           for how, r in results.items()})
    return want, results


def time_cuda(fn, reps=REPS, warmup=WARMUP) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_bound(g, w, words, stability: bool) -> dict:
    """Least time for one call: each input read once, each output written
    once (bits, update, stable in; bits, counts, stable, newly out), and
    ~3 integer operations per word (OR, popcount, add)."""
    n = g * w * words
    nbytes = 4 * n * 3 + g * w * (1 + 4 + 1) + (4 * g if stability else 0)
    ops = 3 * n + 2 * g * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_kernels(dev, tiles_dev) -> list[dict]:
    """Kernel and plain-version time at the engine's shapes, in place as
    the engine calls them (inputs stay in the 50 MB L2 between calls)."""
    from repro_torch.kernels import dissem as kd
    from repro_torch.kernels import quorum as kq
    acks, votes, holds = (x[0] for x in tiles_dev)
    rows = []
    for name, fn, plain, upd, n in (
            ("quorum_update_grouped", kq.quorum_update_grouped,
             kq.quorum_update_grouped_plain, acks, N_DISS),
            ("quorum_update_grouped", kq.quorum_update_grouped,
             kq.quorum_update_grouped_plain, votes, N_SEQ),
            ("stability_update_grouped", kd.stability_update_grouped,
             kd.stability_update_grouped_plain, holds, PART)):
        g, w, words = upd.shape
        bits = torch.zeros_like(upd)
        stable = torch.zeros((g, w), dtype=torch.bool, device=dev)
        maj = n // 2 + 1
        ms = time_cuda(lambda: fn(bits, upd, stable, majority=maj,
                                  inplace=True))
        plain_ms = time_cuda(lambda: plain(bits, upd, stable, majority=maj,
                                           inplace=True))
        # the kernel's own device time, without the host launch path
        symbol = "quorum_kernel" if "quorum" in name else "stability_kernel"
        found = [us for k, us in device_kernels(
            lambda: fn(bits, upd, stable, majority=maj, inplace=True), 50)
            if symbol in k]
        check(len(found) == 50, f"{name}: profiler saw {len(found)} of 50 "
              "kernel launches")
        plain_dev = sum(us for _, us in device_kernels(
            lambda: plain(bits, upd, stable, majority=maj, inplace=True),
            50)) / 50
        rows.append(dict(name=name, shape=[g, w, words], ms=ms,
                         plain_ms=plain_ms, device_ms=sum(found) / 50e3,
                         plain_device_ms=plain_dev / 1e3,
                         **kernel_bound(g, w, words, "stability" in name)))
        log(phase="timing/kernel", **rows[-1])
    return rows


def time_engine(tiles_dev, dev) -> dict:
    """Steady-state rate of the main path: a fused ``Engine.run`` of
    T_MAIN ticks after one warm-up run, timed by CUDA events and the host
    clock; plus the host-driven tick loop."""
    from repro_torch.engine.api import Engine
    cfg = engine_config("gated_recycled")
    Engine.create(cfg, device=dev).run(*tiles_dev)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine.create(cfg, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    merged, count, committed = eng.run(*tiles_dev)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_s = start.elapsed_time(end) / 1e3
    eng2 = Engine.create(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(T_MAIN):
        eng2.tick(*(x[t] for x in tiles_dev))
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    retired = eng.state.core.rs.retired
    res = dict(ticks=T_MAIN, committed=int(committed), run_seconds=run_s,
               run_wall_seconds=wall, ticks_per_s=T_MAIN / run_s,
               committed_ids_per_s=int(committed) / run_s,
               tick_loop_seconds=tick_s,
               tick_loop_ticks_per_s=T_MAIN / tick_s,
               generations_min=int(retired.min()) / W,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    log(phase="timing/engine", **res)
    return res


def device_kernels(fn, calls: int):
    """CUDA kernel events of ``calls`` calls of ``fn`` under
    ``torch.profiler``: list of (name, microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def profile_ticks(tiles_dev, dev, ticks: int = 32) -> dict:
    """Device time per tick of host-driven ticks of the main path under
    ``torch.profiler`` (after 8 warm-up ticks): kernels launched, their
    summed time, the share of the tick's wall time, the heaviest kernels
    and the heaviest PyTorch ops by the device time of the kernels they
    launch. The profiler's overhead inflates the wall time, so the busy
    share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.api import Engine
    eng = Engine.create(engine_config("gated_recycled"), device=dev)
    for t in range(8):
        eng.tick(*(x[t] for x in tiles_dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(8, 8 + ticks):
            eng.tick(*(x[t] for x in tiles_dev))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = kernels.get(e.name[:90], (0, 0.0))
            kernels[e.name[:90]] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in kernels.values())

    def self_dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and self_dev(e) > 0),
                 key=self_dev, reverse=True)[:12]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    res = dict(ticks=ticks, wall_us_per_tick=wall_us / ticks,
               kernels_per_tick=sum(n for n, _ in kernels.values()) / ticks,
               device_us_per_tick=busy_us / ticks,
               device_busy_share=busy_us / wall_us,
               top_kernels=[dict(kernel=k, us_per_tick=us / ticks,
                                 calls_per_tick=n / ticks)
                            for k, (n, us) in top],
               top_ops=[dict(op=e.key, us_per_tick=self_dev(e) / ticks,
                             calls_per_tick=e.count / ticks) for e in ops])
    log(phase="profile/tick", **res)
    return res


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    log(torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))

    build_kernels()
    errors = kernel_phase(dev)

    t0 = time.perf_counter()
    tiles_np = make_traffic(T_MAIN, SEED)
    tiles_cpu = [torch.from_numpy(x.view(np.int32)) for x in tiles_np]
    tiles_dev = [x.to(dev) for x in tiles_cpu]
    log(phase="traffic", seconds=time.perf_counter() - t0,
        bytes=sum(x.nbytes for x in tiles_np))

    # the main path: counts are reset right before each drive of it
    _, main = run_family("gated_recycled", tiles_cpu, tiles_dev, dev,
                         host_ticks=True)
    main_launches = main["run"]["launches"]
    retired = main["run"]["engine"].state.core.rs.retired
    check(int(retired.min()) >= 6 * W,
          f"only {int(retired.min()) / W:.2f} window generations retired")
    for family in ("plain", "recycled", "gated"):
        run_family(family, tiles_cpu, tiles_dev, dev, host_ticks=False)

    timings = time_kernels(dev, tiles_dev)
    engine = time_engine(tiles_dev, dev)
    profile_ticks(tiles_dev, dev)

    by_name = {}
    for row in timings:                  # first row per kernel: main shape
        by_name.setdefault(row["name"], row)
    kernels = []
    for name, src, replaces, launches in (
            ("quorum_update_grouped", "src/repro_torch/kernels/csrc/quorum.cu",
             "src/repro/kernels/quorum.py:108", main_launches[0]),
            ("stability_update_grouped",
             "src/repro_torch/kernels/csrc/dissem.cu",
             "src/repro/kernels/dissem.py:63", main_launches[1])):
        row = by_name[name]
        check(launches > 0, f"{name} was not launched on the main path")
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=launches, max_abs_err=errors[name],
                     ms=row["ms"], plain_ms=row["plain_ms"],
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=None, parity="bit-exact",
                     device_ms=row["device_ms"],
                     shapes=[dict(shape=r["shape"], ms=r["ms"],
                                  plain_ms=r["plain_ms"],
                                  device_ms=r["device_ms"],
                                  bound_ms=r["bound_ms"], bytes=r["bytes"])
                             for r in timings if r["name"] == name])
        if name == "quorum_update_grouped":
            entry["also_replaces"] = "src/repro/kernels/quorum.py:72"
        kernels.append(entry)
    log(engine={k: engine[k] for k in ("ticks_per_s", "committed_ids_per_s",
                                       "tick_loop_ticks_per_s",
                                       "generations_min")})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
