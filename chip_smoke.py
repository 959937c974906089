#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage, from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (set-up),
   log each one's registers and spills (no flash instantiation may
   spill), check in the SASS of the bf16
   flash libraries (forward and backward) that the tensor cores do their
   work (HMMA) and in the f32 ones' (forward and backward) that they do
   none (no HMMA), and log blocks per SM and shared memory per block of
   each flash and WKV6 instantiation and the registers, spills, shared
   memory and blocks per SM of the WKV6 backward's four CUDA kernels;
2. kernel phase: each kernel against its plain PyTorch version on the
   card, bit-exact, at the engine's shapes, the edge shapes of the
   reference kernel tests, the shapes where the lane mapping switches
   (2, 3, 4, 5, 9, 33 and 64 words, W = 1, W = 129, W = 0, G = 9
   clusters), random words with bit 31 set, with bitsets aligned and
   misaligned (a storage offset of one int32), in and out of place;
3. engine phase: the repo's documented deployment (G=4 ordering groups
   x W=2048 slots, 1000 disseminators in partitions of 250, 16
   sequencers, order budget 64, recycling watermark 1024, id stride
   2**22) in the gated-recycled family, driven through ``Engine.run``
   (captured, the default on the card: one CUDA graph of the tick
   replayed T times), ``Engine.run`` eager and ``Engine.tick`` for >= 6
   window generations of seeded traffic; the merged log, its sha256,
   count, committed length and the whole state must equal the same run
   on the CPU, and the kernel launches must be exactly 2T (quorum) and T
   (stability): eagerly as the wrappers' counts; captured as the
   launches the capture recorded times the replays, as device kernel
   events in a ``torch.profiler`` trace of the captured run itself (the
   main path, counts reset just before it: the capture's warm-up step
   and T replays, 2(T + 1) and T + 1, the launches the ``kernels`` line
   reports), and in a trace of a second captured run (which replays the
   same graph with no host launch: 2T and T). The plain,
   recycled and gated families run the same way at the same width;
   then each engine kernel captured alone in a graph and replayed equals
   its eager call (``newly``, the cluster-reduced count, included);
4. timing with CUDA events: each kernel at the engine's shapes beside its
   bound and its plain version (plus each one's device time from
   ``torch.profiler``, where every device op of a call must be the
   kernel, one per call: no fill, no memset; its floor, the device time at
   a [1, 1, 1] tile; and the host's cost to enqueue a call, of the wrapper
   and of a bare ``ctypes`` launch), ``quorum_update`` at its test shape
   and a main-path-sized tile, and the engine's ticks/s and ids/s eager
   (E) against captured (G) in turns E, G, G, E, with the host µs a
   replay takes, alone and with the step's tile copies;
5. a ``torch.profiler`` pass over 32 host-driven ticks of the main path:
   kernels per tick, device time per tick, device busy share, and the
   heaviest kernels and PyTorch ops; then ``dense_ticks``: the bool-tile
   entry points ``engine.sharded.sharded_tick_dense`` and
   ``dissem.engine.stability_tick_dense`` at the engine cell's G, W and
   ack, vote and hold widths over seeded bool tiles, on the card and on
   the CPU: state and outputs equal bit for bit, exactly 2 quorum and 1
   stability launches a call; and ``dryrun``: the port's dry run
   (``launch.dryrun``) over every arch x shape cell x both production
   meshes on the meta device, no error record, each skipped record one
   that ``cell_applicable`` explains, each arch's largest argument bytes
   per device;
6. pipeline phase: the closed pipeline (``repro_torch.pipeline``) at the
   same engine deployment with 8,000 clients (8 per lane), 1024-byte
   requests, a byte budget of one lane-tick (8,292 B), seeded per-node
   lags and arrivals at 0.045 per client-tick (~1.2x the ordering
   budget): 288 ticks at epoch 0, a drain, a flip from 4 rows to 3
   (``reconfigure_pipeline``), 96 ticks, a drain. The card's run equals
   the CPU's (merged log sha256, count, committed length, the whole
   state); the admission records equal the host twin
   (``plan_admissions``); nothing overflowed or was dropped; each lane's
   flushed bytes equal its batches' ``batch_bytes``; every admitted bid
   is decoded exactly once; the flip moved nothing, sealed row 3 and
   kept the committed prefix; launches are exactly 2 and 1 per tick. The
   drive runs captured (``run_pipeline``'s default on the card: each
   segment replays one captured tick, the drains tick on the host) and
   eager, each equal to the CPU's; captured, the launches recorded x
   replays are 2 and 1 a tick. Then segment A timed eager against
   captured in turns E, G, G, E (pipeline ticks/s, committed batch ids/s
   and requests/s, the ratio to the engine's ticks/s), a profiler pass
   over 32 eager pipeline ticks and one over 32 replays (2 and 1 kernel
   events a tick);
7. adaptive phase: (a) ``adaptive/skew`` and ``adaptive/uniform``: the
   engine's deployment with README's ``AdaptiveConfig(max_tiles_per_tick
   =4, policy="backlog")`` over the engine phase's tiles pre-loaded with
   ``queue_from_arrays`` (skew: group 0 holds 288 tiles, the others 72;
   uniform: 72 each), ``Engine.adaptive_pass`` until R = 0. Each equals
   the same passes on the CPU (merged log, the whole state and queue,
   every R) and a lock-step ``Engine.run`` of ΣR ticks over the same
   tiles on the card (the same merged prefix); nothing dropped; launches
   exactly 2·ΣR and ΣR; the same passes captured (the default on the
   card: the reference's fixed-K pass, one replay a pass, 2K and K
   launches recorded a pass), ``Engine.run_adaptive`` and the functional
   ``run_adaptive`` (no host read between passes) equal too; lock-step
   and adaptive timed eager and captured in turns E, G, G, E, and
   profiler passes over 32 skew passes of R = 4, eager and captured.
   (b) ``pipeline/adaptive``:
   the pipeline phase's drive in the subtick mode (K = 4, policy
   "unstable"): card = CPU; against the lock-step run, the same admitted
   count, all committed, the same bids in the same groups and each
   lane's batches in admission order within a group; the flip sealed row
   3; launches 2·ΣR and ΣR; segment A timed in both modes and a profiler
   pass over 32 subtick ticks. (c)
   ``dissem/bandwidth``: 2,000 batches of 8 x 1024 B over 1000
   disseminators at G = 1, 2, 4, absorbed by one ``stability_tick`` on
   the card: per-node bytes equal the CPU's and the closed form;
   (d) the mesh phase (``EngineConfig(mesh=MeshConfig())``, the engine
   cell's deployment): each world's ranks run as children of this
   script (``--mesh-child``), one process per rank with a deadline.
   NCCL at ``min(cards, 4)`` ranks (rank r on cuda:r): ``Engine.run``
   and 288 x ``Engine.tick``; gloo at 2, 3 and 4 ranks sharing cuda:0
   (at 3, G = 4 pads to 6 rows and rank 2 holds pad rows only):
   ``Engine.run``, and at 2 ranks also adaptive/skew and the pipeline
   cell with its flip. Every rank's merged sha256, count, committed
   length and gathered state equal the unmeshed card and CPU runs of
   this call; every rank launches exactly 2T and T per run (2·ΣR, ΣR
   adaptive; 2 and 1 per pipeline tick) on its card; meshed NCCL
   ticks/s against unmeshed in one process (turns U, M, M, U) and the
   gather's host cost; each gloo rank's ticks/s;
8. model-kernel phase: the flash attention kernels (bf16 on the tensor
   cores, f32 on the CUDA cores; each case must launch the kernel its
   dtype selects) and WKV6 against their plain versions on the card, at
   the serving path's shapes, the shapes of the reference kernel tests,
   sliding-window, non-causal, ragged, G = 8 and hv != h cases (flash;
   in f32 also h, hv not multiples of 4, q/k/v 4 bytes past a 16-byte
   boundary, so that both copy paths run, and a long non-causal case;
   q/k width 192 with v width 128 at deepseek-v3's MLA serving prefill
   and train microbatch, and 176 / 96, the plain version over groups of
   heads where its scores would pass 4 GB),
   and ragged lengths (one token, a chunk +- 1, 128 chunks), head dim
   128 and decay ranges where the reference's chunked form overflows
   (WKV6);
9. serving path (``serve/yi-6b``, ``serve/rwkv6-3b``): each model at full
   width and depth (32 layers), in bf16 (weights from the port's
   initialiser, seed 0), B=4, a 1024-token seeded prompt: ``prefill`` (32
   kernel launches:
   for yi-6b, of the bf16 flash kernel and none of the f32 one; for
   rwkv6-3b, of WKV6, each one call that runs three CUDA kernels), then
   ``launch.serve.generate`` (each ``decode_step`` one captured CUDA
   graph): the prompt teacher-forced (no kernel launch), then 32 greedy
   tokens; all logits finite. Both bf16 paths
   against the f32 forward of the same weights (neither more than 2x
   further from it than the other), and in f32 at the same depth prefill
   vs teacher-forced decode over 160 tokens within 1e-3 with equal greedy
   tokens (the f32 forward traced: its kernel's launches and device time
   per call). Prefill and decode tokens/s, each kernel's device time in
   the prefill, peak memory;
10. ``serve/f32``: both models at full width, 2 layers, f32: prefill with
   the kernels, prefill with the plain versions and the teacher-forced
   decode against each other; the kernel's device time per call;
11. ``serve/cpu``: the smoke configs on one set of weights, on the CPU and
   on the card;
12. model-kernel timing at the serving path's shapes: kernel (and its
   device time; for WKV6 each pass's, and its workspace), plain version
   and (flash, in bf16 and in f32) ``scaled_dot_product_attention``, with
   bounds; the WKV6 backward at the rwkv6-3b train microbatch [1, 4096,
   40, 64] in bf16 (per call, each of its four passes' device time, the
   plain backward, ``wkv_bwd_bound``);
13. flash backward kernel phase: ``flash_attention_bwd`` against its
   plain version on the card (causal and not, windows, Sq != Skv, G = 1
   and 8, h 16 / 64 / 128, hv != h, ragged lengths, the train cell's and
   the serving shape): bf16 through the tensor-core kernel with the LSE
   of ``flash_attention_fwd_lse`` (held against the plain log2-domain
   logsumexp; the forward's output bytes equal with and without the LSE;
   without it the backward raises), f32 through the CUDA-core kernel;
   one launch of the dtype's kernel a call, two launches at the train
   shape byte-equal; registers, spills, shared memory and blocks per SM
   of both kernels' CUDA kernels at every instantiation (the bf16 one's
   four at q/k width 192: D, the dk and dv passes, dq); then the WKV6
   backward kernel (``wkv_bwd_phase``): WKV6's autograd on the card in
   every case of WKV_BWD_CASES (the forward's cases, the train
   microbatch, and lengths that end inside an 8-token leaf and on a
   half's edge), one forward and one backward launch a call, the five
   gradients against ``wkv6_chunked_bwd_plain`` (WKV_BWD_TOL), two
   backward launches byte-equal, and a head dim past 128 or a
   non-contiguous dout raising before any launch;
14. ``train/yi-6b``: full width and depth, bf16, 2 x 4096 tokens a step
   (the reference's train_4k cell with its batch cut to 2), 2
   microbatches, Adafactor, through ``make_train_step`` inside a
   ``TrainerStateMachine`` fed by a two-group ``MergedCommandLog``: 1
   warm-up and 3 timed steps (CUDA events), each with exactly 128 forward
   and 64 bf16 backward flash launches (no f32 one) and a finite loss
   and grad_norm; tokens/s and peak memory; a second pod fed the same
   decisions in another order ends equal leaf for leaf (``torch.equal``
   on the card); one more step traced for each kernel's device time
   (each backward pass's); the dry run's state bytes per device at the
   (1, 1) host mesh equal the bytes of the state on the card;
15. ``train/f32``: yi-6b at 2 layers, full width, f32, one AdamW step on
   the card against the same step on the CPU from one set of weights (2
   f32 backward launches, no bf16 one): loss, grad_norm, every gradient
   leaf, the parameters after;
   ``train/checkpoint``: at the same cut in bf16, a checkpoint saved by
   the CKPT command with one node failed (committed by majority), pods
   fed two interleavings on equal ``tree_digest``s, and a pod restored
   into other weights that replays the rest of the log and ends on the
   same digest; ``train/smr``: the training service whose control plane
   is the port's HT-Paxos DES (``runtime.coordinator.TrainingService``,
   2 pods, 3 disseminators, 3 sequencers) with pods training qwen3-14b
   at full width, 2 of its 40 layers, bf16, Adafactor, 2 x 1024 tokens a
   step: one fixed batch as 6 STEP commands with CKPT(3) after the
   third, pod1 crashed after step 3, the ordering leader crashed, pod1
   restarted from the committed checkpoint, run to quiescence. Both pods
   at step 6 and consistent; pod1 restored step 3's checkpoint; a third
   state machine that applies the decided log directly ends on the same
   digests; every step launches exactly 2 L m forward and L m backward
   flash kernels; losses finite and falling; the leader's LAN-1 bytes 0
   and every disseminator's above 0; the executed sequences equal the
   same schedule's through the DES on the CPU with a stub train step;
   ``train/rwkv6-3b``: full width and depth (32 layers, d 2560, 40
   heads of 64, vocab 65,536), bf16, Adafactor, 4 x 4096 tokens a step
   in the reference's 4 microbatches (its train_4k cell with the batch
   cut to 4), through ``make_train_step`` inside a
   ``TrainerStateMachine`` fed by a two-group ``MergedCommandLog``: one
   fixed batch as 3 STEP commands (1 warm-up, 2 timed with CUDA events),
   each with exactly 256 WKV6 forward and 128 WKV6 backward launches and
   no flash launch, a finite grad norm and a loss below the one before;
   tokens/s and peak memory; a second pod fed the same decisions in the
   reverse order ends equal leaf for leaf; one more step traced for each
   backward pass's device time and share; ``train/rwkv6-3b/f32``: 2
   layers at full width, f32, one AdamW step of 1 x 256 tokens on the
   card (4 forward and 2 backward WKV6 launches) against the same step
   on the CPU: loss, grad_norm, every gradient leaf, the parameters
   after (F32_STEP_TOL);
   ``serve/qwen2-vl-7b`` and ``train/qwen2-vl-7b``: the vision-language
   family (M-RoPE over stub embeddings; ``vlm_serve_phase``,
   ``vlm_train_phase``);
   ``serve/llama4-maverick-400b-a17b``: the MoE family at full width with
   all 128 experts and one dense/MoE pair (the depth cut 48 -> 2), bf16,
   B=4 x 1024 prompt tokens: prefill (2 bf16 flash launches; the MoE
   layer's capacity 40, drops, largest expert load, aux), then
   ``launch.serve.generate`` (the prompt teacher-forced, 32 greedy steps;
   no model kernel, nothing dropped at C = 8); in f32 at one pair with 8
   experts, 1 x 256 tokens: the forward against the teacher-forced decode
   at the positions the forward kept, and the card against the CPU port
   under the flip-aware routing rule; ``train/llama4-maverick-400b-a17b``:
   one pair, 16 experts, bf16, Adafactor, 2 x 4096 tokens in 2
   microbatches (C = 320): 1 warm-up and 3 timed steps, each loss below
   the one before, aux > 0, 8 forward and 4 backward bf16 flash launches
   a step, every MoE dispatch in deterministic mode, the router's
   gradient nonzero; the f32 step (one pair, 8 experts, 1 x 128) against
   the CPU under the flip-aware rule; ``serve/hymba-1.5b``: the hybrid
   family (attention and Mamba heads, window 1024 except layers 0, 16,
   31, 128 meta tokens) at full width and depth, bf16, B=4 x 1024 prompt
   tokens: prefill behind the meta tokens (32 bf16 flash launches, 29 of
   them windowed), then ``launch.serve.generate`` with each decode step
   one captured CUDA graph (128 meta steps, the prompt teacher-forced, 32
   greedy tokens; every ring wraps; no model kernel), both bf16 paths
   against the f32 forward; the flash kernel at the prefill's and the
   train microbatch's shapes with and without the window, and one
   layer's Mamba scan and its share; in f32 at 2 layers over 1,228
   positions the card against the CPU and the captured decode against
   the forward at every position;
   ``train/hymba-1.5b``: full width, 16 of its 32 layers (global 0, 8,
   15), 2 x 4096 tokens behind the meta tokens in 2 microbatches,
   Adafactor, 1 warm-up and 3 timed steps, each loss below the one
   before, 64 forward and 32 backward bf16 flash launches a step, the
   meta tokens', A_log's and w_dt's gradients nonzero and finite, the
   Mamba scan's share of a step, and the f32 step at 2 layers against
   the CPU; ``serve/whisper-small`` and ``train/whisper-small``: the
   encoder-decoder family (``whisper_serve_phase``,
   ``whisper_train_phase``);
   ``serve/deepseek-v3-671b``: multi-head latent attention, a dense
   prefix and top-8 MoE layers with a shared expert, at full width with
   the depth cut 61 -> 2 (one dense block, one MoE block with all 256
   experts; 29.3 GB of bf16 parameters), B=4 x 1024 prompt tokens:
   prefill (2 bf16 flash launches at q/k width 192, v width 128; the MoE
   layer's capacity 160, drops, largest load, aux), then
   ``launch.serve.generate`` (the absorbed MLA decode against the
   compressed cache, one captured CUDA graph a step; no model kernel,
   nothing dropped at C = 8); in f32 at a reduced width that keeps MLA's
   (d 1024, 16 heads, 16 experts at top-8): the forward and prefill (the
   f32 (192, 128) kernel) against the CPU under the flip-aware rule,
   the captured decode against the forward where it kept every choice,
   and absorbed decode steps against the CPU's; ``train/deepseek-v3-
   671b``: the same 2 layers and the MTP head, 256 -> 32 experts at
   top-8, 2 x 4096 tokens in 2 microbatches, Adafactor, 1 warm-up and 3
   timed steps, each loss below the one before, 12 forward and 6
   backward bf16 flash launches a step (``flash_calls``: 3 attention
   layers x 2 microbatches), every dispatch deterministic and each
   recompute routed as its forward; the f32 AdamW step at the reduced
   width against the CPU under the flip-aware rule;
16. backward timing at the train cell's shape and the serving shape in
   bf16 (the tensor-core kernel) and at the serving shape in f32 (the
   CUDA-core kernel): kernel, its device time per pass, plain version,
   the backward of ``scaled_dot_product_attention``, with the bound of
   its five products;
17. the q/k width 192, v width 128 instantiations at deepseek-v3's
   shapes (the deepseek-v3 phases run them on its model paths): bf16
   forward at the MLA serving prefill and train microbatch, bf16
   backward at the microbatch, f32 forward and backward at the f32
   check shape; each per call, device
   time by CUDA kernel, plain version, ``scaled_dot_product_attention``
   (forward and backward) with the kernels it launched, and the bound.

The next-to-last line is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# the H100 SXM's HBM3 rate and dense bf16 tensor-core rate: set in main
# from repro_torch.analysis.roofline (HBM_BW, PEAK_BF16), their one source
HBM_BYTES_PER_S = BF16_FLOPS_PER_S = None
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor 32-bit rate
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 rate of the CUDA cores
WARMUP, REPS = 20, 200
PROFILE_TRIES = 5
PROFILE_LEAD_IN = 1024   # throwaway kernels that open a profiler session
LEAD_IN_KERNEL = "spin_kernel"   # torch.cuda._sleep's kernel
PROFILE_RETRIES = []     # (symbol, launches seen) of each session traced again
START = time.perf_counter()


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(**kv) -> None:
    """Print one JSON line, stamped with the seconds since the script
    started (``at_s``)."""
    print(json.dumps({**kv, "at_s": time.perf_counter() - START}),
          flush=True)


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

SMEM_PER_BLOCK = 232_448     # an H100 block's shared memory at most


def ptxas_entries(text: str) -> dict:
    """``{mangled entry: (registers, spill store bytes, spill load
    bytes)}`` from an ``nvcc -Xptxas=-v`` log."""
    out, entry, spills = {}, None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and entry:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out[entry] = (int(m.group(1)), *spills)
            entry = None
    return out


def flash_instantiations() -> list:
    """Each flash kernel's (padded q/k width, padded v width) pairs."""
    from repro_torch.kernels import flash_attention as kf
    return [(w, kf.v_width(w)) for w in kf.WIDTHS]


def width_key(width: int, vwidth: int):
    """A flash instantiation's key in the logs: its width where the q/k
    and v widths agree, else "192x128"."""
    return width if width == vwidth else f"{width}x{vwidth}"


def build_kernels() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(["quorum.cu", "dissem.cu", "flash_attention.cu",
                         "flash_attention_bf16.cu", "flash_attention_bwd.cu",
                         "flash_attention_bwd_bf16.cu", "wkv6.cu",
                         "wkv6_bwd.cu"])
    seconds = time.perf_counter() - t0
    for source, text in logs.items():
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "ptxas" in ln or "spill" in ln]
        log(build=source, ptxas=ptxas)
        if source.startswith("flash_attention"):
            # every flash instantiation: registers and spills by entry
            # point; none may spill
            entries = ptxas_entries(text)
            log(build=source, registers_and_spills=entries)
            for entry, (regs, stores, loads) in entries.items():
                check(stores == 0 and loads == 0, f"{source}: {entry} "
                      f"spills ({stores} B stored, {loads} B loaded)")
    log(phase="build", seconds=seconds)
    # the tensor cores do the bf16 flash kernels' products (forward and
    # backward): their SASS holds HMMA instructions; the f32 kernels'
    # must hold none (TF32 would break their tolerance)
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    hmma = {}
    tensor_core = ("flash_attention_bf16.cu", "flash_attention_bwd_bf16.cu")
    for source in (*tensor_core, "flash_attention.cu",
                   "flash_attention_bwd.cu"):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(source))],
            check=True, capture_output=True, text=True, timeout=120).stdout
        hmma[source] = sum("HMMA" in ln for ln in sass.splitlines())
    log(phase="build/sass", hmma=hmma)
    for source, n in hmma.items():
        if source in tensor_core:
            check(n > 0, f"{source}: no HMMA instruction in its SASS")
        else:
            check(n == 0, f"{source}: {n} HMMA instructions in the f32 "
                  "kernel's SASS")
    # blocks per SM and shared memory per block of each flash
    # instantiation (f32: its 16-byte copy path), keyed by its padded
    # q/k width, or "192x128" for q/k width 192 with v width 128
    occupancy = {}
    for source, symbol in (("flash_attention_bf16.cu",
                            "flash_attention_bf16_occupancy"),
                           ("flash_attention.cu",
                            "flash_attention_occupancy")):
        fn = getattr(ctypes.CDLL(str(_build.library_path(source))), symbol)
        occupancy[source] = {}
        for width, vwidth in flash_instantiations():
            blocks, smem = ctypes.c_int(), ctypes.c_int()
            err = fn(width, vwidth, ctypes.byref(blocks), ctypes.byref(smem))
            check(err == 0, f"{symbol}({width}, {vwidth}): {err}")
            check(smem.value <= SMEM_PER_BLOCK and blocks.value >= 1,
                  f"{symbol}({width}, {vwidth}): {smem.value} shared bytes, "
                  f"{blocks.value} blocks an SM")
            occupancy[source][width_key(width, vwidth)] = dict(
                blocks_per_sm=blocks.value, smem_bytes_per_block=smem.value)
    # the WKV6 passes: blocks per SM and shared memory per block; and the
    # wrapper sizes the workspace as the kernel lays it out
    from repro_torch.kernels import rwkv6_scan as kw
    lib = ctypes.CDLL(str(_build.library_path("wkv6.cu")))
    lib.wkv6_workspace_floats.restype = ctypes.c_longlong
    for shape in ((4, 1024, 40, 64), (1, 4096, 8, 128), (2, 33, 2, 50),
                  (2, 32, 3, 17), (1, 1, 1, 1)):
        want = lib.wkv6_workspace_floats(*shape)
        check(kw.workspace_floats(*shape) == want,
              f"wkv6 workspace at {shape}: the wrapper allocates "
              f"{kw.workspace_floats(*shape)} floats, the kernel takes {want}")
    wkv = {}
    for hd in (32, 64, 128):
        for phase, name in enumerate(WKV_PHASES, start=1):
            blocks, smem = ctypes.c_int(), ctypes.c_int()
            err = lib.wkv6_occupancy(phase, hd, ctypes.byref(blocks),
                                     ctypes.byref(smem))
            check(err == 0, f"wkv6_occupancy({phase}, {hd}): {err}")
            wkv[f"{name}/hd{hd}"] = dict(blocks_per_sm=blocks.value,
                                         smem_bytes_per_block=smem.value)
    lib = ctypes.CDLL(str(_build.library_path("wkv6_bwd.cu")))
    lib.wkv6_bwd_workspace_floats.restype = ctypes.c_longlong
    for shape in ((1, 4096, 40, 64), (4, 1024, 40, 64), (2, 33, 2, 50),
                  (2, 32, 3, 17), (1, 1, 1, 1)):
        want = lib.wkv6_bwd_workspace_floats(*shape)
        check(kw.bwd_workspace_floats(*shape) == want,
              f"wkv6 backward workspace at {shape}: the wrapper allocates "
              f"{kw.bwd_workspace_floats(*shape)} floats, the kernel takes "
              f"{want}")
    log(phase="build/occupancy",
        flash_attention_bf16=occupancy["flash_attention_bf16.cu"],
        flash_attention_f32=occupancy["flash_attention.cu"], wkv6=wkv,
        wkv6_bwd=wkv_bwd_info())
    return seconds


def wkv_bwd_info() -> dict:
    """Registers a thread, spill (local) bytes a thread, dynamic shared
    bytes a block and blocks an SM of the WKV6 backward's four CUDA
    kernels (bf16 instantiation) at each padded head width, keyed
    ``name/hd<W>`` (``wkv6_bwd_info``). None may ask for more shared
    memory than a block has."""
    from repro_torch.kernels import _build
    fn = ctypes.CDLL(str(_build.library_path("wkv6_bwd.cu"))).wkv6_bwd_info
    out = {}
    for hd in (32, 64, 128):
        for phase, name in enumerate(WKV_BWD_PHASES, start=1):
            vals = [ctypes.c_int() for _ in range(4)]
            err = fn(phase, hd, *map(ctypes.byref, vals))
            check(err == 0, f"wkv6_bwd_info({phase}, {hd}): {err}")
            out[f"{name}/hd{hd}"] = info = dict(zip(
                ("registers", "spill_bytes", "smem_bytes_per_block",
                 "blocks_per_sm"), (v.value for v in vals)))
            check(info["smem_bytes_per_block"] <= SMEM_PER_BLOCK
                  and info["blocks_per_sm"] >= 1,
                  f"{name}/hd{hd} does not fit an SM: {info}")
    return out


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


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts one int32 past a
    16-byte boundary, so the kernels take their 4-byte load path (an
    empty tensor has no data to misalign)."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    check(t.numel() == 0 or view.data_ptr() % 16 == 4,
          "misaligned view is 16-byte aligned")
    return view


# (G, W, n): the engine's ack, vote and hold tiles; the edge shapes of
# tests/test_kernels.py (odd windows, word boundaries, D=1); then where
# the lane mapping switches: 2, 3, 4, 5, 9, 33 and 64 words, W = 1 and
# W = 129, G = 9 clusters (the hold row at the full window), and W = 0
KERNEL_SHAPES = [(G, W, N_DISS), (G, W, N_SEQ), (G, W, PART), (2, 12, 32),
                 (3, 20, 33), (1, 7, 31), (2, 36, 65), (4, 10, 1),
                 (2, 24, 64), (2, 5, 64), (2, 6, 96), (3, 9, 128),
                 (1, 1, 160), (2, 129, 288), (9, 17, 1056), (2, 3, 2048),
                 (9, W, PART), (2, 0, 32)]


def kernel_phase(dev) -> dict:
    """Every kernel against its plain version on the card, at every shape
    of KERNEL_SHAPES, with aligned and misaligned bitsets, in and out of
    place; returns the worst error per kernel (0 = bit-exact)."""
    from repro_torch.kernels import dissem as kd
    from repro_torch.kernels import quorum as kq
    rng = np.random.default_rng(SEED + 1)
    worst = {"quorum_update_grouped": 0, "stability_update_grouped": 0}
    cases = 0
    for (g, w, n) in KERNEL_SHAPES:
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
            for offset in ("aligned", "misaligned"):
                if offset == "misaligned":
                    bits, upd = misaligned(bits), misaligned(upd)
                for name, fn, plain in (
                        ("quorum_update_grouped", kq.quorum_update_grouped,
                         kq.quorum_update_grouped_plain),
                        ("stability_update_grouped",
                         kd.stability_update_grouped,
                         kd.stability_update_grouped_plain)):
                    want = plain(bits, upd, stable, majority=maj)
                    got = fn(bits, upd, stable, majority=maj)
                    buf = misaligned(bits) if offset == "misaligned" \
                        else bits.clone()
                    got_in = fn(buf, upd, stable, majority=maj, inplace=True)
                    check(got_in[0].data_ptr() == buf.data_ptr(),
                          f"{name}: in-place output is not the input buffer")
                    torch.cuda.synchronize()
                    err = max(max_abs_err(got, want),
                              max_abs_err(got_in, want))
                    worst[name] = max(worst[name], err)
                    check(err == 0, f"{name} differs from its plain version "
                          f"at {(g, w, n)}, {offset}: max abs err {err}")
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
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import quorum as kq
    from repro_torch.kernels import rwkv6_scan as kw
    for kernel in (kq.KERNEL, kd.KERNEL, kf.KERNEL, kf.KERNEL_BF16,
                   kf.KERNEL_BWD, kf.KERNEL_BWD_BF16, kw.KERNEL,
                   kw.KERNEL_BWD):
        kernel.launches = 0


def read_counts() -> tuple[int, int]:
    from repro_torch.kernels import dissem as kd
    from repro_torch.kernels import quorum as kq
    return kq.KERNEL.launches, kd.KERNEL.launches


def digest(merged, count) -> tuple[str, int]:
    head = merged[:int(count)].to("cpu").numpy().astype("<i4")
    return hashlib.sha256(head.tobytes()).hexdigest(), int(count)


def trees_equal(a, b) -> bool:
    """Nested dicts of numpy arrays: same keys, dtypes and values."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_equal(a[k], b[k])
                                            for k in a)
    if a is None or b is None:
        return a is b
    return a.dtype == b.dtype and np.array_equal(a, b)


def state_tree(state, cfg=None) -> dict:
    """An engine state as nested numpy arrays; a meshed one gathered."""
    from repro_torch.convert import engine_state_to_numpy
    return engine_state_to_numpy(state, cfg)


def states_equal(a, b) -> bool:
    return trees_equal(state_tree(a), state_tree(b))


def tree_digest(tree) -> str:
    """sha256 of nested dicts of numpy arrays: keys, dtypes, shapes and
    bytes (two trees have one digest iff they are equal)."""
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


def graph_counts(loop) -> tuple[int, int]:
    """(quorum, stability) launches a captured loop recorded in its
    capture, times its replays: what its replays launched on the card."""
    rec = loop.recorded
    return (rec["quorum_update_grouped"] * loop.replays,
            rec["stability_update_grouped"] * loop.replays)


def check_graph_loop(name, loop, want, wrapper) -> None:
    """A captured loop's exact launches: ``want`` (quorum, stability) as
    recorded in the capture x replays, and the wrappers' host count of
    the drive that captured it, ``wrapper``: one warm-up step and the
    captured step, each launching what the capture recorded."""
    rec = (loop.recorded["quorum_update_grouped"],
           loop.recorded["stability_update_grouped"])
    check(graph_counts(loop) == want,
          f"{name}: recorded {rec} x {loop.replays} replays, expected "
          f"{want}")
    if wrapper is not None:
        check(wrapper == (2 * rec[0], 2 * rec[1]),
              f"{name}: the wrappers counted {wrapper} host launches, "
              f"expected a warm-up and a captured step of {rec}")


def device_counts(events) -> tuple[int, int]:
    """(quorum, stability) kernel events of a trace."""
    return (sum("quorum_kernel" in k for k, _ in events),
            sum("stability_kernel" in k for k, _ in events))


def graph_profile(name, run, steps: int, want) -> dict:
    """``run()`` (replays of a captured loop) under ``torch.profiler``:
    the quorum and stability kernels must show as exactly ``want`` device
    events; kernels and device time per step and the busy share. A
    session that :func:`traced` traces again runs ``run`` again, so
    ``run`` starts from a fresh state."""
    wall = {}

    def timed_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall["us"] = (time.perf_counter() - t0) * 1e6
    _, events = traced(timed_run)
    got = device_counts(events)
    check(got == tuple(want), f"{name}: the trace shows {got} quorum and "
          f"stability kernels, expected {tuple(want)}")
    busy = sum(us for _, us in events)
    res = dict(steps=steps, device_launches=got,
               kernels_per_step=len(events) / steps,
               device_us_per_step=busy / steps,
               wall_us_per_step=wall["us"] / steps,
               device_busy_share=busy / wall["us"])
    log(phase=name, **res)
    return res


def run_family(family: str, tiles_cpu, tiles_dev, dev, *, host_ticks: bool):
    """One family through ``Engine.run`` on the card, captured (the
    default there: one CUDA graph of the tick, replayed T times) and
    eager, against the same run on the CPU, and (``host_ticks``)
    ``Engine.tick`` on the card. The captured run, the main path, is
    traced whole (counts reset just before it): its device kernel events
    are its launches, the capture's warm-up step and T replays, exactly
    2(T + 1) and T + 1. The captured engine then runs again from a fresh
    state: the same graph replays (no host launch), the trace shows 2T
    quorum and T stability kernels. Returns the results and each card
    run's wall time and launch counts."""
    from repro_torch.engine import api
    from repro_torch.engine.api import Engine
    cfg = engine_config(family)
    gated = cfg.gating is not None
    ticks = T_MAIN if family == "gated_recycled" else T_FAMILY
    cpu_in = [x[:ticks] for x in tiles_cpu]
    dev_in = [x[:ticks] for x in tiles_dev]
    if not gated:
        cpu_in, dev_in = cpu_in[:2], dev_in[:2]
    want_counts = (2 * ticks, ticks if gated else 0)

    t0 = time.perf_counter()
    ref = Engine.create(cfg, device="cpu")
    ref_out = ref.run(*cpu_in)
    cpu_s = time.perf_counter() - t0
    want = digest(ref_out[0], ref_out[1]) + (int(ref_out[2]),)

    def by_tick(e):
        for t in range(ticks):
            e.tick(*(x[t] for x in dev_in))
        return e.committed()
    results = {}
    runs = [("graph", None, lambda e: e.run(*dev_in)),
            ("run", False, lambda e: e.run(*dev_in))]
    if host_ticks:
        runs.append(("tick", False, by_tick))
    for how, capture, drive in runs:
        box = {}

        def drive_fresh():
            box["eng"] = Engine.create(cfg, device=dev, capture=capture)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            box["out"] = drive(box["eng"])
            torch.cuda.synchronize()
            box["seconds"] = time.perf_counter() - t0
            box["launches"] = read_counts()
        if how == "graph":
            # the main path's own run under the profiler (a session that
            # is traced again drives a fresh engine again)
            _, events = traced(drive_fresh)
        else:
            drive_fresh()
        eng, out, seconds, launches = (box[k] for k in (
            "eng", "out", "seconds", "launches"))
        check(eng.capture == (how == "graph"),
              f"{family}/{how}: Engine.capture is {eng.capture}")
        got = digest(out[0], out[1]) + (int(out[2]),)
        check(got == want, f"{family}/{how}: card {got} != CPU {want}")
        check(states_equal(eng.state, ref.state),
              f"{family}/{how}: final state differs from the CPU run")
        res = dict(seconds=seconds, launches=launches, engine=eng)
        if how == "graph":
            check(len(eng._loops) == 1, f"{family}/graph: "
                  f"{len(eng._loops)} captured loops")
            loop, = eng._loops.values()
            check_graph_loop(f"{family}/graph", loop, want_counts, launches)
            # on the card: the warm-up step, then T replays
            device = device_counts(events)
            want_device = tuple(loop.recorded[k] * (ticks + 1) for k in (
                "quorum_update_grouped", "stability_update_grouped"))
            check(device == want_device,
                  f"{family}/graph: the trace of the run shows {device} "
                  f"quorum and stability kernels, expected {want_device} "
                  "(a warm-up step and T replays)")
            res.update(capture_host_calls=launches, launches=device)
        else:
            check(launches == want_counts,
                  f"{family}/{how}: launches {launches}, expected "
                  f"{want_counts}")
        overflow = int(eng.state.merge.overflowed.sum())
        check(got[2] > 0 and overflow == 0,
              f"{family}/{how}: committed {got[2]}, overflowed {overflow}")
        results[how] = res

    # the captured engine again, from a fresh state: the same graph, no
    # host launch, 2T and T kernels on the card
    eng = results["graph"]["engine"]
    loop, = eng._loops.values()
    first_replays = loop.replays
    again = []

    def rerun():
        eng.state = api.create_state(cfg, dev)
        again.append(eng.run(*dev_in))
    reset_counts()
    prof = graph_profile("profile/graph_tick" + (
        "" if family == "gated_recycled" else f"/{family}"), rerun, ticks,
        want_counts)
    host = read_counts()
    check(host == (0, 0), f"{family}/graph: a replayed run made {host} "
          "host launches")
    check(list(eng._loops.values()) == [loop], f"{family}/graph: the "
          "second run captured again")
    got = digest(again[-1][0], again[-1][1]) + (int(again[-1][2]),)
    check(got == want and states_equal(eng.state, ref.state),
          f"{family}/graph: the replayed run {got} != CPU {want}")
    results["graph"].update(recorded=dict(loop.recorded),
                            replays=first_replays,
                            replayed_run_device_launches=prof[
                                "device_launches"],
                            profile=prof)
    log(phase=f"engine/{family}", ticks=ticks, sha256=want[0],
        count=want[1], committed=want[2], cpu_seconds=cpu_s,
        **{f"{how}_first_seconds": r["seconds"]
           for how, r in results.items()})
    log(phase=f"graph/engine/{family}", ticks=ticks, sha256=want[0],
        count=want[1], committed=want[2],
        device_launches=results["graph"]["launches"],
        capture_host_calls=results["graph"]["capture_host_calls"],
        recorded=loop.recorded, replays_a_run=first_replays,
        replays=loop.replays, replayed_launches=graph_counts(loop),
        replayed_run_device_launches=prof["device_launches"])
    return want, results


def graph_kernel_phase(dev, tiles_dev) -> None:
    """Each engine kernel at the engine's tiles, out of place, captured in
    a CUDA graph alone and replayed twice: every output (bits, counts,
    stable and the stability kernel's cluster-reduced ``newly``) equals
    the eager call's on the same inputs, and the replay launches the
    kernel once on the card (its launch attributes, the stability
    kernel's cluster dimension among them, survive the capture)."""
    from repro_torch.kernels import dissem as kd
    from repro_torch.kernels import quorum as kq
    acks, votes, holds = (x[0] for x in tiles_dev)
    rng = np.random.default_rng(SEED + 7)
    for name, fn, upd, n, symbol in (
            ("quorum_update_grouped", kq.quorum_update_grouped, acks,
             N_DISS, "quorum_kernel"),
            ("quorum_update_grouped", kq.quorum_update_grouped, votes,
             N_SEQ, "quorum_kernel"),
            ("stability_update_grouped", kd.stability_update_grouped, holds,
             PART, "stability_kernel")):
        g, w, words = upd.shape
        bits = torch.from_numpy(sparse_words(rng, (g, w, words), 2, n)
                                .view(np.int32)).to(dev)
        stable = torch.from_numpy(rng.random((g, w)) < 0.3).to(dev)
        maj = n // 2 + 1
        want = fn(bits, upd, stable, majority=maj)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(bits, upd, stable, majority=maj)           # warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn(bits, upd, stable, majority=maj)
        for _ in range(2):
            for x in got:
                x.zero_()
            graph.replay()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"graph/kernel/{name} {[g, w, words]}: a replay differs "
                  "from the eager call")
        events = device_kernels(graph.replay, 4, symbol, 4)
        check(sum(symbol in k for k, _ in events) == 4,
              f"graph/kernel/{name}: 4 replays traced "
              f"{[k for k, _ in events]}")
        log(phase=f"graph/kernel/{name}", shape=[g, w, words],
            outputs=len(got), replays_equal=True)


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


ENQUEUE_CALLS = 1000


def enqueue_us(fn, calls: int = ENQUEUE_CALLS) -> float:
    """Host microseconds to enqueue one call: ``time.perf_counter`` over
    ``calls`` back-to-back calls with no synchronisation, over ``calls``
    (after a warm-up and a synchronise)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / calls


def bare_launch(name, bits, upd, stable, maj):
    """The kernel's ctypes launcher called with pointers, plan and stream
    made once: what an enqueue costs without the wrapper (the wrapper's
    launch counter is not touched)."""
    from repro_torch.kernels import dissem as kd
    from repro_torch.kernels import quorum as kq
    g, w, words = bits.shape
    counts = torch.empty((g, w), dtype=torch.int32, device=bits.device)
    now = torch.empty((g, w), dtype=torch.bool, device=bits.device)
    newly = torch.empty((g,), dtype=torch.int32, device=bits.device)
    stability = name == "stability_update_grouped"
    *_, plan = kq.tile_plan(bits, upd, bits, clustered=stability)
    lg = plan.lanes.bit_length() - 1
    stream = torch.cuda.current_stream().cuda_stream
    if stability:
        fn = kd.KERNEL._fn
        args = (bits.data_ptr(), upd.data_ptr(), stable.data_ptr(),
                bits.data_ptr(), counts.data_ptr(), now.data_ptr(),
                newly.data_ptr(), g, w, words, maj, plan.vec, lg,
                plan.cluster, stream)
    else:
        fn = kq.KERNEL._fn
        args = (bits.data_ptr(), upd.data_ptr(), stable.data_ptr(),
                bits.data_ptr(), counts.data_ptr(), now.data_ptr(), g * w,
                words, maj, plan.vec, lg, plan.grid, stream)

    def call():
        check(fn(*args) == 0, f"{name}: bare launch failed")
    return call


def kernel_device_us(name, fn, calls: int = 50) -> float:
    """Mean device microseconds of the kernel over ``calls`` calls under
    ``torch.profiler``; checks that every device op of those calls is the
    kernel, one per call (no fill, no memset)."""
    symbol = "quorum_kernel" if "quorum" in name else "stability_kernel"
    events = device_kernels(fn, calls, symbol, calls)
    found = [us for k, us in events if symbol in k]
    check(len(found) == calls == len(events),
          f"{name}: profiler saw {len(found)} kernel launches and "
          f"{len(events)} device ops for {calls} calls")
    return sum(found) / calls


def time_kernels(dev, tiles_dev) -> list[dict]:
    """Kernel and plain-version time at the engine's shapes, in place as
    the engine calls them (inputs stay in the 50 MB L2 between calls);
    the kernel's device time there and at a [1, 1, 1] tile (its floor);
    the host's enqueue cost of the wrapper and of a bare launch."""
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

        def kernel():
            return fn(bits, upd, stable, majority=maj, inplace=True)
        ms = time_cuda(kernel)
        plain_ms = time_cuda(lambda: plain(bits, upd, stable, majority=maj,
                                           inplace=True))
        # the kernel's own device time, without the host launch path
        device_us = kernel_device_us(name, kernel)
        one, one_upd = (torch.zeros((1, 1, 1), dtype=torch.int32,
                                    device=dev) for _ in range(2))
        one_stable = torch.zeros((1, 1), dtype=torch.bool, device=dev)
        floor_us = kernel_device_us(name, lambda: fn(
            one, one_upd, one_stable, majority=1, inplace=True))
        wrapper_us = enqueue_us(kernel)
        bare_us = enqueue_us(bare_launch(name, bits, upd, stable, maj))
        plain_dev = sum(us for _, us in device_kernels(
            lambda: plain(bits, upd, stable, majority=maj, inplace=True),
            50, want=1)) / 50
        rows.append(dict(name=name, shape=[g, w, words], ms=ms,
                         plain_ms=plain_ms, device_ms=device_us / 1e3,
                         floor_ms=floor_us / 1e3,
                         enqueue_us=wrapper_us, bare_enqueue_us=bare_us,
                         plain_device_ms=plain_dev / 1e3,
                         **kernel_bound(g, w, words, "stability" in name)))
        log(phase="timing/kernel", **rows[-1])
    return rows


def time_engine(tiles_dev, dev) -> dict:
    """Steady-state rate of the main path, eager (E) against captured
    (G) in turns E, G, G, E inside this call, each a T_MAIN-tick
    ``Engine.run`` from a fresh state after a warm-up run (the capture's
    run), timed by CUDA events and the host clock. Then the host
    microseconds a replay takes, alone and with the step's tile copies,
    and the host-driven tick loop."""
    from repro_torch.engine import api
    from repro_torch.engine.api import Engine
    cfg = engine_config("gated_recycled")
    Engine.create(cfg, device=dev, capture=False).run(*tiles_dev)  # warm-up
    captured = Engine.create(cfg, device=dev)
    captured.run(*tiles_dev)                                     # captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def turn(mode):
        if mode == "eager":
            eng = Engine.create(cfg, device=dev, capture=False)
        else:
            eng = captured
            eng.state = api.create_state(cfg, dev)
        (m, c, k), secs, wall = timed(lambda: eng.run(*tiles_dev))
        return dict(seconds=secs, wall_seconds=wall, committed=int(k),
                    ticks_per_s=T_MAIN / secs,
                    committed_ids_per_s=int(k) / secs,
                    generations_min=int(eng.state.core.rs.retired.min())
                    / W)
    order = ["eager", "graph", "graph", "eager"]
    turns = [(mode, turn(mode)) for mode in order]
    by = {mode: [t for m, t in turns if m == mode] for mode in order}
    commits = {t["committed"] for _, t in turns}
    check(len(commits) == 1, f"timing/engine: committed {commits} across "
          "turns")

    # host microseconds a replay takes (the graph launch alone, and a
    # step: its tile copies and the launch), over few enough steps that
    # the launch queue does not fill
    loop, = captured._loops.values()
    captured.state = api.create_state(cfg, dev)
    loop.load(captured.state)
    n = 32
    seqs = [x[:n] for x in tiles_dev]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        for buf, x in zip(loop.tiles, seqs):
            buf.copy_(x[t])
        loop.graph.replay()
    step_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        loop.graph.replay()
    replay_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()

    eng2 = Engine.create(cfg, device=dev, capture=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(T_MAIN):
        eng2.tick(*(x[t] for x in tiles_dev))
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    eager, graph = by["eager"], by["graph"]
    res = dict(ticks=T_MAIN, committed=commits.pop(), turns=order,
               **{f"{mode}_turn_{k}": [t[k] for t in v]
                  for mode, v in by.items()
                  for k in ("seconds", "wall_seconds", "ticks_per_s",
                            "committed_ids_per_s")},
               step_host_us=step_us, replay_host_us=replay_us,
               # the eager figures under their earlier names
               run_seconds=sum(t["seconds"] for t in eager) / len(eager),
               ticks_per_s=sum(t["ticks_per_s"] for t in eager) / len(eager),
               committed_ids_per_s=sum(t["committed_ids_per_s"]
                                       for t in eager) / len(eager),
               graph_ticks_per_s=sum(t["ticks_per_s"] for t in graph)
               / len(graph),
               graph_committed_ids_per_s=sum(
                   t["committed_ids_per_s"] for t in graph) / len(graph),
               tick_loop_seconds=tick_s,
               tick_loop_ticks_per_s=T_MAIN / tick_s,
               generations_min=eager[0]["generations_min"],
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    log(phase="timing/engine", **res)
    return res


def traced(run, cpu: bool = False):
    """``run()`` under ``torch.profiler`` behind a lead-in; returns the
    profile and its CUDA kernel events as (name, microseconds), the
    lead-in's left out. The profiler records device activity only, unless
    ``cpu`` (the PyTorch ops too, for ``key_averages``): a traced train
    step records ~10^5 host ops, whose events take tens of seconds to
    build.

    ``torch.profiler`` loses the first records of a session, the more of
    them the more sessions the process has traced (seen on the H100 after
    the data-plane phases: the first kernels of a prefill, one WKV6
    launch among them, in every retry of one process). So a session opens
    with PROFILE_LEAD_IN launches of ``torch.cuda._sleep(0)`` (its kernel
    is LEAD_IN_KERNEL) and a synchronise, and the losses fall on them. A
    session that kept none of them may have lost ``run``'s own first
    kernels: it is traced again with twice the lead-in, at most
    PROFILE_TRIES times in all (each retry recorded in PROFILE_RETRIES),
    and then the script fails. ``run`` runs once per session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lead = PROFILE_LEAD_IN
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]
                     + ([ProfilerActivity.CPU] if cpu else [])) as prof:
            for _ in range(lead):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if any(LEAD_IN_KERNEL in name for name, _ in events):
            return prof, [(name, us) for name, us in events
                          if LEAD_IN_KERNEL not in name]
        PROFILE_RETRIES.append(("lead-in", lead))
        lead *= 2
    fail(f"torch.profiler lost the whole lead-in of {PROFILE_TRIES} "
         "sessions")


def device_kernels(fn, calls: int, symbol: str = "", want: int = 0):
    """CUDA kernel events of ``calls`` calls of ``fn`` under
    ``torch.profiler`` (:func:`traced`): list of (name, microseconds).

    ``torch.profiler`` at times delivers a session without part or all of
    its device activity (seen on the H100: a session of five flash calls
    with no CUDA event at all). A session with fewer than ``want`` CUDA
    events whose name holds ``symbol`` (any event, for the empty symbol)
    is traced again, at most PROFILE_TRIES times in all, and each retry is
    recorded in PROFILE_RETRIES; the caller still checks the count."""
    def run():
        for _ in range(calls):
            fn()
    for _ in range(PROFILE_TRIES):
        _, events = traced(run)
        seen = sum(symbol in name for name, _ in events)
        if seen >= want:
            break
        PROFILE_RETRIES.append((symbol, seen))
    return events


def profile_ticks(tiles_dev, dev, ticks: int = 32) -> dict:
    """Device time per tick of host-driven ticks of the main path under
    ``torch.profiler`` (after 8 warm-up ticks), as :func:`profile_loop`
    reports it."""
    from repro_torch.engine.api import Engine
    eng = Engine.create(engine_config("gated_recycled"), device=dev,
                        capture=False)
    return profile_loop(
        lambda t: eng.tick(*(x[t] for x in tiles_dev)), ticks,
        "profile/tick")


DENSE_TICKS = 4       # seeded bool tiles through the dense entry points
DENSE_WANT = (2, 1)   # quorum, stability launches a call of each


def dense_ticks_phase(dev) -> dict:
    """``sharded_tick_dense`` and ``stability_tick_dense`` at the engine
    cell (G x W, N_DISS acks, N_SEQ votes, PART holds, budget BUDGET)
    over DENSE_TICKS seeded bool tiles, on the card and on the CPU: the state and every output must be equal bit
    for bit, and each call must launch exactly DENSE_WANT kernels."""
    from repro_torch.convert import bits_to_numpy, engine_state_to_numpy
    from repro_torch.dissem import engine as DE
    from repro_torch.engine import sharded as SHD
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 2)
    # dense enough that slots stabilise, are assigned and decided within
    # DENSE_TICKS ticks (acks reach 501 of 1000 at the second tick)
    acks = rng.random((DENSE_TICKS, G, W, N_DISS)) < 0.3
    votes = rng.random((DENSE_TICKS, G, W, N_SEQ)) < 0.5
    holds = rng.random((DENSE_TICKS, G, W, PART)) < 1 / 4
    maj = dict(diss_majority=N_DISS // 2 + 1, seq_majority=N_SEQ // 2 + 1,
               order_budget=BUDGET)

    def drive(where) -> dict:
        st = SHD.init_sharded(G, W, N_DISS, N_SEQ, where)
        d = DE.init_dissem(G, W, PART, device=where)
        outs, per_call = [], []
        for t in range(DENSE_TICKS):
            before = read_counts()
            st, out = SHD.sharded_tick_dense(
                st, torch.from_numpy(acks[t]).to(where),
                torch.from_numpy(votes[t]).to(where), **maj)
            mid = read_counts()
            d, dout = DE.stability_tick_dense(
                d, torch.from_numpy(holds[t]).to(where),
                majority=PART // 2 + 1)
            after = read_counts()
            per_call.append((mid[0] - before[0], mid[1] - before[1],
                             after[0] - mid[0], after[1] - mid[1]))
            outs.append({**{f"tick/{k}": v.cpu().numpy()
                            for k, v in out.items()},
                         **{f"stability/{k}": v.cpu().numpy()
                            for k, v in dout.items()}})
        return dict(state=engine_state_to_numpy(st),
                    dissem={"hold_bits": bits_to_numpy(d.hold_bits),
                            "stable": d.stable.cpu().numpy()},
                    outs=outs, per_call=per_call)
    card, cpu = drive(dev), drive(torch.device("cpu"))
    check(trees_equal(card["state"], cpu["state"])
          and trees_equal(card["dissem"], cpu["dissem"])
          and all(trees_equal(a, b) for a, b in zip(card["outs"],
                                                    cpu["outs"])),
          "dense ticks: the card's state or outputs differ from the CPU's")
    check(all(c == (DENSE_WANT[0], 0, 0, DENSE_WANT[1])
              for c in card["per_call"]),
          f"dense ticks launched {card['per_call']} (quorum, stability "
          f"per sharded tick; quorum, stability per stability tick), "
          f"expected {DENSE_WANT}")
    decided = int(sum(o["tick/newly_decided"].sum() for o in cpu["outs"]))
    stable = int(sum(o["stability/newly_stable"].sum()
                     for o in cpu["outs"]))
    check(decided > 0 and stable > 0,
          f"dense ticks decided {decided} and stabilised {stable} slots")
    res = dict(ticks=DENSE_TICKS, shape=[G, W, N_DISS, N_SEQ, PART],
               launches=[DENSE_TICKS * n for n in DENSE_WANT],
               newly_decided=decided, newly_stable=stable,
               parity="bit-exact", seconds=time.perf_counter() - t0)
    log(phase="dense_ticks", **res)
    return res


def dryrun_phase() -> dict:
    """The port's dry run over every arch x SHAPES cell x both production
    meshes, on the meta device (``launch.dryrun.lower_cell``): fails on an
    error record and on a skipped record that ``cell_applicable`` does
    not explain; logs the counts and each arch's largest argument bytes
    per device."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.common import SHAPES
    t0 = time.perf_counter()
    recs = []
    for arch in registry.ARCHS:
        for shape in SHAPES:
            for multi in (False, True):
                try:
                    recs.append(DR.lower_cell(arch, shape, multi))
                except Exception as e:      # a failure is a result
                    recs.append(dict(arch=arch, shape=shape,
                                     mesh="multi" if multi else "single",
                                     status="error",
                                     error=f"{type(e).__name__}: {e}"))
    errors = [r for r in recs if r["status"] == "error"]
    check(not errors, f"dry run errors: {errors[:3]}")
    for r in recs:
        ok, why = DR.cell_applicable(registry.get(r["arch"]), r["shape"])
        check((r["status"] == "ok") == ok
              and (ok or r.get("reason") == why),
              f"dry run cell {r['arch']}/{r['shape']}/{r['mesh']}: "
              f"{r['status']} {r.get('reason')!r}")
    largest = {}
    for r in recs:
        if r["status"] == "ok":
            largest[r["arch"]] = max(largest.get(r["arch"], 0),
                                     r["argument_bytes_per_device"])
    res = dict(cells=len(recs),
               ok=sum(r["status"] == "ok" for r in recs),
               skipped=sum(r["status"] == "skipped" for r in recs),
               errors=0, largest_argument_bytes_per_device=largest,
               seconds=time.perf_counter() - t0)
    log(phase="dryrun", **res)
    return res


def profile_loop(step, ticks: int, phase: str) -> dict:
    """``step(t)`` for t in 0..7 (warm-up), then for ``ticks`` more under
    ``torch.profiler``: kernels launched per tick, their summed time,
    the share of the tick's wall time, the heaviest kernels and the
    heaviest PyTorch ops by the device time of the kernels they launch.
    The profiler's overhead inflates the wall time, so the busy share is
    a lower bound. A session that :func:`traced` traces again runs the
    ticks again, from the state the first one left."""
    from torch.autograd import DeviceType
    for t in range(8):
        step(t)
    torch.cuda.synchronize()
    wall = {}

    def run():
        t0 = time.perf_counter()
        for t in range(8, 8 + ticks):
            step(t)
        torch.cuda.synchronize()
        wall["us"] = (time.perf_counter() - t0) * 1e6
    prof, events = traced(run, cpu=True)
    wall_us = wall["us"]
    kernels = {}
    for name, us in events:
        n, total = kernels.get(name[:90], (0, 0.0))
        kernels[name[:90]] = (n + 1, total + us)
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
    log(phase=phase, **res)
    return res


def time_quorum_single(dev) -> list[dict]:
    """``quorum_update`` (the single-group form, a G = 1 launch) at its
    test shape [7, 31 bits] and at a main-path-sized [2048, 32 words]
    tile, in place."""
    from repro_torch.kernels import quorum as kq
    rng = np.random.default_rng(SEED + 2)
    rows = []
    for w, n in ((7, 31), (2048, 32 * 32)):
        words = (n + 31) // 32
        upd = torch.from_numpy(sparse_words(rng, (w, words), 3, n)
                               .view(np.int32)).to(dev)
        bits = torch.zeros_like(upd)
        stable = torch.zeros((w,), dtype=torch.bool, device=dev)
        maj = n // 2 + 1

        def kernel():
            return kq.quorum_update(bits, upd, stable, majority=maj,
                                    inplace=True)

        def plain():
            return kq.quorum_update_grouped_plain(
                bits[None], upd[None], stable[None], majority=maj,
                inplace=True)
        ms = time_cuda(kernel)
        plain_ms = time_cuda(plain)
        found = [us for k, us in device_kernels(kernel, 50, "quorum_kernel",
                                                50)
                 if "quorum_kernel" in k]
        check(len(found) == 50, f"quorum_update: profiler saw {len(found)} "
              "of 50 kernel launches")
        rows.append(dict(name="quorum_update", shape=[w, words], ms=ms,
                         plain_ms=plain_ms, device_ms=sum(found) / 50e3,
                         **kernel_bound(1, w, words, False)))
        log(phase="timing/kernel", **rows[-1])
    return rows


# -- the closed pipeline ------------------------------------------------------

# The engine's deployment behind client traffic: 8 clients per lane and
# 1024-byte requests (the reference pipeline bench, benchmarks/run.py:
# 537-549), a byte budget that fits a lane's full tick in one batch, and a
# shrink from 4 rows to 3 after segment A. Each client arrives with
# probability 0.045 per tick: 360 requests and ~308 batches offered per
# tick, ~1.2x the ordering budget of G x 64, so the run is saturated.
P_LANE_CLIENTS, P_REQ_BYTES, P_RATE = 8, 1024, 0.045
P_SEG_B = 96          # ticks at epoch 1, after the segment A of T_MAIN
P_DRAIN = 128         # most ticks a drain may take
P_PROFILE = 32


def pipeline_config(adaptive=None):
    """The pipeline phase's configuration; with an ``AdaptiveConfig``,
    the subtick mode, whose merge log holds K rounds per tick."""
    from repro_torch.core.network import batch_bytes
    from repro_torch.engine.api import (EngineConfig, GatingConfig,
                                        RecyclingConfig)
    from repro_torch.engine.epochs import EpochTable
    from repro_torch.pipeline import PipelineConfig
    rng = np.random.default_rng(SEED)
    rounds = 1 if adaptive is None else adaptive.max_tiles_per_tick
    ecfg = EngineConfig(
        groups=G, window=W, n_diss=N_DISS, n_seq=N_SEQ, order_budget=BUDGET,
        merge_capacity=(T_MAIN + P_DRAIN + P_SEG_B + P_DRAIN + 1) * BUDGET
        * rounds,
        recycling=RecyclingConfig(watermark=WATERMARK, id_stride=STRIDE),
        gating=GatingConfig(n_diss_partition=PART, fresh_stable=False),
        epochs=EpochTable((tuple(range(G)), tuple(range(G - 1))),
                          n_rows=G), adaptive=adaptive)
    return PipelineConfig(
        engine=ecfg, n_clients=P_LANE_CLIENTS * N_DISS,
        budget_bytes=batch_bytes(P_LANE_CLIENTS, P_REQ_BYTES),
        ack_lag=tuple(rng.integers(1, 4, N_DISS).tolist()),
        hold_lag=tuple(rng.integers(1, 4, PART).tolist()),
        vote_lag=tuple(rng.integers(1, 3, N_SEQ).tolist()),
        capacity=65536, seq_capacity=512)


def pipeline_tree(state, ecfg=None) -> dict:
    """A pipeline state as nested numpy arrays (bitsets as uint32); a
    meshed engine (``ecfg.mesh``) as its gathered logical state."""
    from repro_torch.convert import engine_state_to_numpy
    return {f: engine_state_to_numpy(v, ecfg) if f == "engine"
            else pipeline_tree(v) if isinstance(v, tuple)
            else v.cpu().numpy() for f, v in state._asdict().items()}


def logical_engine(ecfg, state):
    """The engine state as the unmeshed engine holds it (gathered from
    every rank under a mesh)."""
    from repro_torch.engine import meshed
    return state if ecfg.mesh is None else meshed.gather_state(ecfg, state)


def drain_pipeline(cfg, st, rt):
    """Ticks with no arrivals until every admitted batch is committed;
    returns (state, ticks, summed dropped, each tick's rounds in the
    subtick mode). Fails after P_DRAIN ticks."""
    from repro_torch import pipeline as P
    C = cfg.n_clients
    quiet = (torch.zeros(C, dtype=torch.bool, device=rt.device),
             torch.zeros(C, dtype=torch.int32, device=rt.device))
    dropped = torch.zeros((), dtype=torch.int32, device=rt.device)
    rounds = []
    for n in range(1, P_DRAIN + 1):
        st, out = P.pipeline_tick(cfg, st, *quiet, rt, inplace=True)
        dropped = dropped + out["dropped"]
        if "rounds" in out:
            rounds.append(int(out["rounds"]))
        if int(P.committed(cfg, st)[2]) == int(st.admit_count.sum()):
            return st, n, dropped, rounds
    fail(f"pipeline did not drain in {P_DRAIN} ticks")


def drive_pipeline(cfg, arrived, sizes, rts, dev, capture=None) -> dict:
    """The main path of the pipeline phase on ``dev``: segment A at epoch
    0, a drain, the flip to epoch 1, segment B, a drain. ``capture`` is
    ``run_pipeline``'s (``None``: captured on the card in lock-step);
    both segments step the loop kept in one dict (``loops`` in the
    result); the drains are host-driven ticks."""
    from repro_torch import pipeline as P
    a, s = arrived.to(dev), sizes.to(dev)
    rt0, rt1 = (x.to(dev) for x in rts)
    loops = {}
    st, oa = P.run_pipeline(cfg, P.init_pipeline(cfg, dev), a[:T_MAIN],
                            s[:T_MAIN], rt0, inplace=True, capture=capture,
                            loops=loops)
    st, drain_a, da, ra = drain_pipeline(cfg, st, rt0)
    merged, _, com = P.committed(cfg, st)
    pre = merged[:int(com)].cpu()
    st, report = P.reconfigure_pipeline(cfg, st, 0, 1)
    rs = logical_engine(cfg.engine, st.engine).core.rs
    sealed = (int(rs.retired[G - 1]), int(rs.q.next_instance[G - 1]))
    st, ob = P.run_pipeline(cfg, st, a[T_MAIN:], s[T_MAIN:], rt1,
                            inplace=True, capture=capture, loops=loops)
    st, drain_b, db, rb = drain_pipeline(cfg, st, rt1)
    dropped = int(oa["dropped"].sum() + da + ob["dropped"].sum() + db)
    # the subtick mode's R of every tick, in tick order
    rounds = None if "rounds" not in oa else \
        oa["rounds"].tolist() + ra + ob["rounds"].tolist() + rb
    return dict(state=st, pre=pre, report=report, sealed=sealed,
                drains=(drain_a, drain_b), dropped=dropped, rounds=rounds,
                ticks=T_MAIN + drain_a + P_SEG_B + drain_b,
                loops=list(loops.values()))


def bid_groups(cfg, st, merged, com) -> list:
    """The committed prefix as ((lane, seq), group) pairs, in order."""
    from repro_torch import pipeline as P
    ids = merged[:int(com)].cpu()
    return list(zip(P.decode_merged(cfg, st, merged, com),
                    (ids[ids >= 0] // cfg.id_stride).tolist()))


def lane_request_counts(arrived: np.ndarray) -> np.ndarray:
    """Requests per lane per tick, int64[T, D] (client c is on lane
    c mod D, so clients k*D + d are lane d's)."""
    T = arrived.shape[0]
    return arrived.reshape(T, P_LANE_CLIENTS, N_DISS).sum(1)


def pipeline_phase(dev, engine_ticks_per_s: float) -> dict:
    """The closed pipeline at the engine's deployment, on the card and on
    the CPU, with the checks of the module docstring; then segment A
    timed, and a profiler pass."""
    from repro_torch import pipeline as P
    from repro_torch.core.network import batch_bytes
    start = time.perf_counter()
    cfg = pipeline_config()
    t0 = time.perf_counter()
    rts = [torch.from_numpy(P.build_route_table(cfg, e)) for e in (0, 1)]
    route_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 4)
    arrived_np = rng.random((T_MAIN + P_SEG_B, cfg.n_clients)) < P_RATE
    arrived = torch.from_numpy(arrived_np)
    sizes = torch.where(arrived, P_REQ_BYTES, 0).to(torch.int32)
    check(cfg.lane_slots == P_LANE_CLIENTS,
          f"pipeline: {cfg.lane_slots} request slots per lane, expected "
          f"{P_LANE_CLIENTS}")

    t0 = time.perf_counter()
    ref = drive_pipeline(cfg, arrived, sizes, rts, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    want_tree = pipeline_tree(ref["state"])
    want = digest(*P.committed(cfg, ref["state"])[:2]) + (
        int(P.committed(cfg, ref["state"])[2]),)
    drives = {}
    for how, capture in (("graph", None), ("eager", False)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        run = drive_pipeline(cfg, arrived, sizes, rts, dev, capture)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        m, c, k = P.committed(cfg, run["state"])
        got = digest(m, c) + (int(k),)
        name = "pipeline" if how == "eager" else "graph/pipeline"
        check(got == want, f"{name}: card {got} != CPU {want}")
        check(trees_equal(pipeline_tree(run["state"]), want_tree),
              f"{name}: final state differs from the CPU run")
        check(run["drains"] == ref["drains"]
              and run["report"] == ref["report"],
              f"{name}: drains/report {run['drains']} {run['report']} != "
              f"CPU {ref['drains']} {ref['report']}")
        ticks = run["ticks"]
        drained = sum(run["drains"])
        if how == "eager":
            check(launches == (2 * ticks, ticks), f"{name}: launches "
                  f"{launches}, expected {(2 * ticks, ticks)}")
        else:
            # both segments replay one captured tick (segment B, shorter,
            # with its route table copied in), the drains tick on the host
            loops = run["loops"]
            check(len(loops) == 1 and loops[0].replays == T_MAIN + P_SEG_B,
                  f"{name}: loops replayed {[lp.replays for lp in loops]}")
            rec = [sum(lp.recorded[k] for lp in loops) for k in (
                "quorum_update_grouped", "stability_update_grouped")]
            for lp in loops:
                check_graph_loop(name, lp, (2 * lp.replays, lp.replays),
                                 None)
            check(launches == (2 * drained + 2 * rec[0],
                               drained + 2 * rec[1]),
                  f"{name}: the wrappers counted {launches}: expected the "
                  f"drains' {(2 * drained, drained)} plus a warm-up and a "
                  f"captured tick of each loop, {rec}")
            launches_replayed = tuple(map(sum, zip(
                *(graph_counts(lp) for lp in loops))))
            run["replayed"] = launches_replayed
            log(phase=name, ticks=ticks, drains=run["drains"], sha256=got[0],
                count=got[1], committed=got[2], launches=launches,
                replayed_launches=launches_replayed,
                recorded=[lp.recorded for lp in loops],
                replays=[lp.replays for lp in loops], card_seconds=seconds)
        drives[how] = (run, launches, seconds)
    got, launches, card_s = drives["eager"]
    graph_launches = drives["graph"][1]
    st = got["state"]
    have = want
    check(not bool(st.overflowed) and got["dropped"] == 0,
          f"pipeline: overflowed {bool(st.overflowed)}, dropped "
          f"{got['dropped']}")
    check(int(st.engine.merge.overflowed.sum()) == 0,
          "pipeline: the merge log overflowed")
    check(got["report"]["moved"] == 0 and got["report"]["removed"]
          == (G - 1,), f"pipeline: flip report {got['report']}")
    check(got["sealed"][0] == got["sealed"][1],
          f"pipeline: row {G - 1} not sealed by the flip: retired, "
          f"next_instance = {got['sealed']}")

    # admission records against the host twin: segment A alone gives
    # each lane's batches at epoch 0, which route by the epoch-0 table
    t0 = time.perf_counter()
    n_a = got["drains"][0]
    twin_a = P.plan_admissions(cfg, P.Workload(arrived[:T_MAIN],
                                               sizes[:T_MAIN]), rts[0])
    seqs_a = np.zeros(N_DISS, np.int64)
    for rows in twin_a.values():
        for r in rows:
            seqs_a[r["lane"]] = max(seqs_a[r["lane"]], r["seq"] + 1)
    rt_ab = np.where(np.arange(cfg.seq_capacity)[None, :] < seqs_a[:, None],
                     rts[0].numpy(), rts[1].numpy())
    quiet = torch.zeros((n_a, cfg.n_clients), dtype=torch.bool)
    twin = P.plan_admissions(cfg, P.Workload(
        torch.cat([arrived[:T_MAIN], quiet, arrived[T_MAIN:]]),
        torch.cat([sizes[:T_MAIN], quiet.int(), sizes[T_MAIN:]])), rt_ab)
    twin_s = time.perf_counter() - t0
    count = np.zeros(G, np.int32)
    at = np.zeros((G, cfg.capacity), np.int32)
    code = np.full((G, cfg.capacity), -1, np.int32)
    for g, rows in twin.items():
        count[g] = len(rows)
        for r in rows:
            at[g, r["rank"]] = r["tick"]
            code[g, r["rank"]] = r["lane"] * cfg.seq_capacity + r["seq"]
    for name, w in (("admit_count", count), ("admit_tick", at),
                    ("bid_code", code)):
        check(np.array_equal(getattr(st, name).cpu().numpy(), w),
              f"pipeline: {name} differs from plan_admissions")

    # byte accounting: every lane's tick of n > 0 requests is one batch
    lane_n = lane_request_counts(arrived_np)
    want_bytes = (batch_bytes(lane_n, P_REQ_BYTES) * (lane_n > 0)).sum(0)
    check(np.array_equal(st.flushed_bytes.cpu().numpy(), want_bytes),
          "pipeline: flushed_bytes differ from the sum of batch_bytes")
    check(np.array_equal(st.n_flushed.cpu().numpy(), (lane_n > 0).sum(0)),
          "pipeline: n_flushed differs from the lanes' non-empty ticks")

    # every admitted bid exactly once; the pre-flip prefix kept
    merged, _, com = P.committed(cfg, st)
    bids = P.decode_merged(cfg, st, merged, com)
    want_bids = {P.lane_bid(r["lane"], r["seq"])
                 for rows in twin.values() for r in rows}
    check(len(bids) == len(set(bids)) == len(want_bids) == int(com)
          and set(bids) == want_bids,
          f"pipeline: {len(bids)} decoded bids ({len(set(bids))} distinct)"
          f" against {len(want_bids)} admitted")
    pre = got["pre"]
    check(torch.equal(merged[:len(pre)].cpu(), pre) and len(pre) > 0,
          "pipeline: the committed prefix before the flip is not a prefix "
          "of the final one")
    log(phase="pipeline", ticks=ticks, drains=got["drains"],
        sha256=have[0], count=have[1], committed=have[2],
        admitted=int(count.sum()), requests=int(arrived_np.sum()),
        launches=launches, report={k: got["report"][k] for k in (
            "epoch", "active", "removed", "moved", "marker_round")},
        sealed_retired=got["sealed"][0], cpu_seconds=cpu_s,
        card_first_seconds=card_s, route_table_seconds=route_s,
        twin_seconds=twin_s)
    # eager (E) against captured (G) segment A, in turns E, G, G, E
    turns = [(mode, time_pipeline(cfg, arrived, sizes, rts[0], lane_n, dev,
                                  engine_ticks_per_s,
                                  f"timing/pipeline_{mode}",
                                  capture=mode == "graph"))
             for mode in ("eager", "graph", "graph", "eager")]
    by = {m: [t for mode, t in turns if mode == m] for m in ("eager",
                                                           "graph")}
    timing = {k: sum(t[k] for t in by["eager"]) / 2 for k in (
        "ticks_per_s", "committed_ids_per_s", "committed_requests_per_s",
        "ratio_to_engine_ticks_per_s")}
    timing.update({f"{m}_{k}": [t[k] for t in v] for m, v in by.items()
                   for k in ("ticks_per_s", "committed_ids_per_s",
                             "committed_requests_per_s", "run_seconds",
                             "run_wall_seconds")})
    timing["graph_ticks_per_s"] = sum(by["graph"][i]["ticks_per_s"]
                                      for i in range(2)) / 2
    a, s, rt = arrived.to(dev), sizes.to(dev), rts[0].to(dev)
    box = [P.init_pipeline(cfg, dev)]

    def step(t):
        box[0] = P.pipeline_tick(cfg, box[0], a[t], s[t], rt,
                                 inplace=True)[0]
    profile = profile_loop(step, P_PROFILE, "profile/pipeline")
    # the captured tick traced over P_PROFILE replays of one loop, whose
    # capture a first run made outside the trace
    loops = {}
    P.run_pipeline(cfg, P.init_pipeline(cfg, dev), a[:P_PROFILE],
                   s[:P_PROFILE], rt, inplace=True, loops=loops)

    def replays():
        P.run_pipeline(cfg, P.init_pipeline(cfg, dev), a[:P_PROFILE],
                       s[:P_PROFILE], rt, inplace=True, loops=loops)
    graph_prof = graph_profile("profile/graph_pipeline", replays,
                               P_PROFILE, (2 * P_PROFILE, P_PROFILE))
    log(phase="pipeline/seconds", seconds=time.perf_counter() - start)
    return dict(launches=launches, graph_launches=graph_launches,
                graph_replayed=drives["graph"][0]["replayed"],
                graph_profile=graph_prof, ticks=ticks, timing=timing,
                profile=profile, route_table_seconds=route_s,
                arrived=arrived, sizes=sizes, rts=rts, lane_n=lane_n,
                admitted=int(count.sum()), committed=have[2],
                bid_groups=bid_groups(cfg, st, merged, com),
                sha256=have[0], count=have[1], drains=got["drains"],
                report=got["report"], tree_sha=tree_digest(pipeline_tree(st)))


def time_pipeline(cfg, arrived, sizes, rt, lane_n, dev,
                  engine_ticks_per_s: float,
                  phase: str = "timing/pipeline",
                  capture: bool = False) -> dict:
    """Segment A through ``run_pipeline`` on the card (``capture``: the
    captured tick), after one warm-up run that builds the loop both runs
    step (and captures it), timed by CUDA events:
    pipeline ticks/s, committed batch ids/s and committed requests/s
    (each committed batch carries its lane's requests of the tick that
    flushed it)."""
    from repro_torch import pipeline as P
    a, s, rt = (x.to(dev) for x in (arrived[:T_MAIN], sizes[:T_MAIN], rt))
    loops = {}
    P.run_pipeline(cfg, P.init_pipeline(cfg, dev), a, s, rt, inplace=True,
                   capture=capture, loops=loops)
    st = P.init_pipeline(cfg, dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    st, _ = P.run_pipeline(cfg, st, a, s, rt, inplace=True,
                           capture=capture, loops=loops)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_s = start.elapsed_time(end) / 1e3
    merged, _, com = P.committed(cfg, st)
    # requests of each lane's seq-th batch: its seq-th non-empty tick
    n = lane_n[:T_MAIN]
    seq = np.cumsum(n > 0, axis=0) - 1
    per_batch = np.zeros((N_DISS, cfg.seq_capacity), np.int64)
    t_idx, d_idx = np.nonzero(n)
    per_batch[d_idx, seq[t_idx, d_idx]] = n[t_idx, d_idx]
    ids = merged[:int(com)].cpu().numpy()
    g, k = np.divmod(ids[ids >= 0], cfg.id_stride)
    lane, bseq = np.divmod(st.bid_code.cpu().numpy()[g, k],
                           cfg.seq_capacity)
    requests = int(per_batch[lane, bseq].sum())
    res = dict(ticks=T_MAIN, committed=int(com), committed_requests=requests,
               run_seconds=run_s, run_wall_seconds=wall,
               ticks_per_s=T_MAIN / run_s,
               committed_ids_per_s=int(com) / run_s,
               committed_requests_per_s=requests / run_s,
               ratio_to_engine_ticks_per_s=T_MAIN / run_s
               / engine_ticks_per_s)
    log(phase=phase, **res)
    return res


# -- adaptive tick batching and bandwidth -------------------------------------

# README's adaptive example (AdaptiveConfig(max_tiles_per_tick=4,
# policy="backlog")) at the engine's deployment, over the engine phase's
# tiles pre-loaded with queue_from_arrays. Skew: group 0 holds K times the
# other groups' tiles, the reference bench's shape (benchmarks/run.py:
# 723-767); uniform: every group holds the fast groups' count.
A_K = 4
A_FAST = T_MAIN // A_K
A_SCENARIOS = (("skew", [T_MAIN] + [A_FAST] * (G - 1)),
               ("uniform", [A_FAST] * G))
A_PASSES = T_MAIN + P_DRAIN      # most passes a scenario may take
# the reference's bench_dissem (benchmarks/run.py:646-689) at the
# deployment's 1000 disseminators: 2,000 batches of the pipeline's shape
BW_BATCHES = 2000


def adaptive_config():
    from repro_torch.engine.adaptive import AdaptiveConfig
    from repro_torch.engine.api import (EngineConfig, GatingConfig,
                                        RecyclingConfig)
    return EngineConfig(
        groups=G, window=W, n_diss=N_DISS, n_seq=N_SEQ,
        order_budget=BUDGET, merge_capacity=A_PASSES * BUDGET,
        recycling=RecyclingConfig(watermark=WATERMARK, id_stride=STRIDE),
        gating=GatingConfig(n_diss_partition=PART, fresh_stable=False),
        adaptive=AdaptiveConfig(max_tiles_per_tick=A_K, policy="backlog",
                                threshold=1, queue_capacity=T_MAIN))


def adaptive_engine(cfg, tiles, lens, dev, capture=None):
    """A fresh engine (``capture`` as ``Engine.create``'s) whose queue
    holds each group's first ``lens[g]`` tiles."""
    from repro_torch.engine.adaptive import queue_from_arrays
    from repro_torch.engine.api import Engine
    eng = Engine.create(cfg, device=dev, capture=capture)
    eng.queue = queue_from_arrays(cfg, *tiles, lengths=lens)
    return eng


def drain_adaptive(eng) -> tuple[list, int]:
    """``Engine.adaptive_pass`` until R = 0: (each pass's R, summed merge
    truncations). Fails after A_PASSES passes."""
    dropped = torch.zeros((), dtype=torch.int32,
                          device=eng.state.merge.logs.device)
    rounds = []
    for _ in range(A_PASSES):
        out = eng.adaptive_pass()
        dropped = dropped + out["dropped"]
        r = int(out["rounds"])
        if r == 0:
            return rounds, int(dropped)
        rounds.append(r)
    fail(f"adaptive: no quiescence in {A_PASSES} passes")


def lockstep_tiles(tiles, lens, ticks: int):
    """The queue's traffic as lock-step input: group g's first lens[g]
    tiles, then zero tiles up to ``ticks``."""
    out = []
    for x in tiles:
        pad = torch.zeros((ticks,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        for g, n in enumerate(lens):
            pad[:n, g] = x[:n, g]
        out.append(pad)
    return out


def timed(fn) -> tuple:
    """(result, seconds by CUDA events, wall seconds) of one call."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3, time.perf_counter() - t0


def adaptive_engine_phase(dev, tiles_cpu) -> dict:
    """``adaptive/skew`` and ``adaptive/uniform``: adaptive passes to
    quiescence on the card, eager (R read each pass, R rounds) and
    captured (one replay of the fixed-K pass each), against the same
    passes on the CPU (merged log, state, queue, every R) and against a
    lock-step ``Engine.run`` of ΣR ticks on the card (the same merged
    prefix); ``Engine.run_adaptive`` and the functional ``run_adaptive``
    captured (no host read between passes) equal them too. Launches
    exactly 2·ΣR and ΣR eager, 2K and K a captured pass (recorded x
    replays, and device events in a trace). Then lock-step and adaptive
    timed eager (E) and captured (G) in turns E, G, G, E."""
    from repro_torch.convert import queue_to_numpy
    from repro_torch.engine import adaptive as ad
    from repro_torch.engine import api
    from repro_torch.engine.api import Engine
    cfg = adaptive_config()
    tiles_dev = [x.to(dev) for x in tiles_cpu]
    out = {}
    for scenario, lens in A_SCENARIOS:
        name = f"adaptive/{scenario}"
        t0 = time.perf_counter()
        ref = adaptive_engine(cfg, tiles_cpu, lens, torch.device("cpu"))
        ref_rounds, _ = drain_adaptive(ref)
        cpu_s = time.perf_counter() - t0
        res = ref.committed()
        want = digest(res[0], res[1]) + (int(res[2]),)
        ref_state, ref_queue = (state_tree(ref.state),
                                queue_to_numpy(ref.queue))

        def same(eng, what):
            res = eng.committed()
            got = digest(res[0], res[1]) + (int(res[2]),)
            check(got == want, f"{what}: card {got} != CPU {want}")
            check(trees_equal(state_tree(eng.state), ref_state),
                  f"{what}: final state differs from the CPU run")
            check(trees_equal(queue_to_numpy(eng.queue), ref_queue),
                  f"{what}: final queue differs from the CPU run")
            return got

        eng = adaptive_engine(cfg, tiles_dev, lens, dev, capture=False)
        torch.cuda.synchronize()
        reset_counts()
        (rounds, dropped), card_s, _ = timed(lambda: drain_adaptive(eng))
        launches = read_counts()
        n = sum(rounds)
        got = same(eng, name)
        check(rounds == ref_rounds, f"{name}: rounds differ from the CPU's")
        check(launches == (2 * n, n),
              f"{name}: launches {launches}, expected {(2 * n, n)}")
        q = eng.queue
        check(dropped == 0 and int(q.dropped.sum()) == 0
              and int(eng.state.merge.overflowed.sum()) == 0,
              f"{name}: dropped {dropped}, queue dropped "
              f"{q.dropped.tolist()}, merge overflowed "
              f"{eng.state.merge.overflowed.tolist()}")
        check(torch.equal(q.head, q.tail)
              and q.tail.tolist() == lens, f"{name}: queue not consumed: "
              f"head {q.head.tolist()}, tail {q.tail.tolist()}")
        check(got[2] > 0 and n >= max(lens),
              f"{name}: committed {got[2]}, ΣR {n}")
        passes = len(rounds)

        # captured: one replay of the fixed-K pass each, R read after it
        gname = f"graph/adaptive/{scenario}"
        geng = adaptive_engine(cfg, tiles_dev, lens, dev)
        check(geng.capture, f"{gname}: the engine is not captured")
        torch.cuda.synchronize()
        reset_counts()
        (grounds, gdropped), graph_s, _ = timed(lambda: drain_adaptive(geng))
        glaunches = read_counts()
        same(geng, gname)
        check(grounds == ref_rounds and gdropped == 0,
              f"{gname}: rounds {grounds[:8]}..., dropped {gdropped}")
        loop, = geng._loops.values()
        check_graph_loop(gname, loop, (2 * A_K * (passes + 1),
                                       A_K * (passes + 1)), glaunches)
        drain_replays = loop.replays
        # passes with no host read between them: the facade's and the
        # functional run_adaptive
        e = adaptive_engine(cfg, tiles_dev, lens, dev)
        e.run_adaptive(passes)
        same(e, f"{gname}/run_adaptive")
        fst, fq, *fres = ad.run_adaptive(
            cfg, api.create_state(cfg, dev),
            ad.queue_from_arrays(cfg, *tiles_dev, lengths=lens),
            n_passes=passes + 4)
        check(digest(fres[0], fres[1]) + (int(fres[2]),) == want
              and trees_equal(state_tree(fst), ref_state)
              and trees_equal(queue_to_numpy(fq), ref_queue),
              f"{gname}: the functional run_adaptive differs from the CPU")

        # lock-step over the same tiles, drain-padded to ΣR ticks, eager
        # and captured
        lock_in = lockstep_tiles(tiles_dev, lens, n)
        glock = Engine.create(cfg, device=dev)
        for lock in (Engine.create(cfg, device=dev, capture=False), glock):
            m, c, k = lock.run(*lock_in)
            lock_got = digest(m, c) + (int(k),)
            check(lock_got == got, f"{name}: lock-step {lock_got} != "
                  f"adaptive {got} (capture={lock.capture})")

        # timing in turns E, G, G, E; eager drives on fresh engines, the
        # captured ones on the engines above from a fresh state
        def run_lock(mode):
            if mode == "eager":
                e = Engine.create(cfg, device=dev, capture=False)
            else:
                e = glock
                e.state = api.create_state(cfg, dev)
            torch.cuda.synchronize()
            return timed(lambda: e.run(*lock_in))[1:]

        def run_adaptive(mode):
            if mode == "eager":
                e = adaptive_engine(cfg, tiles_dev, lens, dev,
                                    capture=False)
                return timed(lambda: drain_adaptive(e))[1:]
            geng.state = api.create_state(cfg, dev)
            geng.queue = geng.queue._replace(
                head=torch.zeros_like(geng.queue.head))
            return timed(lambda: geng.run_adaptive(passes))[1:]
        turns = [(mode, {"lockstep": run_lock(mode),
                         "adaptive": run_adaptive(mode)})
                 for mode in ("eager", "graph", "graph", "eager")]
        res = dict(
            lens=lens, passes=passes, rounds_sum=n,
            k_times_passes=A_K * passes,
            rounds_hist={r: rounds.count(r) for r in sorted(set(rounds))},
            sha256=got[0], count=got[1], committed=got[2],
            launches=launches, graph_launches=glaunches,
            graph_recorded=loop.recorded, graph_replays=drain_replays,
            cpu_seconds=cpu_s, card_first_seconds=card_s,
            graph_first_seconds=graph_s)
        for mode in ("eager", "graph"):
            pre = "" if mode == "eager" else "graph_"
            secs = {k: [t[k] for m, t in turns if m == mode]
                    for k in ("lockstep", "adaptive")}
            res.update(
                {f"{pre}{k}_seconds": [t[0] for t in v]
                 for k, v in secs.items()},
                **{f"{pre}{k}_wall_seconds": [t[1] for t in v]
                   for k, v in secs.items()},
                **{f"{pre}{k}_committed_ids_per_s": [got[2] / t[0]
                                                     for t in v]
                   for k, v in secs.items()})
            res[f"{pre}adaptive_over_lockstep_ids_per_s"] = \
                sum(t[0] for t in secs["lockstep"]) \
                / sum(t[0] for t in secs["adaptive"])
        log(phase=name, **res)
        out[scenario] = dict(res, rounds=rounds,
                             state_sha=tree_digest(state_tree(eng.state)))
        if scenario == "skew":
            # passes 9-40 of the skew all run R = 4 rounds
            e = adaptive_engine(cfg, tiles_dev, lens, dev, capture=False)
            profile_loop(lambda t: e.adaptive_pass(), 32,
                         "profile/adaptive_skew")

            # the first 32 captured passes, traced: 2K and K kernels each
            def replays():
                geng.state = api.create_state(cfg, dev)
                geng.queue = geng.queue._replace(
                    head=torch.zeros_like(geng.queue.head))
                geng.run_adaptive(32)
            out[scenario]["graph_profile"] = graph_profile(
                "profile/graph_adaptive_skew", replays, 32,
                (2 * A_K * 32, A_K * 32))
    return out


def adaptive_pipeline_phase(dev, pipe: dict,
                            engine_ticks_per_s: float) -> dict:
    """``pipeline/adaptive``: the pipeline phase's whole drive in the
    subtick mode (K = 4, policy "unstable"). The card's run equals the
    CPU's; against the lock-step run of the pipeline phase the same
    arrivals give the same admitted count, all committed, the same bid
    multiset and equal per-lane suborders; nothing overflowed or was
    dropped, the flip sealed row G-1, launches exactly 2·ΣR and ΣR.
    Then segment A timed in the subtick mode and in lock-step.

    Each lane's batches are held in admission order within each group,
    in both runs, and each batch in the same group. Across groups the
    two modes interleave differently (a lagging group's extra rounds
    order its batches earlier), so a lane's whole suborder is logged
    against lock-step's, not required to equal it."""
    from repro_torch import pipeline as P
    from repro_torch.engine.adaptive import AdaptiveConfig
    cfg = pipeline_config(AdaptiveConfig(max_tiles_per_tick=A_K,
                                         policy="unstable"))
    arrived, sizes, rts = pipe["arrived"], pipe["sizes"], pipe["rts"]
    t0 = time.perf_counter()
    ref = drive_pipeline(cfg, arrived, sizes, rts, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = drive_pipeline(cfg, arrived, sizes, rts, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_counts()
    st, rounds = got["state"], got["rounds"]
    n = sum(rounds)

    res = [P.committed(cfg, x["state"]) for x in (ref, got)]
    want, have = (digest(m, c) + (int(k),) for m, c, k in res)
    check(have == want, f"pipeline/adaptive: card {have} != CPU {want}")
    check(trees_equal(pipeline_tree(st), pipeline_tree(ref["state"])),
          "pipeline/adaptive: final state differs from the CPU run")
    check(got["drains"] == ref["drains"] and got["report"] == ref["report"]
          and rounds == ref["rounds"],
          "pipeline/adaptive: drains, report or rounds differ from the CPU")
    check(len(rounds) == got["ticks"] and min(rounds) >= 1,
          f"pipeline/adaptive: {len(rounds)} rounds for {got['ticks']} "
          "ticks")
    check(launches == (2 * n, n),
          f"pipeline/adaptive: launches {launches}, expected {(2 * n, n)}")
    check(not bool(st.overflowed) and got["dropped"] == 0
          and int(st.engine.merge.overflowed.sum()) == 0,
          f"pipeline/adaptive: overflowed {bool(st.overflowed)}, dropped "
          f"{got['dropped']}, merge overflowed "
          f"{st.engine.merge.overflowed.tolist()}")
    check(got["report"]["moved"] == 0
          and got["report"]["removed"] == (G - 1,)
          and got["sealed"][0] == got["sealed"][1],
          f"pipeline/adaptive: flip report {got['report']}, sealed "
          f"{got['sealed']}")

    # against the lock-step run of the same arrivals
    merged, _, com = res[1]
    admitted = int(st.admit_count.sum())
    check(admitted == pipe["admitted"] == int(com) == pipe["committed"],
          f"pipeline/adaptive: admitted {admitted}, committed {int(com)}; "
          f"lock-step {pipe['admitted']}, {pipe['committed']}")
    pairs, lock_pairs = bid_groups(cfg, st, merged, com), pipe["bid_groups"]
    check(sorted(pairs) == sorted(lock_pairs)
          and len(set(b for b, _ in pairs)) == len(pairs),
          "pipeline/adaptive: the bids or their groups differ from "
          "lock-step's")

    def suborders(ps, key):
        out = {}
        for (lane, seq), g in ps:
            out.setdefault(key(lane, g), []).append(seq)
        return out
    for ps in (pairs, lock_pairs):
        check(all(v == sorted(v) for v in suborders(
                  ps, lambda lane, g: (lane, g)).values()),
              "pipeline/adaptive: a lane's batches are out of admission "
              "order within a group")
    lanes, lock_lanes = (suborders(ps, lambda lane, g: lane)
                         for ps in (pairs, lock_pairs))
    same_lanes = sum(lanes[k] == lock_lanes[k] for k in lock_lanes)
    pre = got["pre"]
    check(torch.equal(merged[:len(pre)].cpu(), pre) and len(pre) > 0,
          "pipeline/adaptive: the committed prefix before the flip is not "
          "a prefix of the final one")
    log(phase="pipeline/adaptive", ticks=got["ticks"], drains=got["drains"],
        lockstep_ticks=pipe["ticks"], rounds_sum=n,
        lanes=len(lock_lanes), lanes_same_suborder=same_lanes,
        lanes_fifo=sum(v == sorted(v) for v in lanes.values()),
        lockstep_lanes_fifo=sum(v == sorted(v) for v in lock_lanes.values()),
        rounds_hist={r: rounds.count(r) for r in sorted(set(rounds))},
        sha256=have[0], count=have[1], committed=have[2], launches=launches,
        cpu_seconds=cpu_s, card_first_seconds=card_s)
    timing = {
        "adaptive": time_pipeline(cfg, arrived, sizes, rts[0],
                                  pipe["lane_n"], dev, engine_ticks_per_s,
                                  "timing/pipeline_adaptive"),
        "lockstep": time_pipeline(pipeline_config(), arrived, sizes, rts[0],
                                  pipe["lane_n"], dev, engine_ticks_per_s,
                                  "timing/pipeline_lockstep",
                                  capture=False)}
    a, s, rt = arrived.to(dev), sizes.to(dev), rts[0].to(dev)
    box = [P.init_pipeline(cfg, dev)]

    def step(t):
        box[0] = P.pipeline_tick(cfg, box[0], a[t], s[t], rt,
                                 inplace=True)[0]
    profile_loop(step, P_PROFILE, "profile/pipeline_adaptive")
    return dict(launches=launches, rounds_sum=n, timing=timing)


def bandwidth_phase(dev) -> list[dict]:
    """``dissem/bandwidth``: uniform traffic of BW_BATCHES batches of the
    pipeline's shape absorbed by one ``stability_tick`` on the card, at
    G = 1, 2, 4 over N_DISS disseminators; per-node bytes equal the
    CPU's and the closed form times slots per node."""
    from repro_torch.convert import bits_from_numpy
    from repro_torch.core.network import batch_bytes
    from repro_torch.dissem import bandwidth as bw
    from repro_torch.dissem.engine import init_dissem, stability_tick
    nbytes = batch_bytes(P_LANE_CLIENTS, P_REQ_BYTES)
    rows, base_in = [], None
    for g in (1, 2, 4):
        mp = bw.partition_size(N_DISS, g)
        wg = BW_BATCHES // g
        packed, owner, nb = bw.uniform_traffic(g, wg, mp,
                                               batch_nbytes=nbytes)
        per_dev = []
        for d in (torch.device("cpu"), dev):
            st, _ = stability_tick(init_dissem(g, wg, mp, device=d),
                                   bits_from_numpy(packed, d),
                                   majority=mp // 2 + 1)
            check(bool(st.stable.all()), f"dissem/G={g}: not all stable")
            per_dev.append(bw.per_node_bytes(st, owner, nb, mp))
        (cin, cout), (din, dout) = per_dev
        cf = bw.replication_bytes_per_node(P_LANE_CLIENTS, P_REQ_BYTES, mp)
        slots = wg // mp
        check(np.array_equal(din, cin) and np.array_equal(dout, cout),
              f"dissem/G={g}: card bytes differ from the CPU's")
        check((din == slots * cf["in"]).all()
              and (dout == slots * cf["out"]).all(),
              f"dissem/G={g}: bytes differ from the closed form")
        node_in = int(din.max())
        base_in = node_in if base_in is None else base_in
        rows.append(dict(groups=g, n_diss_partition=mp, batches_per_group=wg,
                         batch_wire_bytes=nbytes, per_node_in_bytes=node_in,
                         per_node_out_bytes=int(dout.max()),
                         closed_form_in=cf["in"], closed_form_out=cf["out"],
                         in_reduction_vs_global=base_in / node_in))
        log(phase=f"dissem/bandwidth/G={g}", **rows[-1])
    check(rows[-1]["in_reduction_vs_global"] > 3.9,
          "dissem/bandwidth: partitioning did not cut per-node bytes ~G")
    return rows


# -- the meshed engine --------------------------------------------------------

# The engine cell's deployment with EngineConfig.mesh: one process per
# rank. NCCL (rank r on cuda:r) at min(cards, 4) ranks; gloo, every rank
# on cuda:0, at 2, 3 and 4 ranks (at 3, G = 4 pads to 6 rows and rank 2
# holds pad rows only); gloo at 2 ranks also runs adaptive/skew and the
# pipeline cell with its flip.
MESH_GLOO_WORLDS = (2, 3, 4)
MESH_DEADLINE_S = 240          # per world, its children's start included
MESH_COLLECTIVE_CALLS = 1000


def mesh_device(backend: str, rank: int) -> torch.device:
    """The card of a rank: its own under NCCL, cuda:0 under gloo."""
    return torch.device("cuda", rank if backend == "nccl" else 0)


def meshed_config(cfg):
    from repro_torch.engine.api import MeshConfig
    return dataclasses.replace(cfg, mesh=MeshConfig())


def mesh_child(tag: str, rank: int, world: int, backend: str,
               d: Path) -> int:
    """One rank of a mesh world (``--mesh-child``): joins the process
    group, drives its paths on the rank's card and writes what it saw to
    ``d/<tag>_r<rank>.json``."""
    import torch.distributed as dist
    from datetime import timedelta
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import pipeline as P
    from repro_torch.engine import meshed
    from repro_torch.engine.api import Engine
    from repro_torch.launch import mesh as launch_mesh
    torch.set_num_threads(1)
    dev = mesh_device(backend, rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{d}/{tag}.init",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    tiles = [torch.from_numpy(np.load(d / f"tiles{i}.npy").view(np.int32))
             .to(dev) for i in range(3)]
    cfg = meshed_config(engine_config("gated_recycled"))
    mesh = meshed.mesh_for(cfg)
    out = dict(tag=tag, rank=rank, world=world, backend=mesh.backend,
               mesh=dict(size=mesh.size, rank=mesh.rank, rows=mesh.rows,
                         pad=mesh.pad, first=mesh.first))

    def result(merged, count, committed):
        return digest(merged, count) + (int(committed),)

    def drive(name, make, fn):
        """``fn(engine)`` on a fresh engine from ``make()``, the counts
        reset just before and read just after, timed by CUDA events."""
        eng = make()
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        res, secs, wall = timed(lambda: fn(eng))
        out[name] = dict(launches=read_counts(), seconds=secs,
                         wall_seconds=wall)
        return eng, res

    # Engine.run
    eng, res = drive("run", lambda: Engine.create(cfg, device=dev),
                     lambda e: e.run(*tiles))
    out["run"].update(result=result(*res), ticks_per_s=T_MAIN / out["run"][
        "seconds"], state_sha=tree_digest(state_tree(eng.state, cfg)),
        device=str(eng.state.core.rs.q.ack_bits.device))
    if backend == "nccl":
        # 288 x Engine.tick, the host time inside the collective counted
        inside = [0.0]
        gather = launch_mesh.all_gather_rows

        def counted(x, m):
            t0 = time.perf_counter()
            y = gather(x, m)
            inside[0] += time.perf_counter() - t0
            return y
        launch_mesh.all_gather_rows = counted

        def by_tick(e):
            for t in range(T_MAIN):
                e.tick(*(x[t] for x in tiles))
            return e.committed()
        eng, res = drive("tick", lambda: Engine.create(cfg, device=dev),
                         by_tick)
        launch_mesh.all_gather_rows = gather
        out["tick"].update(result=result(*res),
                           state_sha=tree_digest(state_tree(eng.state, cfg)))
        # meshed against unmeshed Engine.run, in turns (U, M, M, U)
        base = meshed.unmeshed(cfg)
        turns = []
        for c in (base, cfg, cfg, base):
            e = Engine.create(c, device=dev, capture=False)
            torch.cuda.synchronize()
            dist.barrier()
            turns.append((c.mesh is not None,
                          timed(lambda: e.run(*tiles))[1]))
        out["timing"] = dict(
            unmeshed_ticks_per_s=[T_MAIN / s for m, s in turns if not m],
            meshed_ticks_per_s=[T_MAIN / s for m, s in turns if m],
            tick_collective_host_us=inside[0] / T_MAIN * 1e6)
        # a profiler pass over 32 host-driven meshed ticks, as
        # profile_ticks does for the unmeshed engine
        e = Engine.create(cfg, device=dev)
        prof = profile_loop(lambda t: e.tick(*(x[t] for x in tiles)), 32,
                            "profile/mesh_tick")
        out["timing"]["profile"] = {k: prof[k] for k in (
            "wall_us_per_tick", "kernels_per_tick", "device_us_per_tick",
            "device_busy_share")}
        # the tick's collective alone: host enqueue and round trip
        buf = torch.zeros((mesh.rows, cfg.max_entries + 1),
                          dtype=torch.int32, device=dev)
        for _ in range(20):
            launch_mesh.all_gather_rows(buf, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_COLLECTIVE_CALLS):
            launch_mesh.all_gather_rows(buf, mesh)
        enqueue = (time.perf_counter() - t0) / MESH_COLLECTIVE_CALLS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_COLLECTIVE_CALLS):
            launch_mesh.all_gather_rows(buf, mesh)
            torch.cuda.synchronize()
        rtt = (time.perf_counter() - t0) / MESH_COLLECTIVE_CALLS
        out["timing"].update(collective_enqueue_us=enqueue * 1e6,
                             collective_round_trip_us=rtt * 1e6,
                             collective_bytes_per_rank=buf.nbytes)
    if tag == f"gloo{MESH_GLOO_WORLDS[0]}":
        # adaptive/skew
        acfg = meshed_config(adaptive_config())
        lens = dict(A_SCENARIOS)["skew"]
        eng, (rounds, dropped) = drive(
            "adaptive", lambda: adaptive_engine(acfg, tiles, lens, dev),
            drain_adaptive)
        out["adaptive"].update(
            result=result(*eng.committed()), rounds=rounds,
            dropped=dropped,
            state_sha=tree_digest(state_tree(eng.state, acfg)))
        # the pipeline cell, its flip included
        pcfg = pipeline_config()
        pcfg = dataclasses.replace(pcfg, engine=meshed_config(pcfg.engine))
        arrived = torch.from_numpy(np.load(d / "arrived.npy"))
        sizes = torch.where(arrived, P_REQ_BYTES, 0).to(torch.int32)
        rts = [torch.from_numpy(np.load(d / f"route{e}.npy"))
               for e in (0, 1)]
        _, got = drive("pipeline", lambda: None, lambda _: drive_pipeline(
            pcfg, arrived, sizes, rts, dev))
        st = got["state"]
        out["pipeline"].update(
            result=result(*P.committed(pcfg, st)), ticks=got["ticks"],
            drains=list(got["drains"]), dropped=got["dropped"],
            sealed=list(got["sealed"]),
            report={k: got["report"][k] for k in (
                "epoch", "active", "removed", "moved", "marker_round")},
            overflowed=bool(st.overflowed),
            tree_sha=tree_digest(pipeline_tree(st, pcfg.engine)))
    dist.barrier()
    dist.destroy_process_group()
    (d / f"{tag}_r{rank}.json").write_text(json.dumps(out))
    return 0


def mesh_world(tag: str, backend: str, world: int, d: Path) -> list:
    """Run one world's ranks as children of this script, with a deadline;
    a child that fails, hangs or exits non-zero fails the phase (every
    child is stopped first). Returns each rank's record."""
    logs = [open(d / f"{tag}_r{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-child", tag,
         str(r), str(world), backend, str(d)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    end = time.monotonic() + MESH_DEADLINE_S
    failed = []
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "deadline"
            if rc != 0:
                failed.append((r, rc))
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if failed:
        r, rc = failed[0]
        tail = (d / f"{tag}_r{r}.log").read_text()[-4000:]
        fail(f"mesh/{tag}: rank {r} ended with {rc}:\n{tail}")
    return [json.loads((d / f"{tag}_r{r}.json").read_text())
            for r in range(world)]


def mesh_phase(dev, tiles_np, main_want, main_state, adaptive: dict,
               pipe: dict) -> dict:
    """The meshed engine: each world's ranks against the unmeshed card
    and CPU runs of this call (merged sha256, count, committed length,
    gathered state), exact launches on every rank (2T and T per
    ``Engine.run``), each rank's kernels on its card; adaptive/skew and
    the pipeline with its flip at 2 gloo ranks; timing."""
    import tempfile
    start = time.perf_counter()
    n_nccl = min(torch.cuda.device_count(), 4)
    want_state = tree_digest(state_tree(main_state))
    skew = adaptive["skew"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        for i, x in enumerate(tiles_np):
            np.save(d / f"tiles{i}.npy", x)
        np.save(d / "arrived.npy", pipe["arrived"].numpy())
        for e, rt in enumerate(pipe["rts"]):
            np.save(d / f"route{e}.npy", rt.numpy())
        for backend, world in [("nccl", n_nccl)] + [
                ("gloo", n) for n in MESH_GLOO_WORLDS]:
            tag = f"{backend}{world}"
            t0 = time.perf_counter()
            ranks = mesh_world(tag, backend, world, d)
            seconds = time.perf_counter() - t0
            for r, rec in enumerate(ranks):
                name = f"mesh/{tag}/rank{r}"
                check(rec["backend"] == backend and rec["mesh"]["rank"] == r
                      and rec["mesh"]["size"] == min(world, G),
                      f"{name}: mesh {rec['backend']} {rec['mesh']}")
                want_dev = str(mesh_device(backend, r))
                paths = ["run"] + (["tick"] if backend == "nccl" else [])
                for path in paths:
                    got = rec[path]
                    check(tuple(got["result"]) == main_want,
                          f"{name}/{path}: {got['result']} != the unmeshed "
                          f"card and CPU runs' {main_want}")
                    check(got["state_sha"] == want_state,
                          f"{name}/{path}: gathered state differs from the "
                          "unmeshed run's")
                    check(tuple(got["launches"]) == (2 * T_MAIN, T_MAIN),
                          f"{name}/{path}: launches {got['launches']}, "
                          f"expected {(2 * T_MAIN, T_MAIN)}")
                check(rec["run"]["device"] == want_dev,
                      f"{name}: kernels on {rec['run']['device']}, expected "
                      f"{want_dev}")
                if "adaptive" in rec:
                    a = rec["adaptive"]
                    n = sum(a["rounds"])
                    check(tuple(a["result"]) == (skew["sha256"],
                                                 skew["count"],
                                                 skew["committed"])
                          and a["rounds"] == skew["rounds"]
                          and a["state_sha"] == skew["state_sha"]
                          and a["dropped"] == 0,
                          f"{name}/adaptive: differs from the unmeshed "
                          "adaptive/skew run")
                    check(tuple(a["launches"]) == (2 * n, n),
                          f"{name}/adaptive: launches {a['launches']}, "
                          f"expected {(2 * n, n)}")
                if "pipeline" in rec:
                    p = rec["pipeline"]
                    check(tuple(p["result"]) == (pipe["sha256"], pipe["count"],
                                                 pipe["committed"])
                          and p["tree_sha"] == pipe["tree_sha"]
                          and tuple(p["drains"]) == tuple(pipe["drains"])
                          and p["ticks"] == pipe["ticks"],
                          f"{name}/pipeline: differs from the unmeshed "
                          "pipeline run")
                    check(p["report"]["moved"] == 0
                          and tuple(p["report"]["removed"]) == (G - 1,)
                          and p["sealed"][0] == p["sealed"][1]
                          and p["dropped"] == 0 and not p["overflowed"],
                          f"{name}/pipeline: flip {p['report']}, sealed "
                          f"{p['sealed']}, dropped {p['dropped']}")
                    check(tuple(p["launches"]) == (2 * p["ticks"],
                                                    p["ticks"]),
                          f"{name}/pipeline: launches {p['launches']}")
            out[tag] = ranks
            log(phase=f"mesh/{tag}", seconds=seconds, ranks=[dict(
                rank=rec["rank"], mesh=rec["mesh"],
                **{path: {k: rec[path][k] for k in (
                    "launches", "seconds", "wall_seconds")}
                   for path in ("run", "tick", "adaptive", "pipeline")
                   if path in rec},
                run_ticks_per_s=rec["run"]["ticks_per_s"],
                timing=rec.get("timing")) for rec in ranks])
    log(phase="mesh/seconds", seconds=time.perf_counter() - start)
    return out


# -- model serving path -------------------------------------------------------

# (arch, the kernel its prefill runs on every layer in bf16, and in f32)
SERVE_ARCHS = (("yi-6b", "flash_attention", "flash_attention_f32"),
               ("rwkv6-3b", "wkv6_chunked", "wkv6_chunked"))
# each kernel's symbol, as torch.profiler names its launches (for WKV6 the
# prefix of its three passes' names, which no flash symbol shares), and the
# CUDA kernels one call of the wrapper launches
SYMBOLS = {"flash_attention": "flash_bf16_kernel",
           "flash_attention_f32": "flash_f32_kernel",
           "wkv6_chunked": "wkv6_"}
WKV_PHASES = ("wkv6_chunk_state_kernel", "wkv6_state_scan_kernel",
              "wkv6_output_kernel")
# the WKV6 backward's four CUDA kernels, whose names share WKV_BWD_PREFIX
# (which no forward name holds, nor they a forward one)
WKV_BWD_PHASES = ("wkv6bwd_adjoint_kernel", "wkv6bwd_scan_kernel",
                  "wkv6bwd_grad_kernel", "wkv6bwd_du_kernel")
WKV_BWD_PREFIX = "wkv6bwd_"
EVENTS_PER_CALL = {"flash_attention": 1, "flash_attention_f32": 1,
                   "wkv6_chunked": len(WKV_PHASES)}
SERVE_B, SERVE_P, SERVE_NEW = 4, 1024, 32
# serve/yi-6b and serve/rwkv6-3b: full width and depth (their decode
# steps run as one captured CUDA graph each through launch.serve.generate)
SERVE_LAYERS = 32
F32_LAYERS = 2
CPU_B, CPU_P, CPU_STEPS = 2, 256, 8
# kernel vs plain version on the same inputs. Flash: the tolerances of
# tests/test_kernels.py (f32: f32 arithmetic in both; bf16: the output's
# rounding and the kernel's P rounded to bf16 before P.V).
# WKV6: both sides compute in f32 from the same values, so f32
# reassociation only, relative to the output's size.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WKV_TOL = 1e-5              # × (max |plain| + 1)
# prefill vs teacher-forced decode logits. bf16: the two paths round
# different partial sums (one batched GEMM against B GEMVs) through 32
# random-weight layers; the rounding noise this leaves in the logits
# (measured against the f32 forward of the same weights) is as large as
# the top-2 gaps, so neither the logits nor the greedy tokens of the two
# bf16 paths can be held to each other tighter than that noise. Each bf16
# path is held against the f32 forward instead: neither may be more than
# BF16_PATH_RATIO times further from it than the other (one bf16
# arithmetic, no path worse). The exact check is in f32 at SERVE_LAYERS:
# prefill and teacher-forced decode over an F32_P-token prompt within
# F32_LOGIT_TOL, greedy tokens equal. f32 and CPU-vs-card: f32 rounding.
BF16_PATH_RATIO = 2.0
F32_P = 160                 # > 128: the reference's NaN region for rwkv6
F32_LOGIT_TOL = 1e-3
CPU_LOGIT_TOL = 1e-4
BF16, F32 = torch.bfloat16, torch.float32
# (B, Sq, Skv, H, K, h, hv, causal, window, dtype[, misaligned]): with
# "misaligned", q, k and v start 4 bytes past a 16-byte boundary (the f32
# kernel's 4-byte copy path)
FLASH_CASES = [
    (4, 1024, 1024, 32, 4, 128, 128, True, -1, BF16),   # yi-6b prefill
    (4, 1024, 1024, 32, 4, 128, 128, True, -1, F32),    # serve/f32
    *[(2, S, S, H, K, h, hv, True, w, dt) for dt in (F32, BF16)
      for (S, H, K, h, hv, w) in ((128, 4, 4, 32, 32, -1),
                                  (256, 8, 4, 64, 64, -1),
                                  (256, 8, 4, 64, 64, 100),
                                  (128, 4, 2, 48, 32, -1))],  # test_kernels
    (2, 512, 512, 8, 4, 64, 64, True, 100, BF16),       # sliding window
    (2, 128, 128, 4, 2, 32, 32, False, -1, F32),        # non-causal
    (2, 128, 128, 4, 2, 32, 32, False, 40, F32),        # non-causal window
    (2, 100, 130, 4, 2, 64, 48, True, -1, F32),         # ragged, hv != h
    (2, 130, 100, 4, 4, 32, 32, True, -1, F32),         # Sq > Skv
    (2, 77, 77, 4, 2, 64, 64, True, 30, F32),           # ragged window
    (2, 200, 300, 4, 2, 50, 36, True, -1, F32),         # h, hv % 4 != 0
    (2, 256, 256, 8, 2, 128, 128, True, -1, F32, "misaligned"),
    (2, 100, 130, 4, 2, 64, 48, True, 40, F32, "misaligned"),
    (1, 2048, 2048, 8, 2, 128, 128, False, -1, F32),    # non-causal, long
    (3, 1000, 1000, 8, 2, 128, 128, True, -1, BF16),    # ragged, long
    (2, 128, 128, 4, 2, 32, 32, False, -1, BF16),       # non-causal
    (2, 128, 128, 4, 2, 32, 32, False, 40, BF16),       # non-causal window
    (2, 100, 130, 4, 2, 64, 48, True, -1, BF16),        # ragged, hv != h
    (2, 130, 100, 4, 4, 32, 32, True, -1, BF16),        # Sq > Skv
    (2, 77, 77, 4, 2, 64, 64, True, 30, BF16),          # ragged window
    (2, 256, 256, 16, 2, 128, 128, True, -1, BF16),     # G = 8
    (2, 1024, 1024, 40, 8, 128, 128, True, -1, BF16),   # train/smr, G = 5
    (4, 1024, 1024, 40, 8, 128, 128, True, -1, BF16),   # llama4 prefill, G=5
    (1, 4096, 4096, 40, 8, 128, 128, True, -1, BF16),   # its microbatch
    (1, 256, 256, 40, 8, 128, 128, True, -1, F32),      # its f32 checks
    (4, 1024, 1024, 28, 4, 128, 128, True, -1, BF16),   # qwen2-vl, G = 7
    (1, 4096, 4096, 28, 4, 128, 128, True, -1, BF16),   # its microbatch
    (4, 192, 192, 28, 4, 128, 128, True, -1, F32),      # its f32 check
    (4, 1152, 1152, 25, 5, 64, 64, True, 1024, BF16),   # hymba prefill
    (4, 1152, 1152, 25, 5, 64, 64, True, -1, BF16),     # its global layers
    (1, 4224, 4224, 25, 5, 64, 64, True, 1024, BF16),   # its microbatch
    (1, 1228, 1228, 25, 5, 64, 64, True, 1024, F32),    # its f32 check
    (4, 1500, 1500, 12, 12, 64, 64, False, -1, BF16),   # whisper encoder
    (4, 1024, 1500, 12, 12, 64, 64, False, -1, BF16),   # its cross, serving
    (4, 1024, 1024, 12, 12, 64, 64, True, -1, BF16),    # its decoder
    (2, 4096, 1500, 12, 12, 64, 64, False, -1, BF16),   # its cross, train
    (2, 4096, 4096, 12, 12, 64, 64, True, -1, BF16),    # its train decoder
    (2, 1500, 1500, 12, 12, 64, 64, False, -1, BF16),   # its train encoder
    (1, 1500, 1500, 12, 12, 64, 64, False, -1, F32),    # its f32 checks
    (1, 256, 1500, 12, 12, 64, 64, False, -1, F32),
    (1, 256, 256, 12, 12, 64, 64, True, -1, F32),
    # q/k width 192 with v width 128: deepseek-v3's MLA prefill (the rope
    # key folded into each head, G = 1), and a padded q/k width under 192
    (4, 1024, 1024, 128, 128, 192, 128, True, -1, BF16),  # MLA serve
    (1, 4096, 4096, 128, 128, 192, 128, True, -1, BF16),  # its microbatch
    (1, 256, 256, 128, 128, 192, 128, True, -1, F32),     # its f32 check
    *[(2, 100, 130, 4, 2, 192, 128, True, -1, dt)         # ragged, G = 2
      for dt in (BF16, F32)],
    *[(2, 256, 300, 8, 4, h, hv, causal, w, dt)           # masks, Sq < Skv
      for dt in (BF16, F32)
      for (h, hv, causal, w) in ((192, 128, True, 100),
                                 (176, 96, False, -1))],
    (2, 100, 130, 4, 2, 190, 126, True, -1, F32, "misaligned"),
]
# above this many bytes of f32 scores the plain versions run over groups
# of kv heads (the MLA microbatch: 128 heads x 4,096^2 is 8.6 GB a tensor)
PLAIN_SCORE_BYTES = 4_000_000_000
WKV_CASES = [  # (B, S, H, hd, dtype, std of the raw decay)
    (4, 1024, 40, 64, BF16, 0.3),                       # rwkv6-3b prefill
    (4, 1024, 40, 64, F32, 0.3),                        # serve/f32
    *[(2, S, H, hd, dt, 1.0) for dt in (F32, BF16)
      for (S, H, hd) in ((64, 2, 32), (128, 4, 64), (64, 1, 128))],
    (2, 256, 4, 64, F32, 0.3),     # the reference's overflow range
    (2, 300, 4, 64, F32, 3.0),     # ragged S, steep decay
    (1, 37, 2, 32, F32, 1.0),      # ragged, shorter than a chunk
    (1, 4096, 8, 64, BF16, 1.0),   # 128 chunks: the scan's longest run
    (2, 1, 2, 32, F32, 1.0),       # one token
    (2, 31, 2, 64, F32, 1.0),      # one chunk less a token
    (2, 33, 2, 64, BF16, 1.0),     # one chunk and a token
    (1, 512, 4, 128, BF16, 1.0),   # the widest head the kernel takes
]


def model_kernel_modules():
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import rwkv6_scan as kw
    return kf, kw


def model_counts() -> dict:
    kf, kw = model_kernel_modules()
    return {"flash_attention": kf.KERNEL_BF16.launches,
            "flash_attention_f32": kf.KERNEL.launches,
            "flash_attention_bwd": kf.KERNEL_BWD_BF16.launches,
            "flash_attention_bwd_f32": kf.KERNEL_BWD.launches,
            "wkv6_chunked": kw.KERNEL.launches,
            "wkv6_chunked_bwd": kw.KERNEL_BWD.launches}


def randn(gen, shape, dev, dtype=F32, scale=1.0) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def wkv_inputs(gen, B, S, H, hd, dtype, w_std, dev):
    """r/k/v standard normal in ``dtype``; wlog = -softplus(N(0, w_std))
    - 1e-4 in f32, as the model's ``_decay_log``; u = N(0, 0.1)."""
    r, k, v = (randn(gen, (B, S, H, hd), dev, dtype) for _ in range(3))
    wlog = -torch.nn.functional.softplus(
        randn(gen, (B, S, H, hd), dev, scale=w_std)) - 1e-4
    return r, k, v, wlog, randn(gen, (H, hd), dev, scale=0.1)


def head_groups(q, k) -> list:
    """(query-head slice, kv-head slice) pairs that split attention over
    kv heads with their query heads, each group's f32 scores at most
    PLAIN_SCORE_BYTES; one pair where the whole fits."""
    B, Sq, H, _ = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    per_kv = 4 * B * G * Sq * Skv
    step = max(1, min(K, PLAIN_SCORE_BYTES // per_kv))
    return [(slice(k0 * G, min(K, k0 + step) * G),
             slice(k0, min(K, k0 + step))) for k0 in range(0, K, step)]


def plain_flash(q, k, v, **mask) -> torch.Tensor:
    """``flash_attention_plain`` over :func:`head_groups`."""
    kf, _ = model_kernel_modules()
    return torch.cat([kf.flash_attention_plain(q[:, :, a], k[:, :, b],
                                               v[:, :, b], **mask)
                      for a, b in head_groups(q, k)], dim=2)


def plain_lse(q, k, **mask) -> torch.Tensor:
    """``flash_attention_lse_plain`` over :func:`head_groups`."""
    kf, _ = model_kernel_modules()
    return torch.cat([kf.flash_attention_lse_plain(q[:, :, a], k[:, :, b],
                                                   **mask)
                      for a, b in head_groups(q, k)], dim=1)


def plain_bwd(q, k, v, o, do, **mask) -> tuple:
    """``flash_attention_bwd_plain`` over :func:`head_groups`."""
    kf, _ = model_kernel_modules()
    parts = [kf.flash_attention_bwd_plain(q[:, :, a], k[:, :, b], v[:, :, b],
                                          o[:, :, a], do[:, :, a], **mask)
             for a, b in head_groups(q, k)]
    return tuple(torch.cat(x, dim=2) for x in zip(*parts))


def model_kernel_phase(dev) -> dict:
    """Both model kernels against their plain versions on the card;
    returns the worst absolute error per kernel. Any miss of a stated
    tolerance fails the run."""
    from repro_torch.kernels import ref
    kf, kw = model_kernel_modules()
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    worst = {"flash_attention": 0.0, "flash_attention_f32": 0.0,
             "wkv6_chunked": 0.0}
    cases = []
    for (B, Sq, Skv, H, K, h, hv, causal, window, dt, *how) in FLASH_CASES:
        q = randn(gen, (B, Sq, H, h), dev, dt)
        k = randn(gen, (B, Skv, K, h), dev, dt)
        v = randn(gen, (B, Skv, K, hv), dev, dt)
        if how:
            q, k, v = misaligned(q), misaligned(k), misaligned(v)
        name = "flash_attention" if dt == BF16 else "flash_attention_f32"
        before = model_counts()
        got = kf.flash_attention(q, k, v, causal=causal, window=window)
        launched = {n: c - before[n] for n, c in model_counts().items()}
        want = plain_flash(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        case = [B, Sq, Skv, H, K, h, hv, causal, window, str(dt), *how]
        check(launched == {**dict.fromkeys(launched, 0), name: 1},
              f"flash_attention {case} launched {launched}, expected one "
              f"{name}")
        check(got.dtype == dt and got.shape == want.shape,
              f"flash: output {got.dtype}{tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        check(err <= FLASH_TOL[dt], f"flash_attention {case}: max abs err "
              f"{err} > {FLASH_TOL[dt]}")
        worst[name] = max(worst[name], err)
        extra = {}
        if dt == F32:    # (padded width, 16-byte copies) of the f32 kernel
            extra["plan"] = kf.f32_plan(h, hv, q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), got.data_ptr())
        cases.append(dict(kernel=name, case=case, err=err,
                          tol=FLASH_TOL[dt], **extra))
    paths = {c["plan"][-1] for c in cases if "plan" in c}
    check(paths == {0, 1}, f"the f32 flash cases ran copy paths {paths}, "
          "not both the 16-byte and the 4-byte one")
    for (B, S, H, hd, dt, w_std) in WKV_CASES:
        r, k, v, wlog, u = wkv_inputs(gen, B, S, H, hd, dt, w_std, dev)
        before = model_counts()
        got = kw.wkv6_chunked(r, k, v, wlog, u)
        launched = {n: c - before[n] for n, c in model_counts().items()}
        want = kw.wkv6_chunked_plain(r, k, v, wlog, u, chunk=128)
        torch.cuda.synchronize()
        scale = float(want.abs().max()) + 1.0
        err = float((got - want).abs().max())
        case = [B, S, H, hd, str(dt), w_std]
        check(launched == {**dict.fromkeys(launched, 0), "wkv6_chunked": 1},
              f"wkv6_chunked {case} launched {launched}, expected one call")
        check(bool(torch.isfinite(got).all()), f"wkv6 {case}: not finite")
        check(err <= WKV_TOL * scale, f"wkv6_chunked {case}: max abs err "
              f"{err} > {WKV_TOL} x {scale}")
        extra = {}
        if S <= 512 and w_std < 1.0:
            # the reference's factorisation k * exp(-cum) over a chunk of
            # 128 overflows here; the kernel stays equal to the recurrence
            cum = torch.cumsum(wlog[:, :128], dim=1)
            extra["reference_form_overflows"] = bool(
                torch.isinf(torch.exp(-cum)).any())
            seq = ref.wkv6_ref(r, k, v, wlog, u)
            extra["err_vs_sequential"] = float((got - seq).abs().max())
            check(extra["reference_form_overflows"]
                  and extra["err_vs_sequential"] <= WKV_TOL * scale,
                  f"wkv6 {case}: {extra}")
        worst["wkv6_chunked"] = max(worst["wkv6_chunked"], err)
        cases.append(dict(kernel="wkv6_chunked", case=case, err=err,
                          tol=WKV_TOL * scale, **extra))
    log(phase="kernels/model", cases=cases, max_abs_err=worst)
    return worst


# the WKV6 backward against its plain version: the forward's cases and the
# train/rwkv6-3b microbatch, (B, S, H, hd, dtype, std of the raw decay)
WKV_BWD_CASES = [(1, 4096, 40, 64, BF16, 0.3), *WKV_CASES,
                 (1, 256, 2, 50, F32, 1.0),     # hd not a multiple of 8
                 # ending inside an 8-token leaf (17), on a half's edge (48)
                 (2, 17, 2, 32, F32, 1.0), (2, 17, 2, 128, BF16, 1.0),
                 (2, 48, 2, 128, F32, 1.0), (2, 48, 2, 32, BF16, 1.0)]
# against the plain backward at the kernel's chunk of 32, relative to (max
# |plain| + 1): f32 2e-5. Both compute in f32 from the same values, but
# each decay factor is 2^ or e^ of a difference of two cumulative log
# decays, and a chunk of the steep case sums to ~10^2: the f32 rounding
# of such a difference is ~1e-5 of the factor, in each version. dr, dk,
# dv in bf16: one bf16 ulp of the largest value (2^-7 < 8e-3), as the two
# f32 results may round to neighbouring bf16 values. dwlog and du are f32
# in both dtypes.
WKV_BWD_TOL = {F32: 2e-5, BF16: 8e-3}
WKV_GRADS = ("dr", "dk", "dv", "dwlog", "du")


def wkv_bwd_phase(dev) -> dict:
    """WKV6's autograd on the card in every case of WKV_BWD_CASES: the
    forward one launch of the forward kernel, the backward one launch of
    the backward kernel (and no other), its five gradients within
    WKV_BWD_TOL of ``wkv6_chunked_bwd_plain`` on the same inputs, finite,
    and a second backward on the same saved tensors byte-equal (no
    atomics, a fixed order). A head dim past 128 and a non-contiguous
    dout raise before any launch. Returns the worst absolute error and
    the worst error over its tolerance's scale."""
    _, kw = model_kernel_modules()
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    worst, worst_rel, cases = 0.0, 0.0, []
    for (B, S, H, hd, dt, w_std) in WKV_BWD_CASES:
        r, k, v, wlog, u = wkv_inputs(gen, B, S, H, hd, dt, w_std, dev)
        do = randn(gen, (B, S, H, hd), dev)
        xs = [x.clone().requires_grad_() for x in (r, k, v, wlog, u)]
        case = [B, S, H, hd, str(dt), w_std]
        before = model_counts()
        out = kw.wkv6_chunked(*xs)
        got = torch.autograd.grad(out, xs, do, retain_graph=True)
        launched = {n: c - before[n] for n, c in model_counts().items()}
        check(launched == {**dict.fromkeys(launched, 0), "wkv6_chunked": 1,
                           "wkv6_chunked_bwd": 1},
              f"wkv6 backward {case} launched {launched}, expected one "
              "forward and one backward")
        again = torch.autograd.grad(out, xs, do)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        check(same, f"wkv6 backward {case}: two launches differ")
        want = kw.wkv6_chunked_bwd_plain(r, k, v, wlog, u, do,
                                         chunk=kw.CHUNK)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(WKV_GRADS, got, want):
            tol = WKV_BWD_TOL[dt if name in WKV_GRADS[:3] else F32]
            scale = float(b.float().abs().max()) + 1.0
            err = float((a.float() - b.float()).abs().max())
            check(a.dtype == b.dtype and a.shape == b.shape
                  and bool(torch.isfinite(a).all())
                  and err <= tol * scale, f"wkv6 backward {case}: {name} "
                  f"{a.dtype}{tuple(a.shape)}, max abs err {err} > {tol} x "
                  f"{scale}")
            errs[name] = dict(err=err, scale=scale, tol=tol)
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / (tol * scale))
        cases.append(dict(case=case, same_bytes_twice=same, **errs))
        del r, k, v, wlog, u, do, xs, out, got, again, want
    # what the kernel does not take raises before a launch
    r = torch.zeros((1, 40, 2, 32), device=dev)
    states = torch.zeros((kw.workspace_floats(1, 40, 2, 32),), device=dev)
    wide = torch.zeros((1, 40, 2, 130), device=dev)
    raised = {}
    before = kw.KERNEL_BWD.launches
    for name, args in (
            ("hd 130", (wide, wide, wide, wide - 1,
                        torch.zeros((2, 130), device=dev), wide, states)),
            ("dout not contiguous", (r, r, r, r - 1,
                                     torch.zeros((2, 32), device=dev),
                                     r.transpose(2, 3).contiguous()
                                     .transpose(2, 3), states))):
        try:
            kw.wkv6_bwd(*args)
            raised[name] = False
        except ValueError:
            raised[name] = True
    check(all(raised.values()) and kw.KERNEL_BWD.launches == before,
          f"wkv6 backward: bad inputs raised {raised}")
    torch.cuda.empty_cache()
    log(phase="kernels/wkv6_bwd", cases=cases, max_abs_err=worst,
        worst_err_over_tol=worst_rel, bad_inputs_raised=raised)
    return dict(max_abs_err=worst, worst_err_over_tol=worst_rel)


@contextlib.contextmanager
def plain_kernels():
    """Route the model layers' kernel calls to the plain versions."""
    from repro_torch.kernels import ops
    kf, kw = model_kernel_modules()
    saved = ops.attention, ops.wkv6
    ops.attention = (lambda q, k, v, *, causal=True, window=-1:
                     kf.flash_attention_plain(q, k, v, causal=causal,
                                              window=window))
    ops.wkv6 = (lambda r, k, v, wlog, u, *, chunk=128:
                kw.wkv6_chunked_plain(r, k, v, wlog, u, chunk=chunk))
    try:
        yield
    finally:
        ops.attention, ops.wkv6 = saved


def f32_copy(lm, device=None):
    """A copy of the model with every parameter in f32 (on ``device``,
    default the model's)."""
    from repro_torch.models.transformer import LM

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [f32(v) for v in tree]
        return tree.detach().to(device, F32, copy=True)
    return LM(lm.cfg.replace(dtype=F32), f32(lm.tree()))


def f32_states(cfg, opt, dev) -> tuple[dict, dict]:
    """One set of weights for :func:`f32_step_vs_cpu`: the train state of
    ``cfg`` drawn on the card (seed SEED), and an f32 copy of its
    parameters on the CPU with a fresh optimizer state. (Drawn on the
    card: the host's generator takes seconds for a full-width
    embedding.)"""
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    card = TR.make_state(cfg, opt, torch.Generator(dev).manual_seed(SEED),
                         dev)
    params = f32_copy(card["params"], "cpu")
    return ({"params": params, "opt": O.init_opt(opt, params),
             "step": torch.zeros((), dtype=torch.int32)}, card)


def teacher_forced(lm, cfg, prompts):
    """The last prompt token's logits after ``launch.serve.generate`` fed
    the prompt through ``decode_step`` (one captured CUDA graph a step on
    the card)."""
    from repro_torch.launch import serve
    return serve.generate(lm, cfg, prompts, 1, return_logits=True)[1][:, -1]


def generate_timed(lm, cfg, prompts, new_tokens: int,
                   keep_logits: bool = True, frames=None) -> dict:
    """``launch.serve.generate`` (with every logit kept, if
    ``keep_logits``; the encoder-decoder's ``frames``), each part timed
    with CUDA events (``part_ms``: "encode" the encoder-decoder's frames
    and cross cache, "step" the capture, "meta" the hybrid family's meta
    tokens, "prompt" the teacher-forced prompt, "greedy" the greedy steps
    after the first token), and its host seconds."""
    from repro_torch.launch import serve
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    mark("start")
    t0 = time.perf_counter()
    out = serve.generate(lm, cfg, prompts, new_tokens, frames=frames,
                         return_logits=keep_logits, on_phase=mark)
    gen, logits = out if keep_logits else (out, None)
    torch.cuda.synchronize()
    return dict(gen=gen, logits=logits, seconds=time.perf_counter() - t0,
                part_ms={b[0]: a[1].elapsed_time(b[1])
                         for a, b in zip(marks, marks[1:])})


def wkv_workspace(cfg, kernel: str) -> dict:
    """The WKV6 workspace of one prefill layer (B=SERVE_B, SERVE_P
    tokens), for the rwkv6 path; nothing for the others."""
    if kernel != "wkv6_chunked":
        return {}
    H = cfg.ssm_heads or cfg.n_heads
    nbytes = 4 * model_kernel_modules()[1].workspace_floats(
        SERVE_B, SERVE_P, H, cfg.d_model // H)
    return {"wkv6_workspace_bytes": nbytes}


def serve_phase(arch: str, kernel: str, dev) -> dict:
    """The serving path at full width and SERVE_LAYERS layers in bf16:
    prefill, then ``launch.serve.generate`` (the prompt teacher-forced,
    greedy decode), checks and timing."""
    from repro_torch.configs import registry
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    full = registry.get(arch)
    cfg = full.replace(n_layers=SERVE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P), device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                SEED + 1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    # the path: counts set to 0 right before, read right after
    reset_counts()
    t0 = time.perf_counter()
    logits_p, _ = D.prefill(lm, cfg, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    after_prefill = model_counts()
    check(after_prefill[kernel] == cfg.n_layers
          and sum(after_prefill.values()) == cfg.n_layers,
          f"{arch} prefill launched {after_prefill}, expected "
          f"{cfg.n_layers} x {kernel}")
    run = generate_timed(lm, cfg, prompts, SERVE_NEW)
    check(model_counts() == after_prefill,
          f"{arch}: decode launched a model kernel: {model_counts()}")
    logits_d = run["logits"][:, SERVE_P - 1]
    check(tuple(run["gen"].shape) == (SERVE_B, SERVE_NEW)
          and tuple(run["logits"].shape) == (SERVE_B, SERVE_P + SERVE_NEW
                                             - 1, cfg.vocab)
          and bool(torch.isfinite(logits_p).all()
                   and torch.isfinite(run["logits"]).all()),
          f"{arch}: generate gave {tuple(run['gen'].shape)}, logits "
          f"{tuple(run['logits'].shape)}; prefill or decode logits are "
          "not finite")
    tok = run["gen"][:, -1:]
    part_ms = run["part_ms"]
    tf_s = part_ms["prompt"] / 1e3
    decode_ms = part_ms["greedy"] / (SERVE_NEW - 1)
    del run
    peak_path = torch.cuda.max_memory_allocated()

    # the f32 forward of the same weights (after the counted run), traced:
    # its kernel's launches and device time per call; and the f32 prefill
    # vs teacher-forced decode at the same depth
    lm32 = f32_copy(lm)
    kernel32 = next(k32 for a, _, k32 in SERVE_ARCHS if a == arch)
    forwards, before = [], model_counts()[kernel32]
    f32_us, f32_device_us = traced_kernel_us(
        lambda: forwards.append(D.prefill(lm32, lm32.cfg,
                                          {"tokens": prompts})[0]),
        kernel32, cfg.n_layers)
    launches32 = {"forward": (model_counts()[kernel32] - before)
                  // len(forwards)}
    logits_f = forwards[-1]
    del forwards
    short = prompts[:, :F32_P]
    before = model_counts()[kernel32]
    f32_prefill, _ = D.prefill(lm32, lm32.cfg, {"tokens": short})
    launches32["prefill_short"] = model_counts()[kernel32] - before
    check(launches32 == {"forward": cfg.n_layers,
                         "prefill_short": cfg.n_layers},
          f"{arch}: the f32 forward launched {launches32} x {kernel32}")
    log(phase=f"serve/{arch}/f32_forward", kernel=kernel32,
        launches=launches32, shapes={"forward": [SERVE_B, SERVE_P],
                                     "prefill_short": [SERVE_B, F32_P]},
        device_us_per_call=f32_us, forward_device_ms=f32_device_us / 1e3)
    f32_decode = teacher_forced(lm32, lm32.cfg, short)
    del lm32
    torch.cuda.empty_cache()
    f32_err = float((f32_prefill - f32_decode).abs().max())
    check(f32_err <= F32_LOGIT_TOL and torch.equal(
        f32_prefill.argmax(-1), f32_decode.argmax(-1)),
        f"{arch}: f32 at {cfg.n_layers} layers, prefill vs teacher-forced "
        f"decode over "
        f"{F32_P} tokens: max abs err {f32_err}, greedy "
        f"{f32_prefill.argmax(-1).tolist()} vs "
        f"{f32_decode.argmax(-1).tolist()}")
    lp, ld, lf = logits_p.float(), logits_d.float(), logits_f

    def rms(x):
        return float(x.square().mean().sqrt())
    agree = dict(prefill_vs_decode=float((lp - ld).abs().max()),
                 prefill_vs_f32=float((lp - lf).abs().max()),
                 decode_vs_f32=float((ld - lf).abs().max()),
                 rms_prefill_vs_decode=rms(lp - ld),
                 rms_prefill_vs_f32=rms(lp - lf),
                 rms_decode_vs_f32=rms(ld - lf), rms_f32_logits=rms(lf),
                 max_abs_f32_logit=float(lf.abs().max()),
                 f32_full_depth_prefill_vs_decode=f32_err)
    tokens = {name: x.argmax(-1).tolist()
              for name, x in (("prefill", lp), ("decode", ld), ("f32", lf))}
    top2 = lf.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).tolist()
    log(phase=f"serve/{arch}/agreement", **agree, greedy_tokens=tokens,
        f32_top2_gap=gap)
    a, b = agree["prefill_vs_f32"], agree["decode_vs_f32"]
    check(max(a, b) <= BF16_PATH_RATIO * min(a, b),
          f"{arch}: one bf16 path is further from the f32 forward than "
          f"the other: {agree}")

    prefill_ms = time_cuda(lambda: D.prefill(lm, cfg, {"tokens": prompts}),
                           reps=3, warmup=1)
    symbol, per_call = SYMBOLS[kernel], EVENTS_PER_CALL[kernel]
    prof = device_kernels(lambda: D.prefill(lm, cfg, {"tokens": prompts}), 1,
                          symbol, cfg.n_layers * per_call)
    mine = [us for name, us in prof if symbol in name]
    others = [name for name, _ in prof
              if any(s in name for s in SYMBOLS.values() if s != symbol)]
    check(len(mine) == cfg.n_layers * per_call and not others,
          f"{arch}: profiler saw {len(mine)} {symbol} events in one "
          f"prefill ({cfg.n_layers} x {per_call} expected), and "
          f"{len(others)} of the other model kernels")
    phase_us = ({p: sum(us for name, us in prof if p in name) / cfg.n_layers
                 for p in WKV_PHASES} if kernel == "wkv6_chunked" else {})
    check(all(phase_us.values()), f"{arch}: a WKV6 pass is missing from "
          f"the profile: {phase_us}")
    dev_us = sum(us for _, us in prof)
    # one decode step's kernels, eagerly (the captured graph replays the
    # same kernels), on a cache of the generate run's length
    cache = D.cache_zeros(D.cache_spec(cfg, SERVE_B, SERVE_P + SERVE_NEW + 4),
                          dev)
    steps = 4
    t0 = time.perf_counter()
    prof_d = device_kernels(lambda: D.decode_step(
        lm, cfg, {"token": tok, "index": SERVE_P + SERVE_NEW}, cache), steps,
        want=1)
    decode_wall_us = (time.perf_counter() - t0) * 1e6 / steps
    res = dict(arch=arch, params=n_params, layers=cfg.n_layers,
               cuts={"layers": [full.n_layers, cfg.n_layers]},
               batch=SERVE_B, prompt=SERVE_P,
               new_tokens=SERVE_NEW, init_seconds=init_s,
               prefill_first_seconds=prefill_first_s,
               launches={kernel: after_prefill[kernel]},
               **agree, greedy_tokens=tokens, f32_top2_gap=gap,
               teacher_forced_seconds=tf_s,
               teacher_forced_tokens_per_s=SERVE_B * SERVE_P / tf_s,
               generate_part_ms=part_ms,
               prefill_ms=prefill_ms,
               prefill_tokens_per_s=SERVE_B * SERVE_P / (prefill_ms / 1e3),
               decode_ms_per_step=decode_ms,
               decode_tokens_per_s=SERVE_B / (decode_ms / 1e3),
               prefill_kernel_us=sum(mine) / cfg.n_layers,
               f32_forward_launches=launches32,
               f32_forward_kernel_us=f32_us,
               f32_forward_device_ms=f32_device_us / 1e3,
               prefill_kernel_phase_us=phase_us,
               prefill_kernel_share=sum(mine) / dev_us,
               prefill_device_ms=dev_us / 1e3,
               prefill_device_busy_share=dev_us / 1e3 / prefill_ms,
               decode_kernels_per_step=len(prof_d) / steps,
               decode_device_us_per_step=sum(us for _, us in prof_d) / steps,
               decode_profiled_wall_us_per_step=decode_wall_us,
               peak_mem_bytes=peak_path,
               **wkv_workspace(cfg, kernel),
               peak_mem_bytes_with_timing=torch.cuda.max_memory_allocated())
    log(phase=f"serve/{arch}", **res)
    del lm, cache
    torch.cuda.empty_cache()
    return res


def traced_kernel_us(fn, kernel: str, calls: int) -> tuple[float, float]:
    """``torch.profiler`` device time, in microseconds, of one call of
    ``kernel`` (all its CUDA kernels, mean) in one run of ``fn``, which
    launches it ``calls`` times, and of the whole run
    (:func:`device_kernels`: traced behind the lead-in, again if the
    profiler lost some)."""
    symbol, per_call = SYMBOLS[kernel], EVENTS_PER_CALL[kernel]
    events = device_kernels(fn, 1, symbol, calls * per_call)
    mine = [us for name, us in events if symbol in name]
    check(len(mine) == calls * per_call,
          f"profiler saw {len(mine)} {symbol} events, expected "
          f"{calls} x {per_call}")
    return sum(mine) / calls, sum(us for _, us in events)


def serve_f32_phase(dev) -> dict:
    """Full width, F32_LAYERS layers, f32: prefill with the kernels,
    prefill with the plain versions, and the teacher-forced decode."""
    from repro_torch.configs import registry
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not run in TF32")
    out = {}
    for arch, _, kernel in SERVE_ARCHS:
        cfg = registry.get(arch).replace(n_layers=F32_LAYERS, dtype=F32)
        lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
        prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P),
                                device=dev,
                                generator=torch.Generator(dev).manual_seed(
                                    SEED + 1))
        reset_counts()
        with_kernel, _ = D.prefill(lm, cfg, {"tokens": prompts})
        counts = model_counts()
        with plain_kernels():
            plain, _ = D.prefill(lm, cfg, {"tokens": prompts})
        torch.cuda.synchronize()
        check(model_counts() == counts and counts[kernel] == F32_LAYERS
              and sum(counts.values()) == F32_LAYERS,
              f"serve/f32 {arch}: launches {counts} then {model_counts()}")
        kernel_us, _ = traced_kernel_us(
            lambda: D.prefill(lm, cfg, {"tokens": prompts}), kernel,
            F32_LAYERS)
        decoded = teacher_forced(lm, cfg, prompts)
        errs = dict(kernel_vs_plain=float((with_kernel - plain).abs().max()),
                    kernel_vs_decode=float((with_kernel - decoded)
                                           .abs().max()))
        same_tokens = bool(torch.equal(with_kernel.argmax(-1),
                                       plain.argmax(-1))
                           and torch.equal(with_kernel.argmax(-1),
                                           decoded.argmax(-1)))
        check(all(e <= F32_LOGIT_TOL for e in errs.values())
              and same_tokens and bool(torch.isfinite(with_kernel).all()),
              f"serve/f32 {arch}: {errs}, same greedy tokens {same_tokens}")
        out[arch] = dict(errs, logits_max_abs=float(with_kernel.abs().max()),
                         tolerance=F32_LOGIT_TOL, launches=counts[kernel],
                         kernel_device_us_per_call=kernel_us)
        del lm
        torch.cuda.empty_cache()
    log(phase="serve/f32", layers=F32_LAYERS, batch=SERVE_B, prompt=SERVE_P,
        **out)
    return out


def serve_cpu_phase(dev) -> dict:
    """The smoke configs in f32 on one set of weights (drawn on the CPU
    from seed 0, carried to the card through numpy): prefill and
    CPU_STEPS decode steps on the CPU and on the card."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    out = {}
    for arch, *_ in SERVE_ARCHS:
        cfg = registry.get_smoke(arch).replace(dtype=F32)
        lm_cpu = T.init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
        lm_dev = convert.lm_params_from_jax(
            convert.lm_params_to_numpy(lm_cpu), cfg, dev)
        toks = np.random.default_rng(SEED + 4).integers(
            0, cfg.vocab, (CPU_B, CPU_P))
        errs = []
        for lm, d in ((lm_cpu, "cpu"), (lm_dev, dev)):
            prompts = torch.from_numpy(toks).to(d)
            logits, _ = D.prefill(lm, cfg, {"tokens": prompts})
            cache = D.cache_zeros(D.cache_spec(cfg, CPU_B, CPU_STEPS), d)
            steps = [D.decode_step(lm, cfg, {"token": prompts[:, t:t + 1],
                                             "index": t}, cache)[0]
                     for t in range(CPU_STEPS)]
            errs.append(torch.stack([logits, *steps]).cpu())
        err = float((errs[0] - errs[1]).abs().max())
        check(err <= CPU_LOGIT_TOL and bool(torch.isfinite(errs[1]).all()),
              f"serve/cpu {arch}: card vs CPU max abs err {err}")
        out[arch] = dict(max_abs_err=err, tolerance=CPU_LOGIT_TOL)
    log(phase="serve/cpu", batch=CPU_B, prompt=CPU_P, decode_steps=CPU_STEPS,
        **out)
    return out


def serve_cli(dev) -> None:
    """``python -m repro_torch.launch.serve`` at smoke size, on the card
    by default (no --device)."""
    from repro_torch.launch import serve
    for arch, *_ in SERVE_ARCHS:
        serve.main(["--arch", arch, "--prompt-len", "16", "--new-tokens",
                    "8"])


def attention_bound(B, Sq, Skv, H, K, h, hv, itemsize,
                    backward=False, window=-1, causal=True) -> dict:
    """Causal attention with Sq = Skv: the visible (query, key) pairs
    (i - w < j <= i with a window w > 0) need 2 h + 2 hv flops each (S =
    Q K^T, P V), at the bf16 tensor-core rate (itemsize 2) or the f32
    rate of the CUDA cores (itemsize 4); q, k, v read once and the output
    written once. ``causal=False`` (no window): every one of the Sq x Skv
    pairs is visible. ``backward``: the five products S, dP = dO V^T,
    dV = P^T dO, dQ = dS K and dK = dS^T Q, 6 h + 4 hv flops a pair; q,
    k, v, o and do read once, dq, dk and dv written once."""
    w = min(window, Sq) if window > 0 else Sq
    pairs = B * H * (w * (w + 1) // 2 + (Sq - w) * w) if causal else \
        B * H * Sq * Skv
    flops = pairs * ((6 * h + 4 * hv) if backward else 2 * (h + hv))
    elems = (B * Sq * H * h + B * Skv * K * (h + hv) + B * Sq * H * hv)
    nbytes = itemsize * elems * (2 if backward else 1)
    rate = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def wkv_bound(B, S, H, hd, itemsize) -> dict:
    """The recurrence needs 2 FMAs per state element per token (decay and
    add k v; read out r S) = 4 hd^2 flops per token and head, counted at
    the bf16 tensor-core rate; r/k/v read in their type, wlog and u in
    f32, the f32 output written once."""
    n = B * S * H * hd
    flops = 4 * B * S * H * hd * hd
    nbytes = 3 * itemsize * n + 4 * n + 4 * H * hd + 4 * n
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def wkv_bwd_bound(B, S, H, hd, itemsize) -> dict:
    """The recurrence's gradient needs, per state element per token, 6
    FMAs (decay the state's gradient and add r do; read out dr from the
    state, dk and dv from the state's gradient, dwlog from their product)
    = 12 hd^2 flops per token and head, counted at the bf16 tensor-core
    rate; read once: r/k/v in their type, wlog, do and u in f32; written
    once: dr/dk/dv in their type, dwlog and du in f32. The forward's saved
    chunk states (f32 [W, W], W the padded head width, for every chunk
    but the first), which this kernel reads in place of a recompute, are
    its design's cost and not the function's: ``state_bytes`` reports
    them, outside the bound."""
    _, kw = model_kernel_modules()
    n, w = B * S * H * hd, kw.padded_width(hd)
    states = 4 * B * H * max(-(-S // kw.CHUNK) - 1, 0) * w * w
    flops = 12 * B * S * H * hd * hd
    nbytes = (3 * itemsize * n + 8 * n + 4 * H * hd
              + 3 * itemsize * n + 4 * n + 4 * H * hd)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(flops=flops, bytes=nbytes, state_bytes=states,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def time_model_kernels(dev) -> dict:
    """Each model kernel at its serving-path shape (B=4, S=1024; flash in
    bf16 and in f32, WKV6 in bf16): per call (CUDA events over back-to-back
    calls, each far longer than its launch, so the card never waits on the
    host), the plain version, and for flash one
    ``scaled_dot_product_attention`` call on the same inputs; with the
    bound. The kernels' device times come from the serving phases'
    ``torch.profiler`` pass over a whole prefill."""
    import torch.nn.functional as F
    kf, kw = model_kernel_modules()
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    rows = {}
    B, S, H, K, h = SERVE_B, SERVE_P, 32, 4, 128
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    for name, dt in (("flash_attention", BF16), ("flash_attention_f32", F32)):
        q = randn(gen, (B, S, H, h), dev, dt)
        k = randn(gen, (B, S, K, h), dev, dt)
        v = randn(gen, (B, S, K, h), dev, dt)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if not gqa:      # no enable_gqa: k/v expanded over the group first
            kt, vt = (x.repeat_interleave(H // K, dim=1) for x in (kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, **({"enable_gqa": True} if gqa
                                               else {}))
        plain = kf.flash_attention_plain(q, k, v).float()
        lib_err = float((sdpa().transpose(1, 2).float() - plain).abs().max())
        if dt == BF16:
            check(lib_err <= FLASH_TOL[BF16], f"sdpa disagrees: {lib_err}")
        del plain
        before = model_counts()
        ms = time_cuda(lambda: kf.flash_attention(q, k, v), reps=20,
                       warmup=3)
        check(model_counts()[name] - before[name] == 23,
              f"{name}: timed calls did not launch its kernel")
        rows[name] = dict(
            shape=[B, S, H, K, h], dtype=str(dt).replace("torch.", ""),
            ms=ms,
            plain_ms=time_cuda(lambda: kf.flash_attention_plain(q, k, v),
                               reps=5, warmup=1),
            library_ms=time_cuda(sdpa, reps=20, warmup=3),
            library="torch.nn.functional.scaled_dot_product_attention"
                    "(is_causal=True" + (", enable_gqa=True)" if gqa
                                         else ") on k/v expanded over G"),
            library_vs_plain_err=lib_err,
            **attention_bound(B, S, S, H, K, h, h, dt.itemsize))
        rows[name]["tflops_per_s"] = rows[name]["flops"] / (ms * 1e9)
        rows[name]["device_us"], _ = traced_kernel_us(
            lambda: [kf.flash_attention(q, k, v) for _ in range(5)], name, 5)
        log(phase="timing/model_kernel", name=name, **rows[name])
        del q, k, v, qt, kt, vt
    B, S, H, hd = SERVE_B, SERVE_P, 40, 64
    r, kk, vv, wlog, u = wkv_inputs(gen, B, S, H, hd, BF16, 0.3, dev)
    calls = 5
    prof = device_kernels(lambda: kw.wkv6_chunked(r, kk, vv, wlog, u), calls,
                          SYMBOLS["wkv6_chunked"], calls * len(WKV_PHASES))
    phase_us = {p: sum(us for name, us in prof if p in name) / calls
                for p in WKV_PHASES}
    check(sum(SYMBOLS["wkv6_chunked"] in name for name, _ in prof)
          == calls * len(WKV_PHASES) and all(phase_us.values()),
          f"wkv6_chunked: profiler saw {phase_us} over {calls} calls")
    rows["wkv6_chunked"] = dict(
        shape=[B, S, H, hd], dtype="bfloat16",
        ms=time_cuda(lambda: kw.wkv6_chunked(r, kk, vv, wlog, u), reps=20,
                     warmup=3),
        plain_ms=time_cuda(lambda: kw.wkv6_chunked_plain(r, kk, vv, wlog, u),
                           reps=3, warmup=1),
        library_ms=None,
        library="none: no single PyTorch call computes the WKV6 recurrence",
        device_us=sum(phase_us.values()), phase_device_us=phase_us,
        workspace_bytes=4 * kw.workspace_floats(B, S, H, hd),
        **wkv_bound(B, S, H, hd, 2))
    log(phase="timing/model_kernel", name="wkv6_chunked",
        **rows["wkv6_chunked"])
    del r, kk, vv, wlog, u
    rows["wkv6_chunked_bwd"] = time_wkv_bwd(dev, gen)
    return rows


def time_wkv_bwd(dev, gen) -> dict:
    """The WKV6 backward at the rwkv6-3b train microbatch [1, 4096, 40, 64]
    in bf16: per call (CUDA events over back-to-back calls of
    ``wkv6_bwd`` on one forward's saved states), each pass's device time
    (``torch.profiler``), the plain backward, the bound, and each pass's
    registers, spills, shared memory and blocks per SM at hd 64."""
    _, kw = model_kernel_modules()
    B, S, H, hd = 1, TRAIN_S, 40, 64
    r, kk, vv, wlog, u = wkv_inputs(gen, B, S, H, hd, BF16, 0.3, dev)
    do = randn(gen, (B, S, H, hd), dev)
    _, states = kw.wkv6_fwd(r, kk, vv, wlog, u)

    def bwd():
        return kw.wkv6_bwd(r, kk, vv, wlog, u, do, states)
    before = kw.KERNEL_BWD.launches
    ms = time_cuda(bwd, reps=20, warmup=3)
    check(kw.KERNEL_BWD.launches - before == 23,
          "wkv6_chunked_bwd: timed calls did not launch it")
    calls = 5
    prof = device_kernels(bwd, calls, WKV_BWD_PREFIX,
                          calls * len(WKV_BWD_PHASES))
    phase_us = {p: sum(us for name, us in prof if p in name) / calls
                for p in WKV_BWD_PHASES}
    check(sum(WKV_BWD_PREFIX in name for name, _ in prof)
          == calls * len(WKV_BWD_PHASES) and all(phase_us.values()),
          f"wkv6_chunked_bwd: profiler saw {phase_us} over {calls} calls")
    info = wkv_bwd_info()
    row = dict(
        shape=[B, S, H, hd], dtype="bfloat16", ms=ms,
        plain_ms=time_cuda(lambda: kw.wkv6_chunked_bwd_plain(
            r, kk, vv, wlog, u, do), reps=2, warmup=1),
        library_ms=None,
        library="none: no single PyTorch call computes the WKV6 gradient",
        device_us=sum(phase_us.values()), phase_device_us=phase_us,
        workspace_bytes=4 * kw.bwd_workspace_floats(B, S, H, hd),
        kernel_info={p: info[f"{p}/hd64"] for p in WKV_BWD_PHASES},
        **wkv_bwd_bound(B, S, H, hd, 2))
    row["over_bound"] = ms / row["bound_ms"]
    log(phase="timing/model_kernel", name="wkv6_chunked_bwd", **row)
    return row


# -- the training path ---------------------------------------------------------

TRAIN_ARCH = "yi-6b"
# the reference's train_4k cell (seq 4096, global batch 256) with the batch
# cut to 2 for one card's memory and the run's time limit; its
# microbatches (2) from configs/yi_6b.py; Adafactor, as the reference's
# --full picks it (choose_optimizer(1e12))
TRAIN_B, TRAIN_S = 2, 4096
TRAIN_STEPS = 4               # 1 warm-up + 3 timed, each one STEP command
TRAIN_LR = 1e-4
F32_TRAIN_LAYERS, F32_TRAIN_B, F32_TRAIN_S = 2, 1, 256
CKPT_B, CKPT_S = 2, 512       # the 2-layer checkpoint round trip
# the f32 step, card vs CPU, from one set of weights: f32 rounding in
# another summation order through 2 layers (cuBLAS against the host's
# BLAS): loss 1e-5 and grad_norm 1e-4 relative, each gradient leaf 1e-3
# of its largest magnitude; parameters after the AdamW step within
# 2 lr + 1e-6 (its first step is lr sign(g), which a near-zero gradient
# may flip)
F32_STEP_TOL = dict(loss=1e-5, grad_norm=1e-4, grad=1e-3)
# backward kernel vs its plain version: the forward's tolerances
# (FLASH_TOL) times max(1, the gradient's largest magnitude)
BWD_CASES = [
    (1, 4096, 4096, 32, 4, 128, 128, True, -1, BF16),   # train/yi-6b
    (4, 1024, 1024, 32, 4, 128, 128, True, -1, F32),    # serve shape, f32
    (2, 256, 256, 8, 4, 64, 64, True, 100, F32),        # window
    (2, 128, 128, 4, 2, 32, 32, False, -1, F32),        # non-causal
    (2, 128, 128, 4, 2, 32, 32, False, 40, BF16),       # non-causal window
    (2, 100, 130, 4, 2, 64, 48, True, -1, F32),         # Sq < Skv, hv != h
    (2, 130, 100, 4, 4, 16, 16, True, -1, F32),         # Sq > Skv, G = 1
    (2, 77, 77, 8, 8, 16, 16, True, 30, BF16),          # ragged window, G=1
    (2, 256, 256, 16, 2, 128, 128, True, -1, BF16),     # G = 8
    (2, 200, 300, 4, 2, 50, 36, True, -1, F32),         # odd widths
    (3, 1000, 1000, 8, 2, 128, 128, True, -1, BF16),    # ragged, long
    (2, 100, 130, 4, 2, 64, 48, True, 40, BF16),        # window, hv != h
    (2, 1024, 1024, 40, 8, 128, 128, True, -1, BF16),   # train/smr, G = 5
    (1, 4096, 4096, 40, 8, 128, 128, True, -1, BF16),   # llama4 train, G=5
    (1, 256, 256, 40, 8, 128, 128, True, -1, F32),      # its f32 step
    (4, 1024, 1024, 28, 4, 128, 128, True, -1, BF16),   # qwen2-vl, G = 7
    (1, 4096, 4096, 28, 4, 128, 128, True, -1, BF16),   # its microbatch
    (1, 256, 256, 28, 4, 128, 128, True, -1, F32),      # its f32 step
    (1, 4224, 4224, 25, 5, 64, 64, True, 1024, BF16),   # hymba microbatch
    (1, 384, 384, 25, 5, 64, 64, True, 1024, F32),      # its f32 step
    (2, 1500, 1500, 12, 12, 64, 64, False, -1, BF16),   # whisper encoder
    (2, 4096, 1500, 12, 12, 64, 64, False, -1, BF16),   # its cross
    (2, 4096, 4096, 12, 12, 64, 64, True, -1, BF16),    # its decoder
    (1, 1500, 1500, 12, 12, 64, 64, False, -1, F32),    # its f32 step
    (1, 256, 1500, 12, 12, 64, 64, False, -1, F32),
    # q/k width 192, v width 128: deepseek-v3's MLA train microbatch and
    # f32 step, ragged GQA, the masks at a padded q/k width under 192, and
    # the f32 kernel's 4-byte copies at the new width
    (1, 4096, 4096, 128, 128, 192, 128, True, -1, BF16),  # MLA train
    (1, 256, 256, 128, 128, 192, 128, True, -1, F32),     # its f32 step
    *[(2, 100, 130, 4, 2, 192, 128, True, -1, dt) for dt in (BF16, F32)],
    (2, 256, 300, 8, 4, 192, 128, True, 100, F32),      # window
    (2, 256, 300, 8, 4, 176, 96, False, -1, BF16),      # bidirectional
    (2, 100, 130, 4, 2, 190, 126, True, -1, F32),       # 4-byte copies
]
# each backward route's three CUDA kernels, as torch.profiler names them
# (no name holds another's), and its library and info export; the bf16
# route's names share BWD_BF16_PREFIX
BWD_KERNELS = {
    "flash_attention_bwd": ("flash_bwd_bf16_dot_kernel",
                            "flash_bwd_bf16_dkdv_kernel",
                            "flash_bwd_bf16_dq_kernel"),
    "flash_attention_bwd_f32": ("flash_bwd_f32_dot_kernel",
                                "flash_bwd_f32_dkdv_kernel",
                                "flash_bwd_f32_dq_kernel")}
BWD_BF16_PREFIX = "flash_bwd_bf16_"
BWD_LIBS = {
    "flash_attention_bwd": ("flash_attention_bwd_bf16.cu",
                            "flash_attention_bwd_bf16_info"),
    "flash_attention_bwd_f32": ("flash_attention_bwd.cu",
                                "flash_attention_bwd_info")}
# each forward's LSE (log2 units) against the plain logsumexp of the same
# scores: the two sum the exponentials in another order. bf16: 1e-3 is a
# relative error of 0.07 % in P, below a bf16 ulp of it; f32: 1e-4, f32
# rounding of sums of up to a few thousand terms
LSE_TOL = {BF16: 1e-3, F32: 1e-4}


def bwd_route(dt) -> str:
    return "flash_attention_bwd" if dt == BF16 else "flash_attention_bwd_f32"


def bwd_kernel_info() -> dict:
    """Registers a thread, spill (local) bytes a thread, dynamic shared
    bytes a block and blocks an SM of each backward route's CUDA kernels
    at each instantiation (``flash_attention_bwd_bf16_info``,
    ``flash_attention_bwd_info``; the f32 kernels on both copy paths),
    keyed ``name/width`` for 16-byte copies and ``name/width/4byte``,
    width as :func:`width_key` gives it. At q/k width 192 the bf16 route
    runs dk and dv as two passes: ``.../192x128/dk`` and ``.../dv``.
    No kernel may spill, and none may ask for more shared memory than a
    block has."""
    from repro_torch.kernels import _build
    out = {}
    for route, (source, symbol) in BWD_LIBS.items():
        fn = getattr(ctypes.CDLL(str(_build.library_path(source))), symbol)
        bf16 = route == "flash_attention_bwd"
        plans = ((None, ""),) if bf16 else ((1, ""), (0, "/4byte"))
        for width, vwidth in flash_instantiations():
            kernels = list(enumerate(BWD_KERNELS[route], start=1))
            if bf16 and width != vwidth:   # the dK pass, then the dV pass
                dkdv = BWD_KERNELS[route][1]
                wk = width_key(width, vwidth)
                kernels[1] = (2, f"{dkdv}/{wk}/dk")
                kernels.append((4, f"{dkdv}/{wk}/dv"))
            for vec, suffix in plans:
                for which, name in kernels:
                    vals = [ctypes.c_int() for _ in range(4)]
                    args = (which, width, vwidth) + (() if vec is None
                                                     else (vec,))
                    err = fn(*args, *map(ctypes.byref, vals))
                    check(err == 0, f"{symbol}{args}: {err}")
                    key = (name if "/" in name else
                           f"{name}/{width_key(width, vwidth)}") + suffix
                    out[key] = info = dict(zip(
                        ("registers", "spill_bytes", "smem_bytes_per_block",
                         "blocks_per_sm"), (v.value for v in vals)))
                    check(info["spill_bytes"] == 0,
                          f"{key} spills: {info}")
                    check(info["smem_bytes_per_block"] <= SMEM_PER_BLOCK
                          and info["blocks_per_sm"] >= 1,
                          f"{key} does not fit an SM: {info}")
    return out


def bwd_kernel_phase(dev) -> dict:
    """The flash backward kernels against their plain version on the card
    in every case of BWD_CASES, each with the output and LSE of
    ``flash_attention_fwd_lse``: bf16 through the tensor-core kernel, f32
    through the CUDA-core kernel (each call one launch of its dtype's
    kernel and no other); two launches at the train shape and at the f32
    serving shape give the same bytes. The forward output ``o`` that the
    backward takes is held against the plain forward too (FLASH_TOL), so
    the train shape's forward is checked on the card. In both dtypes the
    forward's LSE is held against the plain log2-domain logsumexp
    (LSE_TOL), its output bytes must equal a launch without the LSE, and
    the backward without the LSE must raise. Returns, by route, the worst
    absolute error and the worst error over its tolerance's scale of the
    backward and the LSE's worst error; the forward's worst absolute
    error by kernel name."""
    kf, _ = model_kernel_modules()
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    worst = dict.fromkeys(BWD_KERNELS, 0.0)
    worst_abs = dict.fromkeys(BWD_KERNELS, 0.0)
    lse_worst = dict.fromkeys(BWD_KERNELS, 0.0)
    cases = []
    fwd_worst = {"flash_attention": 0.0, "flash_attention_f32": 0.0}
    for (B, Sq, Skv, H, K, h, hv, causal, window, dt) in BWD_CASES:
        q = randn(gen, (B, Sq, H, h), dev, dt)
        k = randn(gen, (B, Skv, K, h), dev, dt)
        v = randn(gen, (B, Skv, K, hv), dev, dt)
        do = randn(gen, (B, Sq, H, hv), dev, dt)
        case = [B, Sq, Skv, H, K, h, hv, causal, window, str(dt)]
        route, extra = bwd_route(dt), {}
        o, lse = kf.flash_attention_fwd_lse(q, k, v, causal=causal,
                                            window=window)
        o_bare = kf.flash_attention(q, k, v, causal=causal, window=window)
        extra["same_bytes_without_lse"] = torch.equal(o, o_bare)
        check(extra["same_bytes_without_lse"], f"flash_attention "
              f"{case}: the output differs with and without the LSE")
        lse_want = plain_lse(q, k, causal=causal, window=window)
        extra["lse_err"] = float((lse - lse_want).abs().max())
        check(extra["lse_err"] <= LSE_TOL[dt], f"flash_attention {case}: "
              f"LSE max abs err {extra['lse_err']} > {LSE_TOL[dt]}")
        lse_worst[route] = max(lse_worst[route], extra["lse_err"])
        del o_bare, lse_want
        try:
            kf.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                   window=window)
            extra["raised_without_lse"] = False
        except ValueError:
            extra["raised_without_lse"] = True
        check(extra["raised_without_lse"], f"flash_attention_bwd {case}: "
              "a backward without the LSE did not raise")
        o_want = plain_flash(q, k, v, causal=causal, window=window)
        before = model_counts()
        got = kf.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                     window=window, lse=lse)
        launched = {n: c - before[n] for n, c in model_counts().items()}
        want = plain_bwd(q, k, v, o, do, causal=causal, window=window)
        torch.cuda.synchronize()
        check(o.dtype == dt and o.shape == o_want.shape,
              f"flash_attention {case}: output {o.dtype}{tuple(o.shape)}")
        o_err = float((o.float() - o_want.float()).abs().max())
        check(o_err <= FLASH_TOL[dt], f"flash_attention {case} (forward of "
              f"the backward case): max abs err {o_err} > {FLASH_TOL[dt]}")
        fwd = "flash_attention" if dt == BF16 else "flash_attention_f32"
        fwd_worst[fwd] = max(fwd_worst[fwd], o_err)
        del o_want
        check(launched == {**dict.fromkeys(launched, 0), route: 1},
              f"flash_attention_bwd {case} launched {launched}, expected "
              f"one {route}")
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            check(a.dtype == dt and a.shape == b.shape,
                  f"flash_attention_bwd {case}: {name} {a.dtype}"
                  f"{tuple(a.shape)}")
            scale = max(1.0, float(b.float().abs().max()))
            err = float((a.float() - b.float()).abs().max())
            check(err <= FLASH_TOL[dt] * scale, f"flash_attention_bwd "
                  f"{case}: {name} max abs err {err} > {FLASH_TOL[dt]} x "
                  f"{scale}")
            errs[name] = dict(err=err, scale=scale)
            worst[route] = max(worst[route], err / scale)
            worst_abs[route] = max(worst_abs[route], err)
        # the train shape and the f32 serving shape: byte-equal on a
        # second launch
        if Sq in (4096, 4224) or (dt == F32 and Sq == 1024):
            again = kf.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                           window=window, lse=lse)
            extra["same_bytes_twice"] = all(
                torch.equal(a, b) for a, b in zip(got, again))
            check(extra["same_bytes_twice"], f"flash_attention_bwd {case}: "
                  "two launches on the same inputs differ")
        cases.append(dict(case=case, kernel=route, tol=FLASH_TOL[dt],
                          o_err=o_err, **errs, **extra))
        del q, k, v, do, o, lse, got, want
    torch.cuda.empty_cache()
    info = bwd_kernel_info()
    log(phase="kernels/flash_bwd", cases=cases, worst_err_over_scale=worst,
        max_abs_err=worst_abs, forward_max_abs_err=fwd_worst,
        lse_max_abs_err=lse_worst, info=info)
    return dict(max_abs_err=worst_abs, worst_err_over_scale=worst,
                info=info, forward_max_abs_err=fwd_worst,
                lse_max_abs_err=lse_worst)


def leaves_equal(a, b) -> tuple[bool, int]:
    """Two states leaf for leaf with ``torch.equal`` on the card; and the
    number of tensors compared."""
    from repro_torch.models.common import reference_leaves
    la, lb = reference_leaves(a), reference_leaves(b)
    if [p for p, _, _ in la] != [p for p, _, _ in lb]:
        return False, 0
    n, same = 0, True
    for (_, ta, _), (_, tb, _) in zip(la, lb):
        for x, y in zip(ta, tb):
            same &= bool(torch.equal(x, y))
            n += 1
    return same, n


def train_decisions(steps: int, noop: bool = False) -> list:
    """(group, instance, command) of two ordering groups deciding STEP
    b_0 .. b_{steps-1} in turn (group 0 the even ones), with a NOOP in
    group 1's first slot when ``noop``."""
    from repro_torch.runtime.statemachine import Command
    cmds = [Command("STEP", f"b_{i}") for i in range(steps)]
    if noop:
        cmds.insert(1, Command("NOOP"))
    return [(i % 2, i // 2, c) for i, c in enumerate(cmds)]


def train_phase(dev) -> dict:
    """train/yi-6b: full width and depth in bf16, TRAIN_B x TRAIN_S tokens
    a step in 2 microbatches, Adafactor. Pod 0 applies TRAIN_STEPS STEP
    commands (a MergedCommandLog of 2 groups) through make_train_step,
    each timed with CUDA events, with exactly 2 L m forward (forward and
    recompute) and L m backward flash launches a step; pod 1 applies the
    same decisions fed in the reverse order and must end equal, leaf for
    leaf. Then one more step of pod 0 under torch.profiler."""
    from repro_torch.configs import registry
    from repro_torch.runtime.data import ShardedBatchSource
    from repro_torch.runtime.statemachine import (MergedCommandLog,
                                                  TrainerStateMachine)
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    kf, _ = model_kernel_modules()
    cfg = registry.get(TRAIN_ARCH)
    micro = registry.microbatches(TRAIN_ARCH, "train_4k")
    opt = O.OptConfig(kind=O.choose_optimizer(1e12), lr=TRAIN_LR)
    step_fn = TR.make_train_step(cfg, opt, microbatches=micro,
                                 global_batch=TRAIN_B)
    src = ShardedBatchSource(cfg.vocab, TRAIN_B, TRAIN_S, seed=SEED,
                             device=dev)
    store = {f"b_{i}": src.batch(i) for i in range(TRAIN_STEPS)}
    decided = train_decisions(TRAIN_STEPS)
    want = {"flash_attention": 2 * cfg.n_layers * micro,
            "flash_attention_bwd": cfg.n_layers * micro}

    def pod(name):
        return TrainerStateMachine(name, step_fn, TR.make_state(
            cfg, opt, torch.Generator(dev).manual_seed(SEED), dev), store)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = pod("pod0")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the dry run's layout at the (1, 1) host mesh puts the whole state
    # on one device: its bytes per device are the card's state's
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import tree_bytes
    dry_bytes = DR.state_bytes_per_device(cfg, opt, make_host_mesh())
    card_bytes = tree_bytes(a.state)
    check(dry_bytes == card_bytes,
          f"train: the dry run's state bytes per device {dry_bytes} != "
          f"the card's state bytes {card_bytes}")
    steps = []

    def timed_apply(cmd):
        before = model_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        a.apply(cmd)
        end.record()
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in model_counts().items()}
        steps.append(dict(seconds=start.elapsed_time(end) / 1e3,
                          launches=launched, **a.metrics_log[-1]))
        check(launched == {**dict.fromkeys(launched, 0), **want},
              f"train step {len(steps)} launched {launched}, expected "
              f"{want}")
        check(all(np.isfinite(a.metrics_log[-1][k])
                  for k in ("loss", "grad_norm")),
              f"train step {len(steps)}: {a.metrics_log[-1]}")

    # the main path: counts set to 0 right before, read right after
    reset_counts()
    log_a = MergedCommandLog(2, apply=timed_apply)
    for g, i, cmd in decided:
        log_a.feed(g, i, cmd)
    counts = model_counts()
    peak = torch.cuda.max_memory_allocated()
    check(a.step == TRAIN_STEPS and log_a.audit() == []
          and counts["flash_attention_bwd"] == TRAIN_STEPS
          * want["flash_attention_bwd"], f"train: step {a.step}, counts "
          f"{counts}")
    timed = steps[1:]
    sec = sum(s["seconds"] for s in timed) / len(timed)

    # the replica: the same decisions in the reverse feed order
    b = pod("pod1")
    log_b = MergedCommandLog(2, apply=b.apply)
    for g, i, cmd in decided[::-1]:
        log_b.feed(g, i, cmd)
    same, n_tensors = leaves_equal(a.state, b.state)
    check(same and log_b.audit() == [] and log_a.merged == log_b.merged
          and a.metrics_log == b.metrics_log,
          f"train: pods differ (leaves equal {same}, merged logs equal "
          f"{log_a.merged == log_b.merged})")
    del b, log_b
    torch.cuda.empty_cache()

    # one more step of pod 0, traced: device time of each kernel
    wall = {}

    def one_step():
        t1 = time.perf_counter()
        step_fn(a.state, store["b_0"])
        torch.cuda.synchronize()
        wall["us"] = (time.perf_counter() - t1) * 1e6
    names = BWD_KERNELS["flash_attention_bwd"]
    events = device_kernels(one_step, 1, BWD_BF16_PREFIX,
                            len(names) * want["flash_attention_bwd"])
    fwd_us = [us for name, us in events if SYMBOLS["flash_attention"] in name]
    bwd_us = {k: [us for name, us in events if k in name] for k in names}
    check(len(fwd_us) == want["flash_attention"]
          and all(len(v) == want["flash_attention_bwd"]
                  for v in bwd_us.values()),
          f"train profile: {len(fwd_us)} forward and "
          f"{ {k: len(v) for k, v in bwd_us.items()} } backward events")
    busy = sum(us for _, us in events)
    res = dict(
        arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S,
        microbatches=micro, optimizer=opt.kind, lr=opt.lr,
        init_seconds=init_s, steps=steps, seconds_per_step=sec,
        tokens_per_s=TRAIN_B * TRAIN_S / sec, peak_mem_bytes=peak,
        launches_per_step=want, launches=counts,
        replica_leaves_compared=n_tensors,
        state_bytes=card_bytes, dryrun_state_bytes_per_device=dry_bytes,
        profiled_step=dict(
            wall_us=wall["us"], device_us=busy,
            device_busy_share=busy / wall["us"],
            flash_fwd_us_per_call=sum(fwd_us) / len(fwd_us),
            flash_bwd_us_per_call=sum(sum(v) for v in bwd_us.values())
            / want["flash_attention_bwd"],
            flash_bwd_kernel_us_per_call={
                k: sum(v) / len(v) for k, v in bwd_us.items()},
            flash_fwd_share=sum(fwd_us) / busy,
            flash_bwd_share=sum(sum(v) for v in bwd_us.values()) / busy))
    log(phase="train/yi-6b", **res)
    del a, log_a, store
    torch.cuda.empty_cache()
    return res


def train_f32_phase(dev) -> dict:
    """yi-6b at F32_TRAIN_LAYERS layers, full width, f32, one AdamW step
    of F32_TRAIN_B x F32_TRAIN_S tokens on the card and on the CPU from
    one set of weights (:func:`f32_states`): :func:`f32_step_vs_cpu`."""
    from repro_torch.configs import registry
    from repro_torch.runtime.data import ShardedBatchSource
    from repro_torch.train import optimizer as O
    cfg = registry.get(TRAIN_ARCH).replace(n_layers=F32_TRAIN_LAYERS,
                                           dtype=F32)
    opt = O.OptConfig(kind="adamw", lr=TRAIN_LR)
    cpu, card = f32_states(cfg, opt, dev)
    tokens = ShardedBatchSource(cfg.vocab, F32_TRAIN_B, F32_TRAIN_S,
                                seed=SEED + 7, device="cpu").batch(0)
    return f32_step_vs_cpu("train/f32", cfg, opt, cpu, card, tokens)


def f32_step_vs_cpu(phase: str, cfg, opt, cpu: dict, card: dict,
                    batch: dict, flip_aware_of=None, want=None) -> dict:
    """One AdamW step of the f32 state ``cpu`` on the CPU and of its copy
    ``card`` on the card, on the same ``batch`` (on the CPU): loss,
    grad_norm, every gradient leaf and the parameters after the step
    (F32_STEP_TOL), and exactly 2 L forward and L backward f32 flash
    launches on the card, L the flash calls of a forward
    (:func:`flash_calls`), or the launches ``want`` names. With
    ``flip_aware_of``, an active
    :class:`MoeRecorder`, the MoE dispatches of the two runs (the card's
    first) are held to the flip-aware rule first; the step's checks then
    hold only where no token flipped, so a flip fails them, and the log
    says so."""
    from repro_torch.models.common import reference_leaves
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not run in TF32")
    B, S = batch["labels" if "labels" in batch else "tokens"].shape
    grads_of = TR.make_grad_fn(cfg, global_batch=B)
    out, seconds = {}, {}
    split = {}
    for name, state in (("card", card), ("cpu", cpu)):
        d = state["step"].device
        marks = [time.perf_counter()]

        def mark():
            if d.type == "cuda":
                torch.cuda.synchronize()
            marks.append(time.perf_counter())
        before = model_counts()
        with TR.deterministic(d):
            grads, loss = grads_of(state["params"],
                                   {k: v.to(d) for k, v in batch.items()})
            norm = TR._global_norm(grads)
            mark()
            O.apply_opt(opt, state["params"], grads, state["opt"],
                        state["step"])
            mark()
        launched = {n: c - before[n] for n, c in model_counts().items()}
        out[name] = dict(loss=float(loss), grad_norm=float(norm),
                         grads=[[g.cpu() for g in leaf] for leaf in grads],
                         launched=launched)
        mark()
        seconds[name] = marks[-1] - marks[0]
        split[name] = dict(zip(("grads", "opt", "grads_to_host"),
                               np.diff(marks).tolist()))
        del grads
    routing = None
    if flip_aware_of is not None:
        routes = flip_aware_of.routes
        half = len(routes) // 2
        rows, flips, worst = flip_aware(routes[half:], routes[:half])
        routing = dict(dispatches=half, flips=flips,
                       largest_flipped_margin=worst,
                       flip_margin=MOE_FLIP_MARGIN,
                       keep_differs=sum(int((~r).sum()) for r in rows)
                       - flips,
                       dropped=[int((~r.keep).sum()) for r in routes[:half]],
                       capacity=routes[0].capacity)
    card_launched = out["card"]["launched"]
    want = want or {"flash_attention_f32": 2 * flash_calls(cfg),
                    "flash_attention_bwd_f32": flash_calls(cfg)}
    check(card_launched == {**dict.fromkeys(card_launched, 0), **want},
          f"{phase}: launches {card_launched}")
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in ("loss", "grad_norm")}
    grad_err = 0.0
    for lc, lg in zip(out["cpu"]["grads"], out["card"]["grads"]):
        for a, b in zip(lc, lg):
            grad_err = max(grad_err, float((a - b).abs().max())
                           / max(float(a.abs().max()), 1e-30))
    param_err = 0.0
    for (_, tc, _), (_, tg, _) in zip(reference_leaves(cpu["params"]),
                                      reference_leaves(card["params"])):
        for a, b in zip(tc, tg):
            param_err = max(param_err,
                            float((a - b.cpu()).detach().abs().max()))
    ok = (rel["loss"] <= F32_STEP_TOL["loss"]
          and rel["grad_norm"] <= F32_STEP_TOL["grad_norm"]
          and grad_err <= F32_STEP_TOL["grad"]
          and param_err <= 2 * opt.lr + 1e-6)
    res = dict(layers=cfg.n_layers, batch=B, seq=S,
               loss=out["card"]["loss"], grad_norm=out["card"]["grad_norm"],
               loss_rel_err=rel["loss"], grad_norm_rel_err=rel["grad_norm"],
               grad_leaf_rel_err=grad_err, param_err=param_err,
               tolerance=dict(F32_STEP_TOL, params=2 * opt.lr + 1e-6),
               launches=out["card"]["launched"], seconds=seconds,
               split_seconds=split)
    if routing is not None:
        res["routing"] = routing
    log(phase=phase, **res)
    check(ok, f"{phase}: card vs CPU {res}")
    del cpu, card, out
    torch.cuda.empty_cache()
    return res


def flash_calls(cfg) -> int:
    """The flash attention calls of one forward of ``cfg``: one a
    decoder layer; the encoder-decoder adds one an encoder layer and one
    a cross-attention (a decoder layer's second); the MTP head's block
    (``lm_loss`` with ``cfg.mtp``) one more."""
    if cfg.is_encoder_decoder:
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers + int(cfg.mtp)


def checkpoint_phase(dev) -> dict:
    """At the 2-layer cut (full width, bf16, Adafactor): pod P applies
    STEP, NOOP, STEP, STEP, CKPT(3), STEP from two groups; its CKPT saves
    with node 1 failed (commit by majority) into a temporary directory
    that is deleted after. Pod Q applies the same decisions in reverse
    feed order: equal tree_digest. Pod R, restored from the checkpoint
    into a state drawn from another seed, replays the log after the CKPT
    and ends on P's digest."""
    import shutil
    import tempfile
    from repro_torch.configs import registry
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.data import ShardedBatchSource
    from repro_torch.runtime.statemachine import (
        Command, MergedCommandLog, TrainerStateMachine, tree_digest)
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    cfg = registry.get(TRAIN_ARCH).replace(n_layers=F32_TRAIN_LAYERS)
    opt = O.OptConfig(kind="adafactor", lr=TRAIN_LR)
    step_fn = TR.make_train_step(cfg, opt, microbatches=2,
                                 global_batch=CKPT_B)
    src = ShardedBatchSource(cfg.vocab, CKPT_B, CKPT_S, seed=SEED + 8,
                             device=dev)
    store = {f"b_{i}": src.batch(i) for i in range(4)}
    decided = train_decisions(3, noop=True)
    decided += [(0, 2, Command("CKPT", 3)), (1, 2, Command("STEP", "b_3"))]
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    manifests = []

    def on_ckpt(sm, n):
        t0 = time.perf_counter()
        m = ckpt.save_sharded(sm.state, directory, n, fail_shards={1})
        m["seconds"] = time.perf_counter() - t0
        manifests.append(m)

    def pod(name, seed, hook=None):
        return TrainerStateMachine(name, step_fn, TR.make_state(
            cfg, opt, torch.Generator(dev).manual_seed(seed), dev), store,
            on_ckpt=hook)
    try:
        p = pod("P", SEED, on_ckpt)
        log_p = MergedCommandLog(2, apply=p.apply)
        for g, i, cmd in decided:
            log_p.feed(g, i, cmd)
        q = pod("Q", SEED)
        log_q = MergedCommandLog(2, apply=q.apply)
        for g, i, cmd in decided[::-1]:
            log_q.feed(g, i, cmd)
        check(p.step == q.step == 4 and log_p.audit() == log_q.audit() == []
              and p.digest() == q.digest()
              and tree_digest(p.state) == tree_digest(q.state),
              f"checkpoint phase: pods P and Q differ ({p.digest()}, "
              f"{q.digest()})")
        check(len(manifests) == 1 and manifests[0]["committed"]
              and manifests[0]["acked_nodes"] == [0, 2, 3],
              f"checkpoint phase: manifest {manifests}")
        t0 = time.perf_counter()
        restored, man = ckpt.restore_sharded(
            TR.make_state(cfg, opt, torch.Generator(dev).manual_seed(
                SEED + 1), dev), directory)
        restore_s = time.perf_counter() - t0
        check(int(restored["step"]) == 3 and tree_digest(
            restored["params"]) == man["digest"],
              f"checkpoint phase: restored step {int(restored['step'])}")
        r = TrainerStateMachine("R", step_fn, restored, store)
        cut = p.applied.index(("CKPT", 3))
        for enc in p.applied[cut + 1:]:
            r.apply(Command.decode(enc))
        check(r.step == 4 and r.digest() == p.digest()
              and tree_digest(r.state) == tree_digest(p.state),
              f"checkpoint phase: restored pod ends on {r.digest()}, "
              f"P on {p.digest()}")
        res = dict(layers=cfg.n_layers, batch=CKPT_B, seq=CKPT_S,
                   digest=p.digest(), state_digest=tree_digest(p.state),
                   manifest_digest=man["digest"],
                   acked_nodes=manifests[0]["acked_nodes"],
                   save_seconds=manifests[0]["seconds"],
                   restore_seconds=restore_s,
                   leaves=manifests[0]["n_leaves"])
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    check(not Path(directory).exists(), f"{directory} was not deleted")
    log(phase="train/checkpoint", **res)
    torch.cuda.empty_cache()
    return res


SMR_ARCH = "qwen3-14b"
# qwen3-14b at full width with its depth cut from 40 to 2 layers: two
# pods' states and a restore template (about 2.2 B parameters, 4.4 GB of
# bf16 each) sit side by side on one card within the run's time limit
SMR_LAYERS = 2
SMR_B, SMR_S = 2, 1024
SMR_LR = TRAIN_LR
SMR_STEPS = 6                 # one fixed batch as 6 STEP commands
SMR_CKPT = 3                  # CKPT(3) after the third
SMR_QUIET_EVERY = 500.0       # DES time between quiescence checks
SMR_HORIZON = 20_000.0        # most DES time the schedule may take


def smr_quiet(svc, n_cmds: int) -> bool:
    """Every command replied to its client, and every pod's disseminator
    (pod i's is disseminator i) has executed all of them and the pod has
    taken all SMR_STEPS steps."""
    return (len(svc.sim.clients[0].replied) == n_cmds and all(
        len(svc.sim.disseminators[i].executed) == n_cmds
        and svc.pods[f"pod{i}"].step == SMR_STEPS
        for i in range(len(svc.pods))))


def smr_schedule(svc, batch, template, timed=None) -> dict:
    """The schedule of tests/test_runtime.py:118-148 and
    tests/test_system.py:16-51 on one service: ``batch`` as SMR_STEPS
    STEP commands with CKPT(SMR_CKPT) after the third, pod1 crashed once
    those are applied, the ordering leader crashed, the rest submitted,
    pod1 restarted from the committed checkpoint, the run continued to
    quiescence. ``timed(name, fn)`` wraps each call to the service.
    Returns the old and the new leader, pod1's step and the length of
    its applied log right after its restart, and the DES's final
    time."""
    from repro_torch.runtime.statemachine import Command
    timed = timed or (lambda name, fn: fn())
    n_cmds = SMR_STEPS + 1
    for _ in range(SMR_CKPT):
        svc.submit_command(svc.submit_batch(batch))
    svc.submit_command(Command("CKPT", SMR_CKPT))
    timed("run", lambda: svc.run(until=400))
    svc.crash_pod("pod1")
    old_leader = svc.leader_id()
    svc.crash_leader()
    for _ in range(SMR_STEPS - SMR_CKPT):
        svc.submit_command(svc.submit_batch(batch))
    timed("run", lambda: svc.run(until=2500))
    timed("restart", lambda: svc.restart_pod("pod1", template()))
    pod1 = svc.pods["pod1"]
    at_restart = dict(step=pod1.step, applied=len(pod1.applied))
    t = 2500.0
    while not smr_quiet(svc, n_cmds):
        t += SMR_QUIET_EVERY
        check(t <= SMR_HORIZON, f"train/smr: not quiescent by DES time "
              f"{SMR_HORIZON}")
        timed("run", lambda: svc.run(until=t))
    return dict(old_leader=old_leader, leader=svc.leader_id(),
                at_restart=at_restart, des_time=svc.sim.sched.now)


def smr_stub_run(directory: str) -> tuple:
    """The same schedule through the port's DES on the CPU, with a stub
    train step that only counts steps; the host seconds of the DES's own
    ``sim.run`` calls (without the pods' applies and the checkpoint's
    save, which ``svc.run`` also makes)."""
    from repro_torch.runtime.coordinator import ServiceConfig, \
        TrainingService

    def stub_state():
        return {"params": {"w": torch.zeros(4)},
                "step": torch.zeros((), dtype=torch.int32)}

    def stub_step(state, batch):
        state["step"] += 1
        return state, {"loss": 0.0, "grad_norm": 0.0}
    svc = TrainingService(ServiceConfig(n_pods=2, ckpt_dir=directory,
                                        seed=SEED), stub_step, stub_state)
    sim_run, des_s = svc.sim.run, [0.0]

    def timed_sim_run(until):
        t0 = time.perf_counter()
        sim_run(until=until)
        des_s[0] += time.perf_counter() - t0
    svc.sim.run = timed_sim_run
    sched = smr_schedule(svc, {"tokens": torch.zeros(1, 1,
                                                     dtype=torch.long)},
                         stub_state)
    return svc, sched, des_s[0]


def smr_phase(dev) -> dict:
    """train/smr: ``TrainingService`` (2 pods) over the port's HT-Paxos
    DES, its pods training SMR_ARCH at full width and SMR_LAYERS layers
    in bf16 with Adafactor, SMR_B x SMR_S tokens a step, through the
    schedule of ``smr_schedule``. Checks: both pods at step SMR_STEPS and
    consistent; pod1's restore read step SMR_CKPT's manifest; a third
    state machine applying the decided log ends on the pods' digests;
    every step launched exactly 2 L m forward and L m backward bf16 flash
    kernels; losses and grad norms finite, each loss below the one
    before; the leader's LAN-1 bytes 0, every disseminator's above 0; the
    executed sequences equal the same schedule's on the CPU with a stub
    train step."""
    import shutil
    import tempfile
    from repro_torch.configs import registry
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.coordinator import ServiceConfig, \
        TrainingService
    from repro_torch.runtime.data import ShardedBatchSource
    from repro_torch.runtime.statemachine import (Command,
                                                  TrainerStateMachine,
                                                  tree_digest)
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    t_phase = time.perf_counter()
    full = registry.get(SMR_ARCH)
    cfg = full.replace(n_layers=SMR_LAYERS)
    opt = O.OptConfig(kind="adafactor", lr=SMR_LR)
    micro = 1
    step_fn = TR.make_train_step(cfg, opt, microbatches=micro,
                                 global_batch=SMR_B)
    want = {"flash_attention": 2 * cfg.n_layers * micro,
            "flash_attention_bwd": cfg.n_layers * micro}
    steps = []

    def train_step(state, batch):
        before = model_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, metrics = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in model_counts().items()}
        row = dict(seconds=start.elapsed_time(end) / 1e3, launches=launched,
                   **{k: float(v) for k, v in metrics.items()})
        steps.append(row)
        check(launched == {**dict.fromkeys(launched, 0), **want},
              f"train/smr step {len(steps)} launched {launched}, expected "
              f"{want}")
        check(all(np.isfinite(row[k]) for k in ("loss", "grad_norm")),
              f"train/smr step {len(steps)}: {row}")
        return state, metrics

    def init_state():
        return TR.make_state(cfg, opt, torch.Generator(dev).manual_seed(SEED),
                             dev)
    # the batch is made on the host: the service stores it on the pods'
    # device
    batch = ShardedBatchSource(cfg.vocab, SMR_B, SMR_S, seed=SEED + 14,
                               device="cpu").batch(0)
    directory = tempfile.mkdtemp(prefix="chip_smoke_smr_")
    stub_dir = tempfile.mkdtemp(prefix="chip_smoke_smr_stub_")
    walls = {"run": 0.0, "restart": 0.0, "save": 0.0}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] += time.perf_counter() - t0
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        svc = TrainingService(ServiceConfig(n_pods=2, ckpt_dir=directory,
                                            seed=SEED),
                              train_step, init_state)
        check(svc.device.type == dev.type,
              f"train/smr: pods on {svc.device}")
        pod0 = svc.pods["pod0"]
        save_cb = pod0.on_ckpt

        def timed_save(sm, arg):
            timed("save", lambda: save_cb(sm, arg))
        pod0.on_ckpt = timed_save
        # the main path: counts set to 0 right before, read right after
        reset_counts()
        sched = smr_schedule(svc, batch, init_state, timed)
        counts = model_counts()
        peak = torch.cuda.max_memory_allocated()
        check(all(t.device == svc.device for b in svc.batch_store.values()
                  for t in b.values()), "train/smr: a batch is not on the "
              "pods' device")
        pod0, pod1 = svc.pods["pod0"], svc.pods["pod1"]
        n_steps = len(steps)
        # pod0 applies every step, pod1 SMR_CKPT before its crash and the
        # rest after its restore
        check(n_steps == 2 * SMR_STEPS
              and counts["flash_attention"] == n_steps
              * want["flash_attention"]
              and counts["flash_attention_bwd"] == n_steps
              * want["flash_attention_bwd"],
              f"train/smr: {n_steps} steps, counts {counts}")
        manifest = json.loads((Path(directory) / (
            f"manifest_{SMR_CKPT:08d}.json")).read_text())
        at = sched["at_restart"]
        # the template starts at step 0: step SMR_CKPT came from the file,
        # and pod1 then applied the log from CKPT(SMR_CKPT) on (the
        # restore skipped the SMR_CKPT steps before it)
        check(ckpt.latest_committed_step(directory) == SMR_CKPT
              and manifest["committed"] and manifest["step"] == SMR_CKPT
              and at["step"] == SMR_CKPT and at["applied"] == 0
              and len(pod1.applied) == SMR_STEPS + 1 - SMR_CKPT,
              f"train/smr: pod1 restarted at step {at['step']} with "
              f"{at['applied']} applied, then applied {len(pod1.applied)}; "
              f"manifest {manifest}")
        check(sched["leader"] not in (None, sched["old_leader"]),
              f"train/smr: leader {sched['old_leader']} -> "
              f"{sched['leader']}")
        losses = [m["loss"] for m in pod0.metrics_log]
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"train/smr: losses not falling: {losses}")
        same, n_tensors = leaves_equal(pod0.state, pod1.state)
        check({pod0.step, pod1.step} == {SMR_STEPS} and same
              and pod0.metrics_log[-SMR_CKPT:] == pod1.metrics_log,
              f"train/smr: pods at steps {pod0.step}, {pod1.step}, leaves "
              f"equal {same}")
        # the decided log applied directly by a third state machine on the
        # card, while host threads hash the pods' states (sha256 over
        # ~4.4 GB a state; hashlib releases the GIL)
        executed = svc.sim.disseminators[0].executed
        with ThreadPoolExecutor(4) as pool:
            consistent = pool.submit(svc.consistent)
            pod_digests = (pool.submit(pod0.digest),
                           pool.submit(tree_digest, pod0.state))
            replay = TrainerStateMachine("replay", train_step, init_state(),
                                         svc.batch_store)
            for rid in executed:
                replay.apply(Command.decode(rid[1]))
            replay_digests = (pool.submit(replay.digest),
                              pool.submit(tree_digest, replay.state))
            digests = tuple(f.result() for f in pod_digests)
            check(consistent.result(), "train/smr: svc.consistent() is "
                  "False")
            got = tuple(f.result() for f in replay_digests)
        check(got == digests and replay.applied == pod0.applied,
              f"train/smr: the direct replay ends on {got}, the pods on "
              f"{digests}")
        del replay
        # the payload plane and the ordering plane
        sim = svc.sim
        lan1 = {n: st.total_bytes()
                for n, st in sorted(sim.lan1.stats.items())}
        check(lan1[sched["leader"]] == 0 and lan1[sched["old_leader"]] == 0
              and min(lan1[d] for d in sim.diss_ids) > 0,
              f"train/smr: LAN-1 bytes {lan1}")
        # ordering does not depend on the device
        stub, stub_sched, des_s = smr_stub_run(stub_dir)
        check(stub.sim.executed_sequences() == sim.executed_sequences()
              and stub_sched["leader"] == sched["leader"]
              and stub_sched["des_time"] == sched["des_time"]
              and all(stub.pods[p].applied == svc.pods[p].applied
                      for p in svc.pods),
              "train/smr: the card's executed sequences differ from the "
              "stub run's on the CPU")
        sites = sorted(set(sim.site_map.values()))
        # the service's steps after the first; the replay's shared the
        # card with the hashing threads' copies
        timed_steps = steps[1:n_steps]
        sec = sum(s["seconds"] for s in timed_steps) / len(timed_steps)
        res = dict(
            arch=cfg.name, layers=cfg.n_layers,
            reduced=f"n_layers {full.n_layers} -> {cfg.n_layers} (two "
                    "pods' states and a restore template on one card; "
                    "the run's time limit)",
            d_model=cfg.d_model, vocab=cfg.vocab, batch=SMR_B, seq=SMR_S,
            microbatches=micro, optimizer=opt.kind, lr=opt.lr,
            steps=steps, steps_applied=n_steps,
            replica_leaves_compared=n_tensors, seconds_per_step=sec,
            tokens_per_s=SMR_B * SMR_S / sec,
            launches_per_step=want, launches=counts,
            losses=losses, digest=digests[0], state_digest=digests[1],
            ckpt_save_seconds=walls["save"],
            ckpt_restore_seconds=walls["restart"],
            service_run_seconds=walls["run"],
            service_host_seconds=walls["run"] - walls["save"]
            - sum(s["seconds"] for s in steps[:n_steps]),
            des_host_seconds=des_s, des_time=sched["des_time"],
            leaders=[sched["old_leader"], sched["leader"]],
            peak_mem_bytes=peak,
            lan1_bytes=lan1,
            lan2_bytes={n: st.total_bytes()
                        for n, st in sorted(sim.lan2.stats.items())},
            lan_msgs={n: sim.node_total_msgs(n) for n in lan1},
            site_msgs={n: sim.site_total_msgs(n) for n in sites},
            site_bytes={n: sim.site_total_bytes(n) for n in sites},
            card=nvidia_smi(), seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        shutil.rmtree(stub_dir, ignore_errors=True)
    check(not Path(directory).exists() and not Path(stub_dir).exists(),
          f"{directory} or {stub_dir} was not deleted")
    log(phase="train/smr", **res)
    del svc
    torch.cuda.empty_cache()
    return res


RWKV_ARCH = "rwkv6-3b"
# train/rwkv6-3b: full width and depth, bf16, Adafactor at TRAIN_LR; the
# reference's train_4k cell (seq 4096, batch 256) with the batch cut to 4,
# in its 4 microbatches (configs/rwkv6_3b.py); one fixed batch as
# RWKV_TRAIN_STEPS STEP commands (1 warm-up, then timed)
RWKV_TRAIN_B = 4
RWKV_TRAIN_STEPS = 3
RWKV_F32_LAYERS = 2


def rwkv_train_phase(dev) -> dict:
    """train/rwkv6-3b: full width and depth in bf16, RWKV_TRAIN_B x
    TRAIN_S tokens a step in the reference's microbatches, Adafactor,
    through make_train_step inside a TrainerStateMachine fed by a
    two-group MergedCommandLog: RWKV_TRAIN_STEPS STEP commands of one
    fixed batch, each timed with CUDA events, with exactly 2 L m WKV6
    forward launches (forward and recompute), L m WKV6 backward launches
    and no flash launch a step, a finite grad norm and a loss below the
    one before. A second pod applies the same decisions fed in the
    reverse order and must end equal, leaf for leaf (torch.equal). Then
    one more step of pod 0 under torch.profiler: the device time of
    each backward pass and its share of the step."""
    from repro_torch.configs import registry
    from repro_torch.runtime.data import ShardedBatchSource
    from repro_torch.runtime.statemachine import (MergedCommandLog,
                                                  TrainerStateMachine)
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    t_phase = time.perf_counter()
    cfg = registry.get(RWKV_ARCH)
    micro = registry.microbatches(RWKV_ARCH, "train_4k")
    opt = O.OptConfig(kind=O.choose_optimizer(1e12), lr=TRAIN_LR)
    step_fn = TR.make_train_step(cfg, opt, microbatches=micro,
                                 global_batch=RWKV_TRAIN_B)
    batch = ShardedBatchSource(cfg.vocab, RWKV_TRAIN_B, TRAIN_S,
                               seed=SEED + 41, device=dev).batch(0)
    store = {f"b_{i}": batch for i in range(RWKV_TRAIN_STEPS)}
    decided = train_decisions(RWKV_TRAIN_STEPS)
    want = {"wkv6_chunked": 2 * cfg.n_layers * micro,
            "wkv6_chunked_bwd": cfg.n_layers * micro}

    def pod(name):
        return TrainerStateMachine(name, step_fn, TR.make_state(
            cfg, opt, torch.Generator(dev).manual_seed(SEED), dev), store)

    resident = fresh_peak()
    t0 = time.perf_counter()
    a = pod("pod0")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = []

    def timed_apply(cmd):
        before = model_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        a.apply(cmd)
        end.record()
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in model_counts().items()}
        steps.append(dict(seconds=start.elapsed_time(end) / 1e3,
                          launches=launched, **a.metrics_log[-1]))
        check(launched == {**dict.fromkeys(launched, 0), **want},
              f"train/{RWKV_ARCH} step {len(steps)} launched {launched}, "
              f"expected {want}")

    # the main path: counts set to 0 right before, read right after
    reset_counts()
    log_a = MergedCommandLog(2, apply=timed_apply)
    for g, i, cmd in decided:
        log_a.feed(g, i, cmd)
    counts = model_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in steps]
    check(a.step == RWKV_TRAIN_STEPS and log_a.audit() == []
          and counts["wkv6_chunked_bwd"] == RWKV_TRAIN_STEPS
          * want["wkv6_chunked_bwd"]
          and all(np.isfinite([st[k] for st in steps
                               for k in ("loss", "grad_norm")]))
          and all(y < x for x, y in zip(losses, losses[1:])),
          f"train/{RWKV_ARCH}: step {a.step}, counts {counts}, losses "
          f"{losses}, grad norms {[st['grad_norm'] for st in steps]}")
    timed = steps[1:]
    sec = sum(st["seconds"] for st in timed) / len(timed)
    split = {"pod0": time.perf_counter() - t_phase}

    # the replica: the same decisions in the reverse feed order
    b = pod("pod1")
    log_b = MergedCommandLog(2, apply=b.apply)
    for g, i, cmd in decided[::-1]:
        log_b.feed(g, i, cmd)
    same, n_tensors = leaves_equal(a.state, b.state)
    check(same and log_b.audit() == [] and log_a.merged == log_b.merged
          and a.metrics_log == b.metrics_log,
          f"train/{RWKV_ARCH}: pods differ (leaves equal {same}, merged "
          f"logs equal {log_a.merged == log_b.merged})")
    del b, log_b
    torch.cuda.empty_cache()
    split["pod1"] = time.perf_counter() - t_phase - sum(split.values())

    # one more step of pod 0, traced: device time of each WKV6 pass
    wall = {}

    def one_step():
        t1 = time.perf_counter()
        step_fn(a.state, batch)
        torch.cuda.synchronize()
        wall["us"] = (time.perf_counter() - t1) * 1e6
    events = device_kernels(one_step, 1, WKV_BWD_PREFIX,
                            len(WKV_BWD_PHASES) * want["wkv6_chunked_bwd"])
    fwd_us = {p: [us for name, us in events if p in name]
              for p in WKV_PHASES}
    bwd_us = {p: [us for name, us in events if p in name]
              for p in WKV_BWD_PHASES}
    check(all(len(v) == want["wkv6_chunked"] for v in fwd_us.values())
          and all(len(v) == want["wkv6_chunked_bwd"]
                  for v in bwd_us.values())
          and not any("flash" in name for name, _ in events),
          f"train/{RWKV_ARCH} profile: "
          f"{ {k: len(v) for k, v in {**fwd_us, **bwd_us}.items()} } "
          "WKV6 events")
    busy = sum(us for _, us in events)
    fwd_total = sum(sum(v) for v in fwd_us.values())
    bwd_total = sum(sum(v) for v in bwd_us.values())
    by_name = {}
    for name, us in events:
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + us
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = dict(
        arch=cfg.name, layers=cfg.n_layers, batch=RWKV_TRAIN_B, seq=TRAIN_S,
        microbatches=micro, optimizer=opt.kind, lr=opt.lr,
        cuts={"batch": [256, RWKV_TRAIN_B]}, init_seconds=init_s,
        steps=steps, seconds_per_step=sec,
        tokens_per_s=RWKV_TRAIN_B * TRAIN_S / sec, peak_mem_bytes=peak,
        resident_at_start_bytes=resident, launches_per_step=want,
        launches=counts, replica_leaves_compared=n_tensors,
        profiled_step=dict(
            wall_us=wall["us"], device_us=busy,
            device_busy_share=busy / wall["us"],
            wkv_fwd_us_per_call=fwd_total / want["wkv6_chunked"],
            wkv_bwd_us_per_call=bwd_total / want["wkv6_chunked_bwd"],
            wkv_bwd_pass_us_per_call={
                k: sum(v) / len(v) for k, v in bwd_us.items()},
            wkv_fwd_share=fwd_total / busy, wkv_bwd_share=bwd_total / busy,
            wkv_bwd_pass_share={k: sum(v) / busy
                                for k, v in bwd_us.items()},
            heaviest_kernels=[dict(name=n, us=us, share=us / busy)
                              for n, us in heaviest]))
    del a, log_a, store, batch
    torch.cuda.empty_cache()
    split["traced_step"] = time.perf_counter() - t_phase - sum(split.values())
    res["f32"] = rwkv_train_f32_phase(dev)
    split["f32"] = time.perf_counter() - t_phase - sum(split.values())
    res.update(split_seconds=split, seconds=time.perf_counter() - t_phase)
    log(phase=f"train/{RWKV_ARCH}", **res)
    return res


def rwkv_train_f32_phase(dev) -> dict:
    """train/rwkv6-3b/f32: rwkv6-3b at RWKV_F32_LAYERS layers, full width,
    f32, one AdamW step of F32_TRAIN_B x F32_TRAIN_S tokens on the card and
    on the CPU from one set of weights (:func:`f32_states`), with 2 L
    WKV6 forward and L backward launches on the card:
    :func:`f32_step_vs_cpu`."""
    from repro_torch.configs import registry
    from repro_torch.runtime.data import ShardedBatchSource
    from repro_torch.train import optimizer as O
    cfg = registry.get(RWKV_ARCH).replace(n_layers=RWKV_F32_LAYERS,
                                          dtype=F32)
    opt = O.OptConfig(kind="adamw", lr=TRAIN_LR)
    cpu, card = f32_states(cfg, opt, dev)
    tokens = ShardedBatchSource(cfg.vocab, F32_TRAIN_B, F32_TRAIN_S,
                                seed=SEED + 42, device="cpu").batch(0)
    return f32_step_vs_cpu(f"train/{RWKV_ARCH}/f32", cfg, opt, cpu, card,
                           tokens, want={
                               "wkv6_chunked": 2 * cfg.n_layers,
                               "wkv6_chunked_bwd": cfg.n_layers})


# -- the vision-language family: qwen2-vl-7b ----------------------------------

VLM_ARCH = "qwen2-vl-7b"
# Qwen2-VL layouts (M-RoPE ids as in arXiv:2409.12191, section 2.1): text
# and images of rows x cols patches from the stub frontend
VLM_PREFILL = (("text", 32), ("image", 32, 30), ("text", 32))    # 1,024
# the teacher-forced decode at full depth runs over 192 positions, not
# 1,024: the decode is host-bound (~70 ms a step at yi-6b)
VLM_PROMPT = (("text", 32), ("image", 8, 16), ("text", 32))
VLM_NEW = 32
VLM_CPU_B = 2
VLM_CPU_PROMPT = (("text", 16), ("image", 4, 8), ("text", 16))   # 64
VLM_PATCH_STD = 0.02          # the embedding table's init scale
VLM_F32_LAYERS = 2
# apply_rope on the card against the CPU port: f32 sin/cos of the same
# angles, relative to max |x|; and the least largest difference on the
# image's rows between M-RoPE and the rotation by the cache index
ROPE_TOL = 2e-5
ROPE_SECTIONS_DIFFER = 0.1
# train/qwen2-vl-7b: full width with the depth cut 28 -> 4 (the phase's
# time and memory budget); train_4k's sequence of 4,096 with its batch
# cut 256 -> TRAIN_B; the registry's microbatches (2); Adafactor
VLM_TRAIN_LAYERS = 4
VLM_TRAIN_LAYOUT = (("text", 64), ("image", 48, 40), ("text", 64),
                    ("image", 48, 40), ("text", 128))             # 4,096
VLM_TRAIN_STEPS = 4           # 1 warm-up + 3 timed
# the f32 step, card vs CPU: VLM_F32_LAYERS layers, 1 x 256 positions
VLM_F32_TRAIN_LAYOUT = (("text", 32), ("image", 12, 16), ("text", 32))


def fresh_peak() -> int:
    """Free what earlier phases left unreachable (the training service's
    pods sit in reference cycles), reset the peak-memory counter and
    return the bytes still allocated, which the phase's peak includes."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def layout_image_rows(layout) -> torch.Tensor:
    """bool [S]: the positions of ``layout`` that hold image patches."""
    return torch.cat([torch.full((seg[1] if seg[0] == "text"
                                  else seg[1] * seg[2],), seg[0] == "image")
                      for seg in layout])


def vlm_inputs(lm, cfg, layout, batch: int, gen, dev) -> dict:
    """The stub frontend's batch for ``layout``: token ids drawn from
    ``gen`` (``labels``), their rows of the embedding table at the text
    positions and patch embeddings (normal x VLM_PATCH_STD, from ``gen``)
    at the image positions (``embeds``, cfg.dtype), the layout's M-RoPE
    ids [3, batch, S] (``positions``) and the id of the next text token
    (``next``)."""
    from repro_torch.models import layers as L
    pos, nxt = L.mrope_positions(layout, batch, dev)
    S = pos.shape[-1]
    tokens = torch.randint(0, cfg.vocab, (batch, S), generator=gen,
                           device=dev)
    patches = randn(gen, (batch, S, cfg.d_model), dev, cfg.dtype,
                    VLM_PATCH_STD)
    image = layout_image_rows(layout).to(dev)[None, :, None]
    with torch.no_grad():
        embeds = torch.where(image, patches,
                             L.embed_apply(lm["embed"], tokens))
    return {"embeds": embeds, "positions": pos, "labels": tokens,
            "next": nxt}


def vlm_teacher_forced(lm, cfg, inputs: dict, cache):
    """decode_step over every position of ``inputs`` (embeds, positions):
    step t writes cache slot t and rotates by positions[:, :, t]; the
    logits of every step."""
    from repro_torch.models import decode as D
    out = []
    for t in range(inputs["embeds"].shape[1]):
        logits, cache = D.decode_step(lm, cfg, {
            "embeds": inputs["embeds"][:, t:t + 1],
            "positions": inputs["positions"][:, :, t:t + 1],
            "index": t}, cache)
        out.append(logits)
    return torch.stack(out, dim=1)


def vlm_rope_check(dev, cfg) -> dict:
    """apply_rope with VLM_PREFILL's [3, B, S] ids on the card against the
    CPU port (within ROPE_TOL x max |x|) and against the rotation by the
    cache index: equal on the first text rows, where the ids are the
    index, and farther than ROPE_SECTIONS_DIFFER x max |x| on the
    image's rows."""
    from repro_torch.models import layers as L
    pos, _ = L.mrope_positions(VLM_PREFILL, SERVE_B, dev)
    S = pos.shape[-1]
    x = randn(torch.Generator(dev).manual_seed(SEED + 22),
              (SERVE_B, S, cfg.n_heads, cfg.hd), dev)
    scale = float(x.abs().max())
    got = L.apply_rope(x, pos, cfg.rope_theta, cfg.mrope_sections)
    want = L.apply_rope(x.cpu(), pos.cpu(), cfg.rope_theta,
                        cfg.mrope_sections)
    index = torch.arange(S, device=dev)[None].expand(SERVE_B, S)
    plain = L.apply_rope(x, index, cfg.rope_theta, cfg.mrope_sections)
    diff = (got - plain).abs().amax(dim=(0, 2, 3)).cpu()           # [S]
    image = layout_image_rows(VLM_PREFILL)
    first_text = VLM_PREFILL[0][1]
    res = dict(shape=list(x.shape), max_abs_x=scale,
               card_vs_cpu=float((got.cpu() - want).abs().max()),
               first_text_vs_index=float(diff[:first_text].max()),
               image_vs_index=float(diff[image].max()),
               image_rows_over_gap=float((diff[image] > ROPE_SECTIONS_DIFFER
                                          * scale).float().mean()),
               tolerance=ROPE_TOL, sections_differ=ROPE_SECTIONS_DIFFER)
    check(res["card_vs_cpu"] <= ROPE_TOL * scale
          and res["first_text_vs_index"] <= ROPE_TOL * scale
          and res["image_vs_index"] > ROPE_SECTIONS_DIFFER * scale,
          f"serve/{VLM_ARCH}: apply_rope {res}")
    return res


def vlm_f32_checks(dev) -> dict:
    """VLM_F32_LAYERS layers at full width in f32: prefill of VLM_PROMPT
    (VLM_F32_LAYERS f32 flash launches) against its teacher-forced decode
    (no model kernel) within F32_LOGIT_TOL with equal greedy tokens; the
    card against the CPU port (prefill and every decode step of
    VLM_CPU_PROMPT, VLM_CPU_B rows) within CPU_LOGIT_TOL; the layer-level
    M-RoPE check (:func:`vlm_rope_check`)."""
    from repro_torch.configs import registry
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not run in TF32")
    cfg = registry.get(VLM_ARCH).replace(n_layers=VLM_F32_LAYERS, dtype=F32)
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    gen = torch.Generator(dev).manual_seed(SEED + 21)
    prompt = vlm_inputs(lm, cfg, VLM_PROMPT, SERVE_B, gen, dev)
    P = prompt["positions"].shape[-1]
    before = model_counts()
    pre, _ = D.prefill(lm, cfg, {k: prompt[k] for k in ("embeds",
                                                        "positions")})
    launched = {n: c - before[n] for n, c in model_counts().items()}
    check(launched == {**dict.fromkeys(launched, 0),
                       "flash_attention_f32": VLM_F32_LAYERS},
          f"serve/{VLM_ARCH}/f32: prefill launched {launched}")
    before = model_counts()
    dec = vlm_teacher_forced(lm, cfg, prompt, D.cache_zeros(
        D.cache_spec(cfg, SERVE_B, P), dev))[:, -1]
    check(model_counts() == before,
          f"serve/{VLM_ARCH}/f32: the decode launched a model kernel")
    f32_err = float((pre - dec).abs().max())
    same = bool(torch.equal(pre.argmax(-1), dec.argmax(-1)))
    check(f32_err <= F32_LOGIT_TOL and same
          and bool(torch.isfinite(pre).all()),
          f"serve/{VLM_ARCH}/f32: prefill vs teacher-forced decode over "
          f"{P} positions: max abs err {f32_err}, same greedy {same}")
    # the card against the port on the CPU, on one set of weights
    lm_cpu = f32_copy(lm, "cpu")
    short = vlm_inputs(lm, cfg, VLM_CPU_PROMPT, VLM_CPU_B, gen, dev)
    S = short["positions"].shape[-1]
    outs = []
    for model, d in ((lm_cpu, torch.device("cpu")), (lm, dev)):
        inp = {k: short[k].to(d) for k in ("embeds", "positions")}
        logits, _ = D.prefill(model, cfg, inp)
        steps = vlm_teacher_forced(model, cfg, inp, D.cache_zeros(
            D.cache_spec(cfg, VLM_CPU_B, S), d))
        outs.append(torch.cat([logits[:, None], steps], dim=1).cpu())
    cpu_err = float((outs[0] - outs[1]).abs().max())
    check(cpu_err <= CPU_LOGIT_TOL and bool(torch.isfinite(outs[1]).all()),
          f"serve/{VLM_ARCH}/f32: card vs CPU max abs err {cpu_err}")
    res = dict(layers=VLM_F32_LAYERS, prompt=P, batch=SERVE_B,
               prefill_vs_decode=f32_err, tolerance=F32_LOGIT_TOL,
               greedy_tokens=pre.argmax(-1).tolist(),
               logits_max_abs=float(pre.abs().max()),
               launches=launched["flash_attention_f32"],
               cpu=dict(batch=VLM_CPU_B, prompt=S, decode_steps=S,
                        max_abs_err=cpu_err, tolerance=CPU_LOGIT_TOL),
               rope=vlm_rope_check(dev, cfg))
    del lm, lm_cpu
    torch.cuda.empty_cache()
    return res


def vlm_serve_phase(dev) -> dict:
    """serve/qwen2-vl-7b: full width and depth in bf16, SERVE_B rows, the
    stub frontend's embeddings. (a) Prefill over VLM_PREFILL: exactly L
    bf16 flash launches and no other model kernel, finite logits,
    CUDA-event time; (b) the teacher-forced decode of VLM_PROMPT at full
    depth, which fills the cache; (c) VLM_NEW greedy text steps at
    positions that continue the layout: finite logits, no model kernel;
    (d) :func:`vlm_f32_checks`."""
    from repro_torch.configs import registry
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = registry.get(VLM_ARCH)
    resident = fresh_peak()
    t0 = time.perf_counter()
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    gen = torch.Generator(dev).manual_seed(SEED + 20)
    pre = vlm_inputs(lm, cfg, VLM_PREFILL, SERVE_B, gen, dev)
    prompt = vlm_inputs(lm, cfg, VLM_PROMPT, SERVE_B, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    inputs = {k: pre[k] for k in ("embeds", "positions")}
    S = inputs["positions"].shape[-1]

    # (a) the path: counts set to 0 right before, read right after
    reset_counts()
    t0 = time.perf_counter()
    logits_p, _ = D.prefill(lm, cfg, inputs)
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    launches = model_counts()
    check(launches["flash_attention"] == cfg.n_layers
          and sum(launches.values()) == cfg.n_layers,
          f"{VLM_ARCH} prefill launched {launches}, expected "
          f"{cfg.n_layers} x flash_attention")
    check(tuple(logits_p.shape) == (SERVE_B, cfg.vocab)
          and bool(torch.isfinite(logits_p).all()),
          f"{VLM_ARCH}: prefill logits {tuple(logits_p.shape)} not finite")
    prefill_ms = time_cuda(lambda: D.prefill(lm, cfg, inputs), reps=3,
                           warmup=1)
    check(model_counts()["flash_attention"] == 5 * cfg.n_layers,
          f"{VLM_ARCH}: timed prefills launched {model_counts()}")
    counts = model_counts()

    # (b) the teacher-forced decode of the prompt at full depth
    P = prompt["positions"].shape[-1]
    cache = D.cache_zeros(D.cache_spec(cfg, SERVE_B, P + VLM_NEW), dev)
    t0 = time.perf_counter()
    logits_d = vlm_teacher_forced(lm, cfg, prompt, cache)[:, -1]
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits_d).all()),
          f"{VLM_ARCH}: teacher-forced decode logits not finite")

    # (c) greedy text steps: one id in all three streams, after the
    # layout's largest; the cache slot after the prompt's
    tok = logits_d.argmax(-1)[:, None]
    ids = torch.arange(prompt["next"], prompt["next"] + VLM_NEW,
                       dtype=torch.int32, device=dev)
    all_finite = torch.ones((), dtype=torch.bool, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(VLM_NEW):
        logits, cache = D.decode_step(lm, cfg, {
            "token": tok, "index": P + i,
            "positions": ids[i].expand(3, SERVE_B, 1)}, cache)
        all_finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)[:, None]
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / VLM_NEW
    check(bool(all_finite), f"{VLM_ARCH}: greedy decode logits not finite")
    check(model_counts() == counts,
          f"{VLM_ARCH}: decode launched a model kernel: {model_counts()}")
    peak = torch.cuda.max_memory_allocated()
    del lm, cache, pre, prompt, inputs
    torch.cuda.empty_cache()

    # (d) exactness at VLM_F32_LAYERS layers in f32
    exact = vlm_f32_checks(dev)
    res = dict(arch=VLM_ARCH, params=n_params, batch=SERVE_B, prefill=S,
               layout=dict(prefill=VLM_PREFILL, prompt=VLM_PROMPT,
                           cpu=VLM_CPU_PROMPT), prompt=P,
               new_tokens=VLM_NEW, init_seconds=init_s,
               prefill_first_seconds=prefill_first_s,
               launches={"flash_attention": launches["flash_attention"]},
               prefill_ms=prefill_ms,
               prefill_tokens_per_s=SERVE_B * S / (prefill_ms / 1e3),
               teacher_forced_seconds=tf_s,
               teacher_forced_ms_per_step=tf_s * 1e3 / P,
               decode_ms_per_step=decode_ms,
               decode_tokens_per_s=SERVE_B / (decode_ms / 1e3),
               peak_mem_bytes=peak, resident_at_start_bytes=resident,
               f32=exact, seconds=time.perf_counter() - t_phase)
    log(phase=f"serve/{VLM_ARCH}", **res)
    return res


def vlm_train_phase(dev) -> dict:
    """train/qwen2-vl-7b: full width, VLM_TRAIN_LAYERS layers, bf16,
    Adafactor at TRAIN_LR; one fixed batch of VLM_TRAIN_LAYOUT (TRAIN_B x
    4,096 positions: embeds, [3, B, S] positions, labels) split into the
    registry's microbatches on the card. VLM_TRAIN_STEPS steps timed with
    CUDA events: each loss below the one before, finite grad norms,
    exactly 2 L m forward and L m backward bf16 flash launches a step.
    Then one f32 step at VLM_F32_LAYERS layers, card vs CPU
    (:func:`f32_step_vs_cpu`)."""
    from repro_torch.configs import registry
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    t_phase = time.perf_counter()
    cfg = registry.get(VLM_ARCH).replace(n_layers=VLM_TRAIN_LAYERS)
    micro = registry.microbatches(VLM_ARCH, "train_4k")
    opt = O.OptConfig(kind=O.choose_optimizer(1e12), lr=TRAIN_LR)
    step_fn = TR.make_train_step(cfg, opt, microbatches=micro,
                                 global_batch=TRAIN_B)
    resident = fresh_peak()
    state = TR.make_state(cfg, opt, torch.Generator(dev).manual_seed(SEED),
                          dev)
    batch = vlm_inputs(state["params"], cfg, VLM_TRAIN_LAYOUT, TRAIN_B,
                       torch.Generator(dev).manual_seed(SEED + 23), dev)
    batch = {k: batch[k] for k in ("embeds", "positions", "labels")}
    split = TR._split_microbatch(batch["positions"], micro, TRAIN_B)
    check(tuple(batch["positions"].shape) == (3, TRAIN_B, TRAIN_S)
          and tuple(split.shape) == (micro, 3, TRAIN_B // micro, TRAIN_S)
          and split.device == batch["positions"].device,
          f"train/{VLM_ARCH}: positions "
          f"{tuple(batch['positions'].shape)} split as "
          f"{tuple(split.shape)}")
    split_shape = list(split.shape)
    del split
    want = {"flash_attention": 2 * cfg.n_layers * micro,
            "flash_attention_bwd": cfg.n_layers * micro}

    # the path: counts set to 0 right before, read right after
    reset_counts()
    steps = []
    for _ in range(VLM_TRAIN_STEPS):
        before = model_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, m = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in model_counts().items()}
        steps.append(dict(seconds=start.elapsed_time(end) / 1e3,
                          launches=launched, loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"])))
        check(launched == {**dict.fromkeys(launched, 0), **want},
              f"train/{VLM_ARCH} step {len(steps)} launched {launched}, "
              f"expected {want}")
    counts = model_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in steps]
    check(all(np.isfinite([st[k] for st in steps
                           for k in ("loss", "grad_norm")]))
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"train/{VLM_ARCH}: losses {losses}, grad norms "
          f"{[st['grad_norm'] for st in steps]}")
    timed = steps[1:]
    sec = sum(st["seconds"] for st in timed) / len(timed)
    del state, batch
    torch.cuda.empty_cache()

    # the f32 step, card vs CPU, on one set of weights (drawn on the card)
    cfg32 = registry.get(VLM_ARCH).replace(n_layers=VLM_F32_LAYERS,
                                           dtype=F32)
    opt32 = O.OptConfig(kind="adamw", lr=TRAIN_LR)
    cpu, card = f32_states(cfg32, opt32, dev)
    inp = vlm_inputs(cpu["params"], cfg32, VLM_F32_TRAIN_LAYOUT,
                     F32_TRAIN_B, torch.Generator().manual_seed(SEED + 24),
                     torch.device("cpu"))
    f32 = f32_step_vs_cpu(f"train/{VLM_ARCH}/f32", cfg32, opt32, cpu, card,
                          {k: inp[k] for k in ("embeds", "positions",
                                               "labels")})
    del card, cpu
    S = TRAIN_S
    res = dict(arch=VLM_ARCH, layers=cfg.n_layers,
               cuts={"layers": [registry.get(VLM_ARCH).n_layers,
                                cfg.n_layers],
                     "batch": [256, TRAIN_B]},
               batch=TRAIN_B, seq=S, layout=VLM_TRAIN_LAYOUT,
               microbatches=micro, positions_split=split_shape,
               optimizer=opt.kind, lr=opt.lr,
               steps=steps, seconds_per_step=sec,
               tokens_per_s=TRAIN_B * S / sec, peak_mem_bytes=peak,
               resident_at_start_bytes=resident,
               launches_per_step=want, launches=counts, f32=f32,
               seconds=time.perf_counter() - t_phase)
    log(phase=f"train/{VLM_ARCH}", **res)
    return res


# -- the MoE family: llama4-maverick-400b-a17b -------------------------------

MOE_ARCH = "llama4-maverick-400b-a17b"
# serve/llama4: full width with all 128 experts, the depth cut 48 -> 2 (one
# dense/MoE pair): one MoE layer's routed experts are 3 x 128 x 5120 x 8192
# bf16 = 32.2 GB, the pair with both embedding tables 37.4 GB
MOE_SERVE_LAYERS = 2
# the f32 checks (serving and the train step): one pair, the experts cut
# 128 -> 8 (f32 weights on the card and a copy on the host), 1 x 256; the
# train step's positions cut to 128 (its host half, AdamW over 14.3 GB of
# f32 state, takes over a minute)
MOE_F32_EXPERTS = 8
MOE_F32_B, MOE_F32_S, MOE_F32_TRAIN_S = 1, 256, 128
# card against CPU in f32: a token may take another expert on the two only
# where its top-2 router probabilities are closer than this (f32 rounding
# moves them by ~1e-7)
MOE_FLIP_MARGIN = 1e-4
# train/llama4: full width, one pair, the experts cut 128 -> 16 (bf16
# weights, f32 accumulators, .grad and Adafactor's state fit one card);
# train_4k's sequence with its batch cut 256 -> TRAIN_B, and its 16
# microbatches cut to the batch
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_EXPERTS = 16
MOE_TRAIN_STEPS = 4           # 1 warm-up + 3 timed


class MoeRecorder:
    """Records each MoE dispatch of the port while active: its routing
    (``layers.moe_route``) and whether PyTorch's deterministic mode was
    on, and the auxiliary loss of each ``moe_apply`` that returned (a
    checkpoint's recompute stops inside it, so it records a route and no
    aux)."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.route0, self.apply0 = L, L.moe_route, L.moe_apply
        self.routes, self.auxs, self.deterministic = [], [], []

        def route(*a):
            r = self.route0(*a)
            # detached: a recorded route must not keep the step's graph
            self.routes.append(r._replace(probs=r.probs.detach(),
                                          gate=r.gate.detach()))
            self.deterministic.append(
                torch.are_deterministic_algorithms_enabled())
            return r

        def apply(*a):
            y, aux = self.apply0(*a)
            self.auxs.append(aux.detach())
            return y, aux
        L.moe_route, L.moe_apply = route, apply
        return self

    def __exit__(self, *exc):
        self.L.moe_route, self.L.moe_apply = self.route0, self.apply0

    def stats(self) -> list:
        """Per dispatch: tokens, capacity, dropped choices, the largest
        expert load."""
        return [dict(tokens=int(r.probs.shape[0]), capacity=r.capacity,
                     dropped=int((~r.keep).sum()),
                     max_load=int(r.counts.max())) for r in self.routes]


def flip_aware(cpu_routes, card_routes) -> tuple:
    """The flip-aware routing rule, card against CPU, for top-k routing:
    (1) each token's set of k experts and the keep mask of its choices
    (each choice taken by its expert, so the order of a token's choices,
    which no slot depends on, may differ); (2) a token whose set differs
    must have a router margin (on the CPU) between its k-th and (k+1)-th
    probabilities below MOE_FLIP_MARGIN (for k = 1 the top-2 margin);
    returns (bool [T] per dispatch: the tokens whose experts and keep
    agree, the flipped count, the largest flipped margin)."""
    rows, flips, worst = [], 0, 0.0
    check(len(cpu_routes) == len(card_routes),
          f"{len(cpu_routes)} dispatches on the CPU, {len(card_routes)} on "
          "the card")
    for a, b in zip(cpu_routes, card_routes):
        T_, k = a.gate.shape
        top = torch.topk(a.probs, k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]

        def by_expert(r):
            e = r.expert.cpu().reshape(T_, k)
            order = torch.argsort(e, dim=-1)
            return (torch.gather(e, 1, order),
                    torch.gather(r.keep.cpu().reshape(T_, k), 1, order))
        (ea, ka), (eb, kb) = by_expert(a), by_expert(b)
        flipped = (ea != eb).any(dim=-1)
        if bool(flipped.any()):
            flips += int(flipped.sum())
            worst = max(worst, float(gap[flipped].max()))
        rows.append(~flipped & (ka == kb).all(dim=-1))
    check(worst < MOE_FLIP_MARGIN,
          f"a token took another expert at a top-2 margin of {worst} "
          f"(rule: < {MOE_FLIP_MARGIN})")
    return rows, flips, worst


def moe_f32_checks(dev) -> dict:
    """One pair in f32 at full width with MOE_F32_EXPERTS experts,
    MOE_F32_B x MOE_F32_S tokens. (a) The prefill's forward (logits at
    every position; 2 f32 flash launches) against the teacher-forced
    decode (no model kernel; every step one token at C = 8, nothing
    dropped), at the positions the prefill kept, within F32_LOGIT_TOL;
    the dropped ones are skipped and counted. (b) The card against the
    CPU port under the flip-aware rule: the logits of the tokens whose
    expert and keep mask agree within CPU_LOGIT_TOL, and aux."""
    from repro_torch.configs import registry
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not run in TF32")
    cfg = registry.get(MOE_ARCH).replace(n_layers=MOE_SERVE_LAYERS,
                                         n_experts=MOE_F32_EXPERTS,
                                         dtype=F32)
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    toks = torch.randint(0, cfg.vocab, (MOE_F32_B, MOE_F32_S), device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED + 31))
    pos = torch.arange(MOE_F32_S, device=dev)[None].expand(MOE_F32_B,
                                                           MOE_F32_S)

    def forward(model, d):
        with torch.no_grad(), MoeRecorder() as rec:
            x = L.embed_apply(model["embed"], toks.to(d))
            hidden, aux = T.backbone_forward(model, cfg, x, pos.to(d))
            logits = L.logits_apply(model["embed"], hidden,
                                    cfg.tie_embeddings)
        return logits, float(aux), rec

    before = model_counts()
    full, aux, rec = forward(lm, dev)
    launched = {n: c - before[n] for n, c in model_counts().items()}
    check(launched == {**dict.fromkeys(launched, 0),
                       "flash_attention_f32": MOE_SERVE_LAYERS},
          f"serve/{MOE_ARCH}/f32: the forward launched {launched}")
    last, _ = D.prefill(lm, cfg, {"tokens": toks})
    (route,) = rec.routes
    keep = route.keep.reshape(MOE_F32_B, MOE_F32_S)
    before = model_counts()
    cache = D.cache_zeros(D.cache_spec(cfg, MOE_F32_B, MOE_F32_S), dev)
    steps = []
    with MoeRecorder() as drec:
        for t in range(MOE_F32_S):
            logits, cache = D.decode_step(
                lm, cfg, {"token": toks[:, t:t + 1], "index": t}, cache)
            steps.append(logits)
    dec = torch.stack(steps, dim=1)
    check(model_counts() == before,
          f"serve/{MOE_ARCH}/f32: the decode launched a model kernel")
    check(all(s["dropped"] == 0
              and s["capacity"] == L.moe_capacity(MOE_F32_B, cfg)
              for s in drec.stats()),
          f"serve/{MOE_ARCH}/f32: a decode step dropped a token")
    diff = (full - dec).abs().amax(dim=-1)                  # [B, S]
    kept_err = float(diff[keep].max())
    check(kept_err <= F32_LOGIT_TOL
          and float((last - full[:, -1]).abs().max()) <= F32_LOGIT_TOL
          and bool(torch.isfinite(full).all()),
          f"serve/{MOE_ARCH}/f32: prefill vs teacher-forced decode at the "
          f"kept positions: max abs err {kept_err}")
    # the card against the CPU port, on one set of weights
    lm_cpu = f32_copy(lm, "cpu")
    t0 = time.perf_counter()
    full_cpu, aux_cpu, rec_cpu = forward(lm_cpu, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    (rows,), flips, worst = flip_aware(rec_cpu.routes, rec.routes)
    rows = rows.reshape(MOE_F32_B, MOE_F32_S)
    cpu_diff = (full.cpu() - full_cpu).abs().amax(dim=-1)
    cpu_err = float(cpu_diff[rows].max())
    aux_err = abs(aux - aux_cpu) / aux_cpu
    check(cpu_err <= CPU_LOGIT_TOL and aux_err <= F32_STEP_TOL["loss"],
          f"serve/{MOE_ARCH}/f32: card vs CPU max abs err {cpu_err}, aux "
          f"{aux} vs {aux_cpu}")
    res = dict(layers=cfg.n_layers, experts=cfg.n_experts,
               batch=MOE_F32_B, positions=MOE_F32_S,
               capacity=route.capacity, launches=launched[
                   "flash_attention_f32"],
               prefill_vs_decode=kept_err,
               dropped_positions_skipped=int((~keep).sum()),
               dropped_vs_decode_min=float(diff[~keep].min())
               if bool((~keep).any()) else None,
               tolerance=F32_LOGIT_TOL,
               cpu=dict(max_abs_err=cpu_err, tolerance=CPU_LOGIT_TOL,
                        compared_positions=int(rows.sum()), flips=flips,
                        largest_flipped_margin=worst,
                        flip_margin=MOE_FLIP_MARGIN, aux=aux,
                        aux_cpu=aux_cpu, aux_rel_err=aux_err,
                        cpu_seconds=cpu_s))
    del lm, lm_cpu, cache
    torch.cuda.empty_cache()
    return res


def moe_serve_phase(dev) -> dict:
    """serve/llama4-maverick-400b-a17b: full width with all 128 experts,
    MOE_SERVE_LAYERS layers (one pair), bf16, SERVE_B x SERVE_P prompt
    tokens. (a) The prefill: exactly 2 bf16 flash launches and no other
    model kernel, finite logits; the MoE layer's capacity, drops, largest
    expert load and aux; CUDA-event time. (b) ``launch.serve.generate``:
    the prompt teacher-forced through ``decode_step`` (one captured CUDA
    graph a step), then SERVE_NEW greedy steps, no model kernel, no token
    dropped. (c) :func:`moe_f32_checks`."""
    from repro_torch.configs import registry
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    full = registry.get(MOE_ARCH)
    cfg = full.replace(n_layers=MOE_SERVE_LAYERS)
    resident = fresh_peak()
    t0 = time.perf_counter()
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P), device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                SEED + 30))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in lm.parameters())

    # (a) the path: counts set to 0 right before, read right after
    reset_counts()
    t0 = time.perf_counter()
    with MoeRecorder() as rec:
        logits_p, _ = D.prefill(lm, cfg, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    launches = model_counts()
    check(launches["flash_attention"] == cfg.n_layers
          and sum(launches.values()) == cfg.n_layers,
          f"{MOE_ARCH} prefill launched {launches}, expected "
          f"{cfg.n_layers} x flash_attention")
    check(tuple(logits_p.shape) == (SERVE_B, cfg.vocab)
          and bool(torch.isfinite(logits_p).all()),
          f"{MOE_ARCH}: prefill logits {tuple(logits_p.shape)} not finite")
    moe = [dict(s, aux=float(a)) for s, a in zip(rec.stats(), rec.auxs)]
    check(len(moe) == len(rec.routes) == cfg.n_layers // 2 and all(
        s["tokens"] == SERVE_B * SERVE_P
        and s["capacity"] == L.moe_capacity(SERVE_B * SERVE_P, cfg)
        and np.isfinite(s["aux"]) and s["aux"] > 0 for s in moe),
        f"{MOE_ARCH}: prefill dispatches {moe}")
    prefill_ms = time_cuda(lambda: D.prefill(lm, cfg, {"tokens": prompts}),
                           reps=3, warmup=1)
    check(model_counts()["flash_attention"] == 5 * cfg.n_layers,
          f"{MOE_ARCH}: timed prefills launched {model_counts()}")
    counts = model_counts()

    # (b) generate: the prompt teacher-forced, then greedy steps
    steps = SERVE_P + SERVE_NEW - 1
    with MoeRecorder() as drec:
        run = generate_timed(lm, cfg, prompts, SERVE_NEW, keep_logits=False)
    gen, part_ms = run["gen"], run["part_ms"]
    gen_ms = sum(part_ms.values())
    check(model_counts() == counts,
          f"{MOE_ARCH}: decode launched a model kernel: {model_counts()}")
    check(tuple(gen.shape) == (SERVE_B, SERVE_NEW)
          and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab,
          f"{MOE_ARCH}: generated {tuple(gen.shape)}")
    # each decode step is one captured CUDA graph: the recorder sees the
    # capture's warm-up step and the capture itself (whose routing
    # buffers the replays overwrite, so they end with the last step's);
    # a dispatch of B tokens at a capacity of at least B·k drops none
    dstats = drec.stats()
    cap = L.moe_capacity(SERVE_B, cfg)
    check(len(dstats) == 2 * (cfg.n_layers // 2)
          and cap >= SERVE_B * cfg.experts_per_token and all(
              s["tokens"] == SERVE_B and s["capacity"] == cap
              and s["dropped"] == 0 for s in dstats),
          f"{MOE_ARCH}: decode dispatches {dstats} (capacity {cap})")
    peak = torch.cuda.max_memory_allocated()
    del lm, prompts, rec, drec
    torch.cuda.empty_cache()

    # (c) exactness in f32 at the expert cut
    exact = moe_f32_checks(dev)
    res = dict(arch=MOE_ARCH, params=n_params, layers=cfg.n_layers,
               experts=cfg.n_experts,
               cuts={"layers": [full.n_layers, cfg.n_layers],
                     "f32_checks": {"layers": [full.n_layers,
                                               MOE_SERVE_LAYERS],
                                    "experts": [full.n_experts,
                                                MOE_F32_EXPERTS],
                                    "positions": [SERVE_P, MOE_F32_S]}},
               batch=SERVE_B, prompt=SERVE_P, new_tokens=SERVE_NEW,
               init_seconds=init_s, init_peak_bytes=init_peak,
               prefill_first_seconds=prefill_first_s,
               launches={"flash_attention": launches["flash_attention"]},
               moe=moe, prefill_ms=prefill_ms,
               prefill_tokens_per_s=SERVE_B * SERVE_P / (prefill_ms / 1e3),
               generate_seconds=gen_ms / 1e3, decode_steps=steps,
               generate_part_ms=part_ms,
               teacher_forced_ms_per_step=part_ms["prompt"] / SERVE_P,
               decode_ms_per_step=part_ms["greedy"] / (SERVE_NEW - 1),
               decode_tokens_per_s=SERVE_B * (SERVE_NEW - 1)
               / (part_ms["greedy"] / 1e3),
               greedy_tokens=gen[:, :8].tolist(),
               peak_mem_bytes=peak, resident_at_start_bytes=resident,
               f32=exact, seconds=time.perf_counter() - t_phase)
    log(phase=f"serve/{MOE_ARCH}", **res)
    return res


def moe_router_grad(cfg, params, tokens, dev) -> dict:
    """The gradient of the loss on ``tokens`` with respect to each
    router, in deterministic mode: every one nonzero and finite."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import reference_leaves
    from repro_torch.train import trainer as TR
    routers = [p for path, ps, _ in reference_leaves(params)
               if path[-1] == "router" for p in ps]
    with TR.deterministic(dev):
        loss, _ = T.lm_loss(params, cfg, {"tokens": tokens})
        grads = torch.autograd.grad(loss, routers)
    res = dict(routers=len(routers),
               max_abs=[float(g.abs().max()) for g in grads],
               finite=all(bool(torch.isfinite(g).all()) for g in grads))
    check(res["routers"] == cfg.n_layers // 2 and res["finite"]
          and min(res["max_abs"]) > 0,
          f"train/{MOE_ARCH}: the router's gradient {res}")
    return res


def moe_train_phase(dev) -> dict:
    """train/llama4-maverick-400b-a17b: full width, MOE_TRAIN_LAYERS
    layers (one pair), MOE_TRAIN_EXPERTS experts, bf16, Adafactor at
    TRAIN_LR; one fixed batch of TRAIN_B x TRAIN_S tokens in TRAIN_B
    microbatches (each one dispatch of TRAIN_S tokens, C = 320).
    MOE_TRAIN_STEPS steps timed with CUDA events: each loss below the one
    before, finite grad norms, aux > 0, exactly 2 L m forward and L m
    backward bf16 flash launches a step, every MoE dispatch (forward and
    recompute) in deterministic mode. Then the router's gradient on the
    first microbatch: nonzero and finite. Then one f32 AdamW step at one
    pair with MOE_F32_EXPERTS experts, card vs CPU
    (:func:`f32_step_vs_cpu`) under the flip-aware routing rule."""
    from repro_torch.configs import registry
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    t_phase = time.perf_counter()
    full = registry.get(MOE_ARCH)
    cfg = full.replace(n_layers=MOE_TRAIN_LAYERS,
                       n_experts=MOE_TRAIN_EXPERTS)
    micro = min(registry.microbatches(MOE_ARCH, "train_4k"), TRAIN_B)
    opt = O.OptConfig(kind=O.choose_optimizer(1e12), lr=TRAIN_LR)
    step_fn = TR.make_train_step(cfg, opt, microbatches=micro,
                                 global_batch=TRAIN_B)
    resident = fresh_peak()
    state = TR.make_state(cfg, opt, torch.Generator(dev).manual_seed(SEED),
                          dev)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (TRAIN_B, TRAIN_S), device=dev,
        generator=torch.Generator(dev).manual_seed(SEED + 32))}
    want = {"flash_attention": 2 * cfg.n_layers * micro,
            "flash_attention_bwd": cfg.n_layers * micro}

    # the path: counts set to 0 right before, read right after
    reset_counts()
    steps = []
    with MoeRecorder() as rec:
        for _ in range(MOE_TRAIN_STEPS):
            before = model_counts()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, m = step_fn(state, batch)
            end.record()
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in model_counts().items()}
            steps.append(dict(seconds=start.elapsed_time(end) / 1e3,
                              launches=launched, loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]),
                              aux=float(m["aux"])))
            check(launched == {**dict.fromkeys(launched, 0), **want},
                  f"train/{MOE_ARCH} step {len(steps)} launched {launched}, "
                  f"expected {want}")
    counts = model_counts()
    moe = rec.stats()
    # each microbatch dispatches in its forward, then in the backward's
    # recompute, which must route as the forward did
    recompute_same = all(
        torch.equal(a.expert, b.expert) and torch.equal(a.keep, b.keep)
        for a, b in zip(rec.routes[0::2], rec.routes[1::2]))
    check(recompute_same, f"train/{MOE_ARCH}: a recompute routed other "
          "than its forward")
    # steps x microbatches x (forward, recompute), one MoE layer
    check(cfg.n_layers == 2
          and len(moe) == MOE_TRAIN_STEPS * micro * cfg.n_layers
          and all(rec.deterministic)
          and all(s["capacity"] == L.moe_capacity(TRAIN_S, cfg)
                  for s in moe),
          f"train/{MOE_ARCH}: {len(moe)} dispatches, deterministic "
          f"{set(rec.deterministic)}, capacities "
          f"{sorted({s['capacity'] for s in moe})}")
    losses = [st["loss"] for st in steps]
    check(all(np.isfinite([st[k] for st in steps
                           for k in ("loss", "grad_norm", "aux")]))
          and all(st["aux"] > 0 for st in steps)
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"train/{MOE_ARCH}: losses {losses}, grad norms "
          f"{[st['grad_norm'] for st in steps]}, aux "
          f"{[st['aux'] for st in steps]}")
    peak = torch.cuda.max_memory_allocated()
    timed = steps[1:]
    sec = sum(st["seconds"] for st in timed) / len(timed)
    t0 = time.perf_counter()
    router_grad = moe_router_grad(cfg, state["params"],
                                  batch["tokens"][:TRAIN_B // micro], dev)
    router_grad["seconds"] = time.perf_counter() - t0
    del state, batch, m
    # what the f32 step finds on the card: its state, gradients and
    # AdamW's temporaries take ~70 GB
    resident_f32 = fresh_peak()

    # the f32 step, card vs CPU, on one set of weights (drawn on the card)
    t0 = time.perf_counter()
    cfg32 = full.replace(n_layers=MOE_TRAIN_LAYERS,
                         n_experts=MOE_F32_EXPERTS, dtype=F32)
    opt32 = O.OptConfig(kind="adamw", lr=TRAIN_LR)
    cpu, card = f32_states(cfg32, opt32, dev)
    f32_setup_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg32.vocab, (MOE_F32_B, MOE_F32_TRAIN_S),
                           generator=torch.Generator().manual_seed(SEED + 33))
    with MoeRecorder() as rec32:
        f32 = f32_step_vs_cpu(f"train/{MOE_ARCH}/f32", cfg32, opt32, cpu,
                              card, {"tokens": tokens}, flip_aware_of=rec32)
    del card, cpu
    res = dict(arch=MOE_ARCH, layers=cfg.n_layers, experts=cfg.n_experts,
               cuts={"layers": [full.n_layers, cfg.n_layers],
                     "experts": [full.n_experts, cfg.n_experts],
                     "batch": [256, TRAIN_B],
                     "microbatches": [registry.microbatches(
                         MOE_ARCH, "train_4k"), micro],
                     "f32_step": {"experts": [full.n_experts,
                                              MOE_F32_EXPERTS],
                                  "positions": [MOE_F32_S,
                                                MOE_F32_TRAIN_S]}},
               batch=TRAIN_B, seq=TRAIN_S, microbatches=micro,
               optimizer=opt.kind, lr=opt.lr, steps=steps,
               moe_first_step=moe[:2 * micro],
               recompute_routes_as_forward=recompute_same,
               seconds_per_step=sec,
               tokens_per_s=TRAIN_B * TRAIN_S / sec, peak_mem_bytes=peak,
               resident_at_start_bytes=resident, router_grad=router_grad,
               resident_at_f32_step_bytes=resident_f32,
               f32_setup_seconds=f32_setup_s,
               launches_per_step=want, launches=counts, f32=f32,
               seconds=time.perf_counter() - t_phase)
    log(phase=f"train/{MOE_ARCH}", **res)
    return res


# -- the hybrid family: hymba-1.5b --------------------------------------------

HYMBA_ARCH = "hymba-1.5b"
META = 128                    # hymba's meta tokens before every sequence
# serve/hymba: full width and depth (29 layers with window 1024, global
# layers 0, 16 and 31), bf16, SERVE_B x SERVE_P prompt tokens behind the
# meta tokens: prefill over 1,152 positions, then launch.serve.generate
# (128 meta steps, SERVE_P teacher-forced, SERVE_NEW - 1 greedy: 1,183
# steps, each one captured CUDA graph, so every ring of 1,024 slots wraps)
HYMBA_SERVE_LAYERS = 32
# the f32 checks: full width, 2 layers (layer 0 global, layer 1 with the
# window), HYMBA_F32_B x HYMBA_F32_P tokens behind the meta tokens (1,228
# positions: the window's ring wraps)
HYMBA_F32_LAYERS = 2
HYMBA_F32_B, HYMBA_F32_P = 1, 1100
# train/hymba: full width, the depth cut 32 -> 16 (global layers 0, 8
# and 15, the reference's default rule) for the script's time limit (a
# step at 32 layers: 3.2-4.9 s, host-bound in the Mamba scan's backward),
# train_4k's 4,096 tokens with the batch cut 256 -> TRAIN_B and the
# registry's 4 microbatches cut to 2, Adafactor at TRAIN_LR; the leaves
# whose gradients must be nonzero
HYMBA_TRAIN_LAYERS = 16
HYMBA_TRAIN_MICRO = 2
HYMBA_TRAIN_STEPS = 4         # 1 warm-up + 3 timed
HYMBA_GRAD_LEAVES = ("meta_tokens", "A_log", "w_dt")


def hymba_config(n_layers: int, dtype=None):
    """hymba-1.5b at full width and ``n_layers`` layers: its own global
    layers at full depth, layer 0 alone at HYMBA_F32_LAYERS, else the
    reference's default rule (first, middle and last)."""
    from repro_torch.configs import registry
    full = registry.get(HYMBA_ARCH)
    glb = full.global_layers if n_layers == full.n_layers else \
        (0,) if n_layers == HYMBA_F32_LAYERS else ()
    return full.replace(n_layers=n_layers, global_layers=glb,
                        dtype=dtype or full.dtype)


def hymba_global_layers(cfg) -> list:
    """The layers of ``cfg``'s plan with full (global) attention."""
    from repro_torch.models import transformer as T
    out, i = [], 0
    for seg in T.plan_segments(cfg):
        if seg["window"] <= 0:
            out.append(i)
        i += seg["n"]
    return out


def mamba_times(dev, cfg, batch: int, seq: int) -> dict:
    """One layer's Mamba heads (``models.ssm.mamba_scan``) at full width
    on [batch, seq, D] bf16 inputs, CUDA events: the forward alone, and
    forward and backward (the weights copied out of any model); with the
    forward's device time (torch.profiler) and its share of the wall
    time."""
    from repro_torch.models import ssm as S
    from repro_torch.models.common import ParamFactory
    gen = torch.Generator(dev).manual_seed(SEED + 33)
    p = S.init_mamba(ParamFactory(gen, cfg.dtype, dev), cfg, cfg.d_model)
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = randn(gen, (batch, seq, cfg.d_model), dev, cfg.dtype)
    xg = x.clone().requires_grad_()
    g = randn(gen, (batch, seq, cfg.d_model), dev, cfg.dtype)

    def fwd():
        with torch.no_grad():
            return S.mamba_scan(p, cfg, x)

    def fwd_bwd():
        S.mamba_scan(p, cfg, xg).backward(g)
    fwd_ms = time_cuda(fwd, reps=3, warmup=1)
    fb_ms = time_cuda(fwd_bwd, reps=3, warmup=1)
    events = device_kernels(fwd, 1, want=1)
    dev_us = sum(us for _, us in events)
    return dict(shape=[batch, seq, cfg.d_model], fwd_ms=fwd_ms,
                fwd_bwd_ms=fb_ms, fwd_device_ms=dev_us / 1e3,
                fwd_kernels=len(events),
                fwd_device_busy_share=dev_us / 1e3 / fwd_ms)


def hymba_flash_timing(dev, cfg) -> dict:
    """The bf16 flash kernel at the prefill's shape (SERVE_B x 1,152
    positions, 25 heads over 5, h 64) with hymba's window and without
    (its global layers), and at the train microbatch's (1 x 4,224) with
    the window: per call (CUDA events), device time a call
    (torch.profiler), the plain version and
    ``scaled_dot_product_attention`` (the window as a boolean mask), with
    the bound of the visible pairs."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    kf, _ = model_kernel_modules()
    gen = torch.Generator(dev).manual_seed(SEED + 34)
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    rows = {}
    for key, B, S, window in (
            ("window", SERVE_B, META + SERVE_P, cfg.window),
            ("global", SERVE_B, META + SERVE_P, -1),
            ("train_window", TRAIN_B // HYMBA_TRAIN_MICRO, META + TRAIN_S,
             cfg.window)):
        q = randn(gen, (B, S, H, h), dev, BF16)
        k = randn(gen, (B, S, K, h), dev, BF16)
        v = randn(gen, (B, S, K, h), dev, BF16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if not gqa:
            kt, vt = (x.repeat_interleave(H // K, dim=1) for x in (kt, vt))
        mask = ref.attention_mask(S, S, causal=True, window=window,
                                  device=dev)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                **({"enable_gqa": True} if gqa else {}))
        plain = kf.flash_attention_plain(q, k, v, window=window).float()
        lib_err = float((sdpa().transpose(1, 2).float() - plain).abs().max())
        check(lib_err <= FLASH_TOL[BF16], f"sdpa disagrees: {lib_err}")
        del plain
        before = model_counts()["flash_attention"]
        ms = time_cuda(lambda: kf.flash_attention(q, k, v, window=window),
                       reps=20, warmup=3)
        check(model_counts()["flash_attention"] - before == 23,
              "hymba flash timing: the calls did not launch the kernel")
        row = dict(shape=[B, S, H, K, h], window=window, dtype="bfloat16",
                   ms=ms, plain_ms=time_cuda(
                       lambda: kf.flash_attention_plain(q, k, v,
                                                        window=window),
                       reps=3, warmup=1),
                   library_ms=time_cuda(sdpa, reps=20, warmup=3),
                   library="torch.nn.functional.scaled_dot_product_"
                           "attention(attn_mask=the causal mask"
                           + (f" of window {window}" if window > 0 else "")
                           + (", enable_gqa=True)" if gqa else
                              ") on k/v expanded over G"),
                   library_vs_plain_err=lib_err,
                   **attention_bound(B, S, S, H, K, h, h, 2,
                                     window=window))
        row["device_us"], _ = traced_kernel_us(
            lambda: [kf.flash_attention(q, k, v, window=window)
                     for _ in range(5)], "flash_attention", 5)
        row["tflops_per_s"] = row["flops"] / (ms * 1e9)
        rows[key] = row
        log(phase="timing/hymba_flash", **row)
        del q, k, v, qt, kt, vt, mask
    return rows


def hymba_f32_checks(dev) -> dict:
    """HYMBA_F32_LAYERS layers at full width in f32 (layer 0 global, layer
    1 with the window): the forward over HYMBA_F32_P tokens behind the
    meta tokens (2 f32 flash launches, one windowed) against the CPU
    port's prefill (CPU_LOGIT_TOL) and against the captured teacher-forced
    decode of ``launch.serve.generate`` at every position, the ring
    wrapped (F32_LOGIT_TOL; no model kernel in the decode)."""
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not run in TF32")
    cfg = hymba_config(HYMBA_F32_LAYERS, F32)
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    toks = torch.randint(0, cfg.vocab, (HYMBA_F32_B, HYMBA_F32_P),
                         device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED + 35))
    before = model_counts()
    with torch.no_grad():
        full = L.logits_apply(lm["embed"], lm(toks), cfg.tie_embeddings)
    pre, _ = D.prefill(lm, cfg, {"tokens": toks})
    launched = {n: c - before[n] for n, c in model_counts().items()}
    check(launched == {**dict.fromkeys(launched, 0),
                       "flash_attention_f32": 2 * cfg.n_layers},
          f"serve/{HYMBA_ARCH}/f32: forward and prefill launched {launched}")
    lm_cpu = f32_copy(lm, "cpu")
    t0 = time.perf_counter()
    pre_cpu, _ = D.prefill(lm_cpu, cfg, {"tokens": toks.cpu()})
    cpu_s = time.perf_counter() - t0
    cpu_err = float((pre.cpu() - pre_cpu).abs().max())
    del lm_cpu
    before = model_counts()
    t0 = time.perf_counter()
    _, dec = serve.generate(lm, cfg, toks, 1, return_logits=True)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    check(model_counts() == before,
          f"serve/{HYMBA_ARCH}/f32: the decode launched a model kernel")
    dec_err = float((dec - full).abs().max())
    last_err = float((dec[:, -1] - pre).abs().max())
    res = dict(layers=cfg.n_layers, batch=HYMBA_F32_B, prompt=HYMBA_F32_P,
               positions=META + HYMBA_F32_P, window=cfg.window,
               card_vs_cpu_prefill=cpu_err, cpu_prefill_seconds=cpu_s,
               decode_vs_forward=dec_err, decode_vs_prefill=last_err,
               decode_seconds=dec_s,
               tolerance=dict(cpu=CPU_LOGIT_TOL, decode=F32_LOGIT_TOL),
               logits_max_abs=float(full.abs().max()),
               launches=launched["flash_attention_f32"])
    check(cpu_err <= CPU_LOGIT_TOL and dec_err <= F32_LOGIT_TOL
          and last_err <= F32_LOGIT_TOL
          and bool(torch.isfinite(dec).all()),
          f"serve/{HYMBA_ARCH}/f32: {res}")
    del lm, full, dec
    torch.cuda.empty_cache()
    return res


def hymba_serve_phase(dev) -> dict:
    """serve/hymba-1.5b: full width, HYMBA_SERVE_LAYERS layers, bf16,
    SERVE_B x SERVE_P prompt tokens. (a) Prefill (the meta tokens before
    the prompt): exactly L bf16 flash launches (windowed and global) and
    no other model kernel, finite logits; (b) ``launch.serve.generate``
    (each step one captured CUDA graph): 128 meta steps, the prompt
    teacher-forced, SERVE_NEW greedy tokens; no model kernel, finite
    logits, each part timed with CUDA events; (c) both bf16 paths at the
    prompt's last token against the f32 forward of the same weights
    (neither more than BF16_PATH_RATIO times further from it than the
    other); (d) timing: prefill, the flash kernel at the prefill's
    shapes, one layer's Mamba heads and their share; (e)
    :func:`hymba_f32_checks`."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    full = registry.get(HYMBA_ARCH)
    cfg = hymba_config(HYMBA_SERVE_LAYERS)
    resident = fresh_peak()
    t0 = time.perf_counter()
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P), device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                SEED + 30))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    windowed = sum(s["n"] for s in T.plan_segments(cfg) if s["window"] > 0)

    # (a) the path: counts set to 0 right before, read right after
    reset_counts()
    t0 = time.perf_counter()
    logits_p, _ = D.prefill(lm, cfg, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    launches = model_counts()
    check(launches["flash_attention"] == cfg.n_layers
          and sum(launches.values()) == cfg.n_layers,
          f"{HYMBA_ARCH} prefill launched {launches}, expected "
          f"{cfg.n_layers} x flash_attention")
    check(tuple(logits_p.shape) == (SERVE_B, cfg.vocab)
          and bool(torch.isfinite(logits_p).all()),
          f"{HYMBA_ARCH}: prefill logits not finite")

    # (b) generate: every part timed with CUDA events
    run = generate_timed(lm, cfg, prompts, SERVE_NEW)
    gen, logits = run["gen"], run["logits"]
    generate_s, part_ms = run["seconds"], run["part_ms"]
    del run
    check(model_counts() == launches,
          f"{HYMBA_ARCH}: the decode launched a model kernel: "
          f"{model_counts()}")
    steps = {"meta": META, "prompt": SERVE_P, "greedy": SERVE_NEW - 1}
    logits_d = logits[:, SERVE_P - 1]
    check(tuple(gen.shape) == (SERVE_B, SERVE_NEW)
          and tuple(logits.shape) == (SERVE_B, SERVE_P + SERVE_NEW - 1,
                                      cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{HYMBA_ARCH}: generate gave {tuple(gen.shape)}, logits "
          f"{tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    del logits
    peak = torch.cuda.max_memory_allocated()

    # (c) both bf16 paths against the f32 forward of the same weights
    lm32 = f32_copy(lm)
    before = model_counts()["flash_attention_f32"]
    logits_f, _ = D.prefill(lm32, lm32.cfg, {"tokens": prompts})
    f32_launches = model_counts()["flash_attention_f32"] - before
    check(f32_launches == cfg.n_layers,
          f"{HYMBA_ARCH}: the f32 forward launched {f32_launches}")
    del lm32
    torch.cuda.empty_cache()
    lp, ld, lf = logits_p.float(), logits_d.float(), logits_f

    def rms(x):
        return float(x.square().mean().sqrt())
    agree = dict(prefill_vs_decode=float((lp - ld).abs().max()),
                 prefill_vs_f32=float((lp - lf).abs().max()),
                 decode_vs_f32=float((ld - lf).abs().max()),
                 rms_prefill_vs_decode=rms(lp - ld),
                 rms_prefill_vs_f32=rms(lp - lf),
                 rms_decode_vs_f32=rms(ld - lf), rms_f32_logits=rms(lf),
                 max_abs_f32_logit=float(lf.abs().max()))
    tokens = {name: x.argmax(-1).tolist()
              for name, x in (("prefill", lp), ("decode", ld), ("f32", lf))}
    a, b = agree["prefill_vs_f32"], agree["decode_vs_f32"]
    check(max(a, b) <= BF16_PATH_RATIO * min(a, b),
          f"{HYMBA_ARCH}: one bf16 path is further from the f32 forward "
          f"than the other: {agree}")

    # (d) timing
    prefill_ms = time_cuda(lambda: D.prefill(lm, cfg, {"tokens": prompts}),
                           reps=3, warmup=1)
    del lm
    torch.cuda.empty_cache()
    flash = hymba_flash_timing(dev, cfg)
    mamba = mamba_times(dev, cfg, SERVE_B, META + SERVE_P)
    mamba["prefill_share"] = cfg.n_layers * mamba["fwd_ms"] / prefill_ms

    # (e) exactness at HYMBA_F32_LAYERS layers in f32
    exact = hymba_f32_checks(dev)
    res = dict(arch=HYMBA_ARCH, params=n_params, layers=cfg.n_layers,
               global_layers=hymba_global_layers(cfg),
               windowed_layers=windowed, window=cfg.window,
               cuts={"layers": [full.n_layers, cfg.n_layers]},
               batch=SERVE_B, prompt=SERVE_P, positions=META + SERVE_P,
               new_tokens=SERVE_NEW, init_seconds=init_s,
               prefill_first_seconds=prefill_first_s,
               launches={"flash_attention": launches["flash_attention"]},
               flash_calls_per_prefill=launches["flash_attention"],
               **agree, greedy_tokens=tokens,
               generate_seconds=generate_s, generate_part_ms=part_ms,
               decode_steps=steps,
               meta_ms_per_step=part_ms["meta"] / META,
               teacher_forced_ms_per_step=part_ms["prompt"] / SERVE_P,
               decode_ms_per_step=part_ms["greedy"] / (SERVE_NEW - 1),
               decode_tokens_per_s=SERVE_B * (SERVE_NEW - 1)
               / (part_ms["greedy"] / 1e3),
               prefill_ms=prefill_ms,
               prefill_tokens_per_s=SERVE_B * SERVE_P / (prefill_ms / 1e3),
               flash=flash, mamba=mamba, peak_mem_bytes=peak,
               resident_at_start_bytes=resident, f32=exact,
               seconds=time.perf_counter() - t_phase)
    log(phase=f"serve/{HYMBA_ARCH}", **res)
    return res


def hymba_train_phase(dev) -> dict:
    """train/hymba-1.5b: full width, HYMBA_TRAIN_LAYERS layers, bf16,
    Adafactor at TRAIN_LR; one fixed batch of TRAIN_B x TRAIN_S tokens
    (each row 128 + TRAIN_S positions behind the meta tokens) in
    HYMBA_TRAIN_MICRO microbatches. HYMBA_TRAIN_STEPS steps timed with
    CUDA events: each loss below the one before, finite grad norms,
    exactly 2 L m forward and L m backward bf16 flash launches a step.
    Then the gradients of the meta tokens and of every layer's A_log and
    w_dt: nonzero and finite; one layer's Mamba heads forward and
    backward at the microbatch's shape and their share of a step; and one
    f32 AdamW step at HYMBA_F32_LAYERS layers, card vs CPU
    (:func:`f32_step_vs_cpu`)."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.models.common import reference_leaves
    from repro_torch.runtime.data import ShardedBatchSource
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    t_phase = time.perf_counter()
    cfg = hymba_config(HYMBA_TRAIN_LAYERS)
    micro = HYMBA_TRAIN_MICRO
    opt = O.OptConfig(kind=O.choose_optimizer(1e12), lr=TRAIN_LR)
    step_fn = TR.make_train_step(cfg, opt, microbatches=micro,
                                 global_batch=TRAIN_B)
    resident = fresh_peak()
    state = TR.make_state(cfg, opt, torch.Generator(dev).manual_seed(SEED),
                          dev)
    batch = ShardedBatchSource(cfg.vocab, TRAIN_B, TRAIN_S, seed=SEED + 31,
                               device=dev).batch(0)
    want = {"flash_attention": 2 * cfg.n_layers * micro,
            "flash_attention_bwd": cfg.n_layers * micro}

    # the path: counts set to 0 right before, read right after
    reset_counts()
    steps = []
    for _ in range(HYMBA_TRAIN_STEPS):
        before = model_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, m = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in model_counts().items()}
        steps.append(dict(seconds=start.elapsed_time(end) / 1e3,
                          launches=launched, loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"])))
        check(launched == {**dict.fromkeys(launched, 0), **want},
              f"train/{HYMBA_ARCH} step {len(steps)} launched {launched}, "
              f"expected {want}")
    counts = model_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in steps]
    check(all(np.isfinite([st[k] for st in steps
                           for k in ("loss", "grad_norm")]))
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"train/{HYMBA_ARCH}: losses {losses}, grad norms "
          f"{[st['grad_norm'] for st in steps]}")
    timed = steps[1:]
    sec = sum(st["seconds"] for st in timed) / len(timed)

    # the meta tokens' and the Mamba heads' gradients
    grads, _ = TR.make_grad_fn(cfg, microbatches=micro,
                               global_batch=TRAIN_B)(state["params"], batch)
    grad_max = {}
    for (path, _, _), leaf in zip(reference_leaves(state["params"]), grads):
        if path[-1] in HYMBA_GRAD_LEAVES:
            grad_max["/".join(path)] = [float(g.abs().max()) for g in leaf]
    check(len(grad_max) == 1 + 2 * len(T.plan_segments(cfg))
          and all(0 < x < float("inf") for v in grad_max.values()
                  for x in v),
          f"train/{HYMBA_ARCH}: gradients {grad_max}")
    del state, grads
    torch.cuda.empty_cache()
    mamba = mamba_times(dev, cfg, TRAIN_B // micro, META + TRAIN_S)
    # each microbatch runs every layer's scan forward, again in the
    # recompute, and backward
    mamba["step_share"] = micro * cfg.n_layers * (
        mamba["fwd_ms"] + mamba["fwd_bwd_ms"]) / (sec * 1e3)

    # the f32 step, card vs CPU, on one set of weights (drawn on the card)
    cfg32 = hymba_config(HYMBA_F32_LAYERS, F32)
    opt32 = O.OptConfig(kind="adamw", lr=TRAIN_LR)
    cpu, card = f32_states(cfg32, opt32, dev)
    tokens = ShardedBatchSource(cfg32.vocab, F32_TRAIN_B, F32_TRAIN_S,
                                seed=SEED + 32, device="cpu").batch(0)
    f32 = f32_step_vs_cpu(f"train/{HYMBA_ARCH}/f32", cfg32, opt32, cpu,
                          card, tokens)
    del card, cpu
    res = dict(arch=HYMBA_ARCH, layers=cfg.n_layers,
               global_layers=hymba_global_layers(cfg),
               cuts={"layers": [registry.get(HYMBA_ARCH).n_layers,
                                cfg.n_layers],
                     "batch": [256, TRAIN_B],
                     "microbatches": [4, micro]},
               batch=TRAIN_B, seq=TRAIN_S, positions=META + TRAIN_S,
               microbatches=micro, optimizer=opt.kind, lr=opt.lr,
               steps=steps, seconds_per_step=sec,
               tokens_per_s=TRAIN_B * TRAIN_S / sec, peak_mem_bytes=peak,
               resident_at_start_bytes=resident, grad_max_abs=grad_max,
               mamba=mamba, launches_per_step=want, launches=counts,
               f32=f32, seconds=time.perf_counter() - t_phase)
    log(phase=f"train/{HYMBA_ARCH}", **res)
    return res


# -- the encoder-decoder family -----------------------------------------------

WHISPER_ARCH = "whisper-small"
# serve/whisper-small: full width and depth (12 encoder and 12 decoder
# layers), bf16, SERVE_B rows of encoder_len (1,500) seeded frame
# embeddings (the stub audio frontend's) and SERVE_P prompt tokens:
# prefill (12 bidirectional encoder flash calls over the frames, 12 causal
# over the prompt, 12 cross of the prompt against the frames), then
# launch.serve.generate (the frames encoded once into the cross cache,
# SERVE_P teacher-forced and SERVE_NEW - 1 greedy steps, each one captured
# CUDA graph)
# the f32 checks: full width, WHISPER_F32_LAYERS encoder and decoder
# layers, WHISPER_F32_B x WHISPER_F32_P tokens against the 1,500 frames
WHISPER_F32_LAYERS = 2
WHISPER_F32_B, WHISPER_F32_P = 1, 256
# train/whisper-small: full width and depth, train_4k's 4,096 tokens with
# the batch cut 256 -> TRAIN_B in the registry's one microbatch, each row
# against 1,500 frames, Adafactor at TRAIN_LR; the leaves whose gradients
# must be nonzero (the encoder's and the cross-attention's)
WHISPER_TRAIN_STEPS = 4       # 1 warm-up + 3 timed
WHISPER_GRAD_TREES = ("encoder", "cross")


def whisper_config(n_layers: int = 0, dtype=None):
    """whisper-small at full width with ``n_layers`` encoder and decoder
    layers each (0: its own 12 and 12)."""
    from repro_torch.configs import registry
    full = registry.get(WHISPER_ARCH)
    n = n_layers or full.n_layers
    return full.replace(n_layers=n, encoder_layers=n,
                        dtype=dtype or full.dtype)


def whisper_inputs(cfg, batch: int, prompt: int, seed: int, dev):
    """Seeded prompt tokens [batch, prompt] and the stub frontend's frame
    embeddings [batch, encoder_len, D] (standard normal, in
    ``cfg.dtype``)."""
    gen = torch.Generator(dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, prompt), device=dev,
                         generator=gen)
    return toks, randn(gen, (batch, cfg.encoder_len, cfg.d_model), dev,
                       cfg.dtype)


def whisper_flash_timing(dev, cfg) -> dict:
    """The bf16 flash kernel at whisper's shapes: the encoder (SERVE_B x
    1,500 frames, bidirectional), the prefill's cross-attention (SERVE_P
    queries against 1,500 frames) and causal decoder, and the train
    microbatch's cross-attention (TRAIN_B x TRAIN_S against 1,500): per
    call (CUDA events), device time a call (torch.profiler), the plain
    version and ``scaled_dot_product_attention`` on the same inputs,
    with the bound of the visible pairs."""
    import torch.nn.functional as F
    kf, _ = model_kernel_modules()
    gen = torch.Generator(dev).manual_seed(SEED + 43)
    H, K, h, Te = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.encoder_len
    rows = {}
    for key, B, Sq, Skv, causal in (
            ("encoder", SERVE_B, Te, Te, False),
            ("cross", SERVE_B, SERVE_P, Te, False),
            ("decoder", SERVE_B, SERVE_P, SERVE_P, True),
            ("train_cross", TRAIN_B, TRAIN_S, Te, False)):
        q = randn(gen, (B, Sq, H, h), dev, BF16)
        k = randn(gen, (B, Skv, K, h), dev, BF16)
        v = randn(gen, (B, Skv, K, h), dev, BF16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        plain = kf.flash_attention_plain(q, k, v, causal=causal).float()
        lib_err = float((sdpa().transpose(1, 2).float() - plain).abs().max())
        check(lib_err <= FLASH_TOL[BF16], f"sdpa disagrees: {lib_err}")
        del plain
        before = model_counts()["flash_attention"]
        ms = time_cuda(lambda: kf.flash_attention(q, k, v, causal=causal),
                       reps=20, warmup=3)
        check(model_counts()["flash_attention"] - before == 23,
              "whisper flash timing: the calls did not launch the kernel")
        row = dict(shape=[B, Sq, Skv, H, K, h], causal=causal,
                   dtype="bfloat16", ms=ms, plain_ms=time_cuda(
                       lambda: kf.flash_attention_plain(q, k, v,
                                                        causal=causal),
                       reps=3, warmup=1),
                   library_ms=time_cuda(sdpa, reps=20, warmup=3),
                   library="torch.nn.functional.scaled_dot_product_"
                           f"attention(is_causal={causal})",
                   library_vs_plain_err=lib_err,
                   **attention_bound(B, Sq, Skv, H, K, h, h, 2,
                                     causal=causal))
        row["device_us"], _ = traced_kernel_us(
            lambda: [kf.flash_attention(q, k, v, causal=causal)
                     for _ in range(5)], "flash_attention", 5)
        row["tflops_per_s"] = row["flops"] / (ms * 1e9)
        rows[key] = row
        log(phase="timing/whisper_flash", name=key, **row)
        del q, k, v, qt, kt, vt
    return rows


def whisper_f32_checks(dev) -> dict:
    """WHISPER_F32_LAYERS encoder and decoder layers at full width in
    f32: the forward over WHISPER_F32_P tokens against 1,500 frames and
    the prefill (each 3 L f32 flash launches: encoder, causal, cross)
    against the CPU port's prefill (CPU_LOGIT_TOL) and against the
    captured teacher-forced decode of ``launch.serve.generate`` at every
    position (F32_LOGIT_TOL; its only model kernels are the encoder's)."""
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not run in TF32")
    cfg = whisper_config(WHISPER_F32_LAYERS, F32)
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    toks, frames = whisper_inputs(cfg, WHISPER_F32_B, WHISPER_F32_P,
                                  SEED + 44, dev)
    before = model_counts()
    with torch.no_grad():
        full = L.logits_apply(lm["embed"], lm(toks, frames),
                              cfg.tie_embeddings)
    pre, _ = D.prefill(lm, cfg, {"tokens": toks, "frames": frames})
    launched = {n: c - before[n] for n, c in model_counts().items()}
    check(launched == {**dict.fromkeys(launched, 0),
                       "flash_attention_f32": 2 * flash_calls(cfg)},
          f"serve/{WHISPER_ARCH}/f32: forward and prefill launched "
          f"{launched}")
    lm_cpu = f32_copy(lm, "cpu")
    t0 = time.perf_counter()
    pre_cpu, _ = D.prefill(lm_cpu, cfg, {"tokens": toks.cpu(),
                                         "frames": frames.cpu()})
    cpu_s = time.perf_counter() - t0
    cpu_err = float((pre.cpu() - pre_cpu).abs().max())
    del lm_cpu
    before = model_counts()
    t0 = time.perf_counter()
    _, dec = serve.generate(lm, cfg, toks, 1, frames=frames,
                            return_logits=True)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    gen_launched = {n: c - before[n] for n, c in model_counts().items()}
    check(gen_launched == {**dict.fromkeys(gen_launched, 0),
                           "flash_attention_f32": cfg.encoder_layers},
          f"serve/{WHISPER_ARCH}/f32: generate launched {gen_launched}, "
          f"expected the encoder's {cfg.encoder_layers}")
    dec_err = float((dec - full).abs().max())
    last_err = float((dec[:, -1] - pre).abs().max())
    res = dict(layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
               batch=WHISPER_F32_B, prompt=WHISPER_F32_P,
               frames=cfg.encoder_len, card_vs_cpu_prefill=cpu_err,
               cpu_prefill_seconds=cpu_s, decode_vs_forward=dec_err,
               decode_vs_prefill=last_err, decode_seconds=dec_s,
               tolerance=dict(cpu=CPU_LOGIT_TOL, decode=F32_LOGIT_TOL),
               logits_max_abs=float(full.abs().max()),
               launches=launched["flash_attention_f32"],
               generate_launches=gen_launched["flash_attention_f32"])
    check(cpu_err <= CPU_LOGIT_TOL and dec_err <= F32_LOGIT_TOL
          and last_err <= F32_LOGIT_TOL
          and bool(torch.isfinite(dec).all()),
          f"serve/{WHISPER_ARCH}/f32: {res}")
    del lm, full, dec
    torch.cuda.empty_cache()
    return res


def whisper_serve_phase(dev) -> dict:
    """serve/whisper-small: full width and depth, bf16, SERVE_B rows of
    1,500 seeded frames and SERVE_P prompt tokens. (a) Prefill: exactly
    36 bf16 flash launches (12 encoder, 12 causal, 12 cross) and no other
    model kernel, finite logits; (b) ``launch.serve.generate``: the
    frames encoded once (12 launches) into the cross cache, then each
    step one captured CUDA graph (no model kernel), the prompt
    teacher-forced and SERVE_NEW greedy tokens, finite logits, each part
    timed with CUDA events; (c) both bf16 paths at the prompt's last
    token against the f32 forward of the same weights (neither more than
    BF16_PATH_RATIO times further from it than the other); (d) timing:
    prefill, the flash kernel at whisper's shapes; (e)
    :func:`whisper_f32_checks`."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = whisper_config()
    resident = fresh_peak()
    t0 = time.perf_counter()
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts, frames = whisper_inputs(cfg, SERVE_B, SERVE_P, SEED + 40, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    batch = {"tokens": prompts, "frames": frames}
    per_prefill = flash_calls(cfg)

    # (a) the path: counts set to 0 right before, read right after
    reset_counts()
    t0 = time.perf_counter()
    logits_p, _ = D.prefill(lm, cfg, batch)
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    launches = model_counts()
    check(launches["flash_attention"] == per_prefill
          and sum(launches.values()) == per_prefill,
          f"{WHISPER_ARCH} prefill launched {launches}, expected "
          f"{per_prefill} x flash_attention")
    check(tuple(logits_p.shape) == (SERVE_B, cfg.vocab)
          and bool(torch.isfinite(logits_p).all()),
          f"{WHISPER_ARCH}: prefill logits not finite")

    # (b) generate: every part timed with CUDA events
    run = generate_timed(lm, cfg, prompts, SERVE_NEW, frames=frames)
    gen, logits = run["gen"], run["logits"]
    generate_s, part_ms = run["seconds"], run["part_ms"]
    del run
    encode = {n: c - launches[n] for n, c in model_counts().items()}
    check(encode == {**dict.fromkeys(encode, 0),
                     "flash_attention": cfg.encoder_layers},
          f"{WHISPER_ARCH}: generate launched {encode}, expected the "
          f"encoder's {cfg.encoder_layers} and no decode kernel")
    logits_d = logits[:, SERVE_P - 1]
    check(tuple(gen.shape) == (SERVE_B, SERVE_NEW)
          and tuple(logits.shape) == (SERVE_B, SERVE_P + SERVE_NEW - 1,
                                      cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{WHISPER_ARCH}: generate gave {tuple(gen.shape)}, logits "
          f"{tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    del logits
    peak = torch.cuda.max_memory_allocated()

    # (c) both bf16 paths against the f32 forward of the same weights
    lm32 = f32_copy(lm)
    before = model_counts()["flash_attention_f32"]
    logits_f, _ = D.prefill(lm32, lm32.cfg, {"tokens": prompts,
                                             "frames": frames.float()})
    f32_launches = model_counts()["flash_attention_f32"] - before
    check(f32_launches == per_prefill,
          f"{WHISPER_ARCH}: the f32 forward launched {f32_launches}")
    del lm32
    torch.cuda.empty_cache()
    lp, ld, lf = logits_p.float(), logits_d.float(), logits_f

    def rms(x):
        return float(x.square().mean().sqrt())
    agree = dict(prefill_vs_decode=float((lp - ld).abs().max()),
                 prefill_vs_f32=float((lp - lf).abs().max()),
                 decode_vs_f32=float((ld - lf).abs().max()),
                 rms_prefill_vs_decode=rms(lp - ld),
                 rms_prefill_vs_f32=rms(lp - lf),
                 rms_decode_vs_f32=rms(ld - lf), rms_f32_logits=rms(lf),
                 max_abs_f32_logit=float(lf.abs().max()))
    tokens = {name: x.argmax(-1).tolist()
              for name, x in (("prefill", lp), ("decode", ld), ("f32", lf))}
    a, b = agree["prefill_vs_f32"], agree["decode_vs_f32"]
    check(max(a, b) <= BF16_PATH_RATIO * min(a, b),
          f"{WHISPER_ARCH}: one bf16 path is further from the f32 forward "
          f"than the other: {agree}")

    # (d) timing
    prefill_ms = time_cuda(lambda: D.prefill(lm, cfg, batch), reps=3,
                           warmup=1)
    del lm, batch
    torch.cuda.empty_cache()
    flash = whisper_flash_timing(dev, cfg)

    # (e) exactness at WHISPER_F32_LAYERS layers in f32
    exact = whisper_f32_checks(dev)
    steps = {"prompt": SERVE_P, "greedy": SERVE_NEW - 1}
    res = dict(arch=WHISPER_ARCH, params=n_params, layers=cfg.n_layers,
               encoder_layers=cfg.encoder_layers, frames=cfg.encoder_len,
               cuts={"none": "full width and depth; the conv audio "
                             "frontend is a stub (seeded frame "
                             "embeddings), as in the reference"},
               batch=SERVE_B, prompt=SERVE_P, new_tokens=SERVE_NEW,
               init_seconds=init_s, prefill_first_seconds=prefill_first_s,
               launches={"flash_attention": launches["flash_attention"]},
               flash_calls_per_prefill=launches["flash_attention"],
               generate_encode_launches=encode["flash_attention"],
               **agree, greedy_tokens=tokens,
               generate_seconds=generate_s, generate_part_ms=part_ms,
               decode_steps=steps,
               teacher_forced_ms_per_step=part_ms["prompt"] / SERVE_P,
               decode_ms_per_step=part_ms["greedy"] / (SERVE_NEW - 1),
               decode_tokens_per_s=SERVE_B * (SERVE_NEW - 1)
               / (part_ms["greedy"] / 1e3),
               prefill_ms=prefill_ms,
               prefill_tokens_per_s=SERVE_B * SERVE_P / (prefill_ms / 1e3),
               flash=flash, peak_mem_bytes=peak,
               resident_at_start_bytes=resident, f32=exact,
               seconds=time.perf_counter() - t_phase)
    log(phase=f"serve/{WHISPER_ARCH}", **res)
    return res


def whisper_train_phase(dev) -> dict:
    """train/whisper-small: full width and depth, bf16, Adafactor at
    TRAIN_LR; one fixed batch of TRAIN_B x TRAIN_S tokens against 1,500
    frames a row, in the registry's one microbatch. WHISPER_TRAIN_STEPS
    steps timed with CUDA events: each loss below the one before, finite
    grad norms, exactly 2 x 36 forward (the forward and the recompute)
    and 36 backward bf16 flash launches a step. Then every gradient leaf
    of the encoder and the cross-attention: nonzero and finite; and one
    f32 AdamW step at WHISPER_F32_LAYERS encoder and decoder layers, card
    vs CPU (:func:`f32_step_vs_cpu`)."""
    from repro_torch.configs import registry
    from repro_torch.models.common import reference_leaves
    from repro_torch.runtime.data import ShardedBatchSource
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    t_phase = time.perf_counter()
    cfg = whisper_config()
    micro = registry.microbatches(WHISPER_ARCH, "train_4k")
    opt = O.OptConfig(kind=O.choose_optimizer(1e12), lr=TRAIN_LR)
    step_fn = TR.make_train_step(cfg, opt, microbatches=micro,
                                 global_batch=TRAIN_B)
    resident = fresh_peak()
    state = TR.make_state(cfg, opt, torch.Generator(dev).manual_seed(SEED),
                          dev)
    batch = ShardedBatchSource(cfg.vocab, TRAIN_B, TRAIN_S, seed=SEED + 45,
                               device=dev, d_model=cfg.d_model,
                               encoder_len=cfg.encoder_len).batch(0)
    want = {"flash_attention": 2 * flash_calls(cfg) * micro,
            "flash_attention_bwd": flash_calls(cfg) * micro}

    # the path: counts set to 0 right before, read right after
    reset_counts()
    steps = []
    for _ in range(WHISPER_TRAIN_STEPS):
        before = model_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, m = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in model_counts().items()}
        steps.append(dict(seconds=start.elapsed_time(end) / 1e3,
                          launches=launched, loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"])))
        check(launched == {**dict.fromkeys(launched, 0), **want},
              f"train/{WHISPER_ARCH} step {len(steps)} launched "
              f"{launched}, expected {want}")
    counts = model_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in steps]
    check(all(np.isfinite([st[k] for st in steps
                           for k in ("loss", "grad_norm")]))
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"train/{WHISPER_ARCH}: losses {losses}, grad norms "
          f"{[st['grad_norm'] for st in steps]}")
    timed = steps[1:]
    sec = sum(st["seconds"] for st in timed) / len(timed)

    # the encoder's and the cross-attention's gradients
    grads, _ = TR.make_grad_fn(cfg, microbatches=micro,
                               global_batch=TRAIN_B)(state["params"], batch)
    grad_max = {}
    for (path, _, _), leaf in zip(reference_leaves(state["params"]), grads):
        if path[0] in WHISPER_GRAD_TREES:
            grad_max["/".join(path)] = [float(g.abs().max()) for g in leaf]
    check(len(grad_max) > 0
          and all(0 < x < float("inf") for v in grad_max.values()
                  for x in v),
          f"train/{WHISPER_ARCH}: gradients {grad_max}")
    grad_leaves = len(grad_max)
    grad_range = [min(min(v) for v in grad_max.values()),
                  max(max(v) for v in grad_max.values())]
    del state, grads, batch
    torch.cuda.empty_cache()

    # the f32 step, card vs CPU, on one set of weights (drawn on the card)
    cfg32 = whisper_config(WHISPER_F32_LAYERS, F32)
    opt32 = O.OptConfig(kind="adamw", lr=TRAIN_LR)
    cpu, card = f32_states(cfg32, opt32, dev)
    tokens = ShardedBatchSource(cfg32.vocab, F32_TRAIN_B, F32_TRAIN_S,
                                seed=SEED + 46, device="cpu",
                                d_model=cfg32.d_model,
                                encoder_len=cfg32.encoder_len).batch(0)
    f32 = f32_step_vs_cpu(f"train/{WHISPER_ARCH}/f32", cfg32, opt32, cpu,
                          card, tokens)
    del card, cpu
    res = dict(arch=WHISPER_ARCH, layers=cfg.n_layers,
               encoder_layers=cfg.encoder_layers, frames=cfg.encoder_len,
               cuts={"batch": [256, TRAIN_B]},
               batch=TRAIN_B, seq=TRAIN_S, microbatches=micro,
               optimizer=opt.kind, lr=opt.lr, steps=steps,
               seconds_per_step=sec, tokens_per_s=TRAIN_B * TRAIN_S / sec,
               frames_per_s=TRAIN_B * cfg.encoder_len / sec,
               peak_mem_bytes=peak, resident_at_start_bytes=resident,
               encoder_cross_grad_leaves=grad_leaves,
               encoder_cross_grad_max_abs_range=grad_range,
               launches_per_step=want, launches=counts, f32=f32,
               seconds=time.perf_counter() - t_phase)
    log(phase=f"train/{WHISPER_ARCH}", **res)
    return res


# -- the MLA family: deepseek-v3-671b -----------------------------------------

DS_ARCH = "deepseek-v3-671b"
# serve/deepseek-v3 and train/deepseek-v3: full width with the depth cut
# 61 -> DS_LAYERS and the dense prefix 3 -> DS_DENSE: one dense MLA block,
# then one MoE block (all 256 experts at top-8 and the shared expert when
# serving: ~29.3 GB of bf16 parameters), and the MTP head
DS_LAYERS, DS_DENSE = 2, 1
# train/deepseek-v3: the experts cut 256 -> DS_TRAIN_EXPERTS (top-8 kept;
# bf16 weights, f32 accumulators, .grad and Adafactor's state fit one
# card); train_4k's sequence with its batch cut 256 -> TRAIN_B, and its 16
# microbatches cut to the batch
DS_TRAIN_EXPERTS = 32
DS_TRAIN_STEPS = 4           # 1 warm-up + 3 timed
# the f32 checks (card against CPU; the train step's host half is AdamW):
# MLA's widths kept (q/k 128 + 64, v 128, kv_lora_rank 512, q_lora_rank
# 1536), so that the f32 (192, 128) flash kernels run on the model path,
# and top-8 routing kept; the rest of the width cut
DS_F32_CUT = dict(d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2048,
                  moe_d_ff=512, n_experts=16, vocab=16384)
DS_F32_B, DS_F32_S = 1, 256
DS_F32_DECODE = 8            # absorbed decode steps, card against CPU


def ds_config(dtype=None, **cut):
    """deepseek-v3 at full width (unless ``cut``) with DS_LAYERS layers,
    DS_DENSE of them dense."""
    from repro_torch.configs import registry
    full = registry.get(DS_ARCH)
    return full.replace(n_layers=DS_LAYERS, n_dense_layers=DS_DENSE,
                        dtype=dtype or full.dtype, **cut)


def ds_cuts(cfg, **more) -> dict:
    """Each cut of ``cfg`` from the published config: [published,
    run]; ``more`` adds cuts of the run's inputs."""
    from repro_torch.configs import registry
    full = registry.get(DS_ARCH)
    out = {k: [getattr(full, k), getattr(cfg, k)] for k in (
        "n_layers", "n_dense_layers", "d_model", "n_heads", "d_ff",
        "moe_d_ff", "n_experts", "vocab") if getattr(full, k)
        != getattr(cfg, k)}
    return {**out, **more}


def ds_f32_checks(dev) -> dict:
    """deepseek-v3 in f32 at DS_F32_CUT's width, DS_LAYERS layers and the
    MTP head, DS_F32_B x DS_F32_S tokens. (a) The forward's logits at
    every position (DS_LAYERS f32 flash launches at q/k width 192, v
    width 128) and the prefill's last token; the CPU port's forward on
    the same weights under the flip-aware routing rule (CPU_LOGIT_TOL at
    the tokens whose experts and keep agree) and aux. (b) The captured
    teacher-forced decode of ``launch.serve.generate`` (absorbed MLA, no
    model kernel, nothing dropped) against the forward at the positions
    the forward kept (F32_LOGIT_TOL). (c) DS_F32_DECODE eager absorbed
    decode steps on the card against the same steps on the CPU: each
    dispatch under the flip-aware rule, the logits within
    CPU_LOGIT_TOL."""
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not run in TF32")
    cfg = ds_config(F32, **DS_F32_CUT)
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    toks = torch.randint(0, cfg.vocab, (DS_F32_B, DS_F32_S), device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED + 51))
    pos = torch.arange(DS_F32_S, device=dev)[None].expand(DS_F32_B,
                                                          DS_F32_S)

    def forward(model, d):
        with torch.no_grad(), MoeRecorder() as rec:
            x = L.embed_apply(model["embed"], toks.to(d))
            hidden, aux = T.backbone_forward(model, cfg, x, pos.to(d))
            logits = L.logits_apply(model["embed"], hidden,
                                    cfg.tie_embeddings)
        return logits, float(aux), rec

    before = model_counts()
    full, aux, rec = forward(lm, dev)
    last, _ = D.prefill(lm, cfg, {"tokens": toks})
    launched = {n: c - before[n] for n, c in model_counts().items()}
    check(launched == {**dict.fromkeys(launched, 0),
                       "flash_attention_f32": 2 * DS_LAYERS},
          f"serve/{DS_ARCH}/f32: the forward and prefill launched {launched}")
    (route,) = rec.routes
    keep = route.keep.reshape(DS_F32_B * DS_F32_S, -1).all(-1).reshape(
        DS_F32_B, DS_F32_S)
    # (a) the card against the CPU port, on one set of weights
    lm_cpu = f32_copy(lm, "cpu")
    t0 = time.perf_counter()
    full_cpu, aux_cpu, rec_cpu = forward(lm_cpu, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    (rows,), flips, worst = flip_aware(rec_cpu.routes, rec.routes)
    rows = rows.reshape(DS_F32_B, DS_F32_S)
    cpu_err = float((full.cpu() - full_cpu).abs().amax(-1)[rows].max())
    aux_err = abs(aux - aux_cpu) / aux_cpu
    last_err = float((last - full[:, -1]).abs().max())
    check(cpu_err <= CPU_LOGIT_TOL and aux_err <= F32_STEP_TOL["loss"]
          and last_err <= F32_LOGIT_TOL and bool(torch.isfinite(full).all()),
          f"serve/{DS_ARCH}/f32: card vs CPU max abs err {cpu_err}, aux "
          f"{aux} vs {aux_cpu}, prefill vs forward {last_err}")
    # (b) the captured teacher-forced decode against the forward
    before = model_counts()
    with MoeRecorder() as drec:
        _, dec = serve.generate(lm, cfg, toks, 1, return_logits=True)
    check(model_counts() == before,
          f"serve/{DS_ARCH}/f32: the decode launched a model kernel")
    check(all(s["dropped"] == 0 and s["capacity"] == L.moe_capacity(
        DS_F32_B, cfg) for s in drec.stats()),
        f"serve/{DS_ARCH}/f32: a decode step dropped a token")
    diff = (full - dec[:, :DS_F32_S]).abs().amax(dim=-1)       # [B, S]
    kept_err = float(diff[keep].max())
    check(kept_err <= F32_LOGIT_TOL,
          f"serve/{DS_ARCH}/f32: forward vs captured decode at the kept "
          f"positions: max abs err {kept_err}")
    # (c) absorbed decode steps, card against CPU
    steps = {}
    for name, model, d in (("card", lm, dev), ("cpu", lm_cpu, "cpu")):
        cache = D.cache_zeros(D.cache_spec(cfg, DS_F32_B, DS_F32_DECODE), d)
        outs = []
        with MoeRecorder() as srec:
            for t in range(DS_F32_DECODE):
                lg, cache = D.decode_step(model, cfg, {
                    "token": toks[:, t:t + 1].to(d), "index": t}, cache)
                outs.append(lg.cpu())
        steps[name] = (torch.stack(outs, 1), srec.routes)
    srows, sflips, sworst = flip_aware(steps["cpu"][1], steps["card"][1])
    agree = torch.stack(srows).T.reshape(DS_F32_B, DS_F32_DECODE)
    step_err = float((steps["card"][0] - steps["cpu"][0]).abs()
                     .amax(-1)[agree].max())
    check(step_err <= CPU_LOGIT_TOL,
          f"serve/{DS_ARCH}/f32: absorbed decode card vs CPU {step_err}")
    res = dict(cuts=ds_cuts(cfg), batch=DS_F32_B,
               positions=DS_F32_S, capacity=route.capacity,
               launches=launched["flash_attention_f32"],
               dropped_positions=int((~keep).sum()),
               cpu=dict(max_abs_err=cpu_err, tolerance=CPU_LOGIT_TOL,
                        compared_positions=int(rows.sum()), flips=flips,
                        largest_flipped_margin=worst,
                        flip_margin=MOE_FLIP_MARGIN, aux=aux,
                        aux_cpu=aux_cpu, aux_rel_err=aux_err,
                        cpu_seconds=cpu_s),
               prefill_vs_forward=last_err,
               captured_decode_vs_forward=kept_err,
               tolerance=F32_LOGIT_TOL,
               absorbed_steps=dict(steps=DS_F32_DECODE, max_abs_err=step_err,
                                   compared=int(agree.sum()), flips=sflips,
                                   largest_flipped_margin=sworst))
    del lm, lm_cpu
    torch.cuda.empty_cache()
    return res


def ds_serve_phase(dev) -> dict:
    """serve/deepseek-v3-671b: full width, DS_LAYERS layers (DS_DENSE
    dense), all 256 experts at top-8 and the shared expert, bf16,
    SERVE_B x SERVE_P prompt tokens. (a) The prefill: exactly DS_LAYERS
    bf16 flash launches (q [4, 1024, 128, 192], v width 128) and no other
    model kernel, finite logits; the MoE layer's capacity, drops, largest
    expert load and aux; CUDA-event time. (b) ``launch.serve.generate``:
    the prompt teacher-forced through ``decode_step`` (absorbed MLA, one
    captured CUDA graph a step), then SERVE_NEW greedy steps, no model
    kernel, no token dropped. (c) :func:`ds_f32_checks`."""
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = ds_config()
    resident = fresh_peak()
    t0 = time.perf_counter()
    lm = T.init_lm(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P), device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                SEED + 50))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in lm.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())

    # (a) the path: counts set to 0 right before, read right after
    reset_counts()
    t0 = time.perf_counter()
    with MoeRecorder() as rec:
        logits_p, _ = D.prefill(lm, cfg, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    launches = model_counts()
    check(launches["flash_attention"] == cfg.n_layers
          and sum(launches.values()) == cfg.n_layers,
          f"{DS_ARCH} prefill launched {launches}, expected "
          f"{cfg.n_layers} x flash_attention")
    check(tuple(logits_p.shape) == (SERVE_B, cfg.vocab)
          and bool(torch.isfinite(logits_p).all()),
          f"{DS_ARCH}: prefill logits {tuple(logits_p.shape)} not finite")
    moe = [dict(s, aux=float(a)) for s, a in zip(rec.stats(), rec.auxs)]
    check(len(moe) == len(rec.routes) == cfg.n_layers - cfg.n_dense_layers
          and all(s["tokens"] == SERVE_B * SERVE_P
                  and s["capacity"] == L.moe_capacity(SERVE_B * SERVE_P, cfg)
                  and np.isfinite(s["aux"]) and s["aux"] > 0 for s in moe),
          f"{DS_ARCH}: prefill dispatches {moe}")
    prefill_ms = time_cuda(lambda: D.prefill(lm, cfg, {"tokens": prompts}),
                           reps=3, warmup=1)
    _, events = traced(lambda: D.prefill(lm, cfg, {"tokens": prompts}))
    check(model_counts()["flash_attention"] == 6 * cfg.n_layers,
          f"{DS_ARCH}: timed and traced prefills launched {model_counts()}")
    counts = model_counts()
    breakdown = ds_kernel_classes(events)

    # (b) generate: the prompt teacher-forced, then greedy steps
    steps = SERVE_P + SERVE_NEW - 1
    with MoeRecorder() as drec:
        run = generate_timed(lm, cfg, prompts, SERVE_NEW, keep_logits=False)
    gen, part_ms = run["gen"], run["part_ms"]
    check(model_counts() == counts,
          f"{DS_ARCH}: decode launched a model kernel: {model_counts()}")
    check(tuple(gen.shape) == (SERVE_B, SERVE_NEW)
          and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab,
          f"{DS_ARCH}: generated {tuple(gen.shape)}")
    # the recorder sees the capture's warm-up step and the capture; a
    # token's k choices go to k different experts, so an expert takes at
    # most B choices of a step: a capacity of at least B drops none
    dstats = drec.stats()
    cap = L.moe_capacity(SERVE_B, cfg)
    check(len(dstats) == 2 and cap >= SERVE_B and all(
        s["tokens"] == SERVE_B and s["capacity"] == cap
        and s["dropped"] == 0 for s in dstats),
        f"{DS_ARCH}: decode dispatches {dstats} (capacity {cap})")
    cache_bytes = sum(int(np.prod(shape)) * dt.itemsize
                      for shape, dt in _spec_leaves(D.cache_spec(
                          cfg, SERVE_B, SERVE_P + SERVE_NEW)))
    peak = torch.cuda.max_memory_allocated()
    del lm, prompts, rec, drec
    torch.cuda.empty_cache()

    # (c) exactness in f32 at the reduced width
    exact = ds_f32_checks(dev)
    res = dict(arch=DS_ARCH, params=n_params, param_bytes=param_bytes,
               layers=cfg.n_layers, dense_layers=cfg.n_dense_layers,
               experts=cfg.n_experts, top_k=cfg.experts_per_token,
               cuts=ds_cuts(cfg, f32_checks=exact["cuts"]),
               batch=SERVE_B, prompt=SERVE_P, new_tokens=SERVE_NEW,
               init_seconds=init_s, init_peak_bytes=init_peak,
               prefill_first_seconds=prefill_first_s,
               launches={"flash_attention": launches["flash_attention"]},
               moe=moe, prefill_ms=prefill_ms,
               prefill_tokens_per_s=SERVE_B * SERVE_P / (prefill_ms / 1e3),
               prefill_device_us=breakdown,
               prefill_device_busy_share=breakdown["all"] / 1e3
               / prefill_ms,
               generate_seconds=run["seconds"], decode_steps=steps,
               generate_part_ms=part_ms,
               teacher_forced_ms_per_step=part_ms["prompt"] / SERVE_P,
               decode_ms_per_step=part_ms["greedy"] / (SERVE_NEW - 1),
               decode_tokens_per_s=SERVE_B * (SERVE_NEW - 1)
               / (part_ms["greedy"] / 1e3),
               decode_capacity=cap, cache_bytes=cache_bytes,
               greedy_tokens=gen[:, :8].tolist(),
               peak_mem_bytes=peak, resident_at_start_bytes=resident,
               f32=exact, seconds=time.perf_counter() - t_phase)
    log(phase=f"serve/{DS_ARCH}", **res)
    return res


# CUDA kernels by what they do, by name (first match): the flash kernel,
# cuBLAS / CUTLASS products, the MoE's sort, gathers and scatters
DS_KERNEL_CLASSES = (("flash", "flash_"),
                     ("products", "gemm|nvjet|xmma|cutlass"),
                     ("sort_index", "sort|index|gather|scatter|search"))


def ds_kernel_classes(events) -> dict:
    """Device microseconds of ``events`` by DS_KERNEL_CLASSES ("other"
    for the rest), their sum ("all") and the kernel count."""
    out = dict.fromkeys([c for c, _ in DS_KERNEL_CLASSES] + ["other"], 0.0)
    for name, us in events:
        key = next((c for c, pat in DS_KERNEL_CLASSES
                    if re.search(pat, name, re.IGNORECASE)), "other")
        out[key] += us
    return dict(out, all=sum(us for _, us in events), kernels=len(events))


def _spec_leaves(spec):
    if isinstance(spec, tuple):
        yield spec
        return
    for v in spec.values():
        yield from _spec_leaves(v)


def ds_train_phase(dev) -> dict:
    """train/deepseek-v3-671b: full width, DS_LAYERS layers (DS_DENSE
    dense) and the MTP head, DS_TRAIN_EXPERTS experts at top-8, bf16,
    Adafactor at TRAIN_LR; one fixed batch of TRAIN_B x TRAIN_S tokens in
    TRAIN_B microbatches (each one dispatch of TRAIN_S tokens).
    DS_TRAIN_STEPS steps timed with CUDA events: each loss below the one
    before, finite grad norms, aux > 0, a finite MTP term, exactly 2 m F
    forward and m F backward bf16 flash launches a step (F =
    :func:`flash_calls`: the layers and the MTP block; m microbatches),
    every MoE dispatch (forward and recompute) in deterministic mode and
    each recompute routed as its forward. Then one f32 AdamW step at
    DS_F32_CUT's width, card vs CPU (:func:`f32_step_vs_cpu`) under the
    flip-aware routing rule."""
    from repro_torch.configs import registry
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    t_phase = time.perf_counter()
    cfg = ds_config(n_experts=DS_TRAIN_EXPERTS)
    micro = min(registry.microbatches(DS_ARCH, "train_4k"), TRAIN_B)
    opt = O.OptConfig(kind=O.choose_optimizer(1e12), lr=TRAIN_LR)
    step_fn = TR.make_train_step(cfg, opt, microbatches=micro,
                                 global_batch=TRAIN_B)
    resident = fresh_peak()
    state = TR.make_state(cfg, opt, torch.Generator(dev).manual_seed(SEED),
                          dev)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (TRAIN_B, TRAIN_S), device=dev,
        generator=torch.Generator(dev).manual_seed(SEED + 52))}
    want = {"flash_attention": 2 * flash_calls(cfg) * micro,
            "flash_attention_bwd": flash_calls(cfg) * micro}

    # the path: counts set to 0 right before, read right after
    reset_counts()
    steps = []
    with MoeRecorder() as rec:
        for _ in range(DS_TRAIN_STEPS):
            before = model_counts()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, m = step_fn(state, batch)
            end.record()
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in model_counts().items()}
            steps.append(dict(seconds=start.elapsed_time(end) / 1e3,
                              launches=launched, loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]),
                              aux=float(m["aux"]), mtp=float(m["mtp"])))
            check(launched == {**dict.fromkeys(launched, 0), **want},
                  f"train/{DS_ARCH} step {len(steps)} launched {launched}, "
                  f"expected {want}")
    counts = model_counts()
    moe = rec.stats()
    recompute_same = all(
        torch.equal(a.expert, b.expert) and torch.equal(a.keep, b.keep)
        for a, b in zip(rec.routes[0::2], rec.routes[1::2]))
    check(recompute_same, f"train/{DS_ARCH}: a recompute routed other "
          "than its forward")
    n_moe = cfg.n_layers - cfg.n_dense_layers
    check(len(moe) == DS_TRAIN_STEPS * micro * 2 * n_moe
          and all(rec.deterministic)
          and all(s["capacity"] == L.moe_capacity(TRAIN_S, cfg)
                  for s in moe),
          f"train/{DS_ARCH}: {len(moe)} dispatches, deterministic "
          f"{set(rec.deterministic)}, capacities "
          f"{sorted({s['capacity'] for s in moe})}")
    losses = [st["loss"] for st in steps]
    check(all(np.isfinite([st[k] for st in steps
                           for k in ("loss", "grad_norm", "aux", "mtp")]))
          and all(st["aux"] > 0 for st in steps)
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"train/{DS_ARCH}: losses {losses}, grad norms "
          f"{[st['grad_norm'] for st in steps]}, aux "
          f"{[st['aux'] for st in steps]}, mtp {[st['mtp'] for st in steps]}")
    peak = torch.cuda.max_memory_allocated()
    timed = steps[1:]
    sec = sum(st["seconds"] for st in timed) / len(timed)
    n_params = sum(p.numel() for p in state["params"].parameters())
    del state, batch, m
    resident_f32 = fresh_peak()

    # the f32 step, card vs CPU, on one set of weights (drawn on the card)
    t0 = time.perf_counter()
    cfg32 = ds_config(F32, **DS_F32_CUT)
    opt32 = O.OptConfig(kind="adamw", lr=TRAIN_LR)
    cpu, card = f32_states(cfg32, opt32, dev)
    f32_setup_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg32.vocab, (F32_TRAIN_B, F32_TRAIN_S),
                           generator=torch.Generator().manual_seed(SEED + 53))
    with MoeRecorder() as rec32:
        f32 = f32_step_vs_cpu(f"train/{DS_ARCH}/f32", cfg32, opt32, cpu,
                              card, {"tokens": tokens}, flip_aware_of=rec32)
    del card, cpu
    res = dict(arch=DS_ARCH, params=n_params, layers=cfg.n_layers,
               dense_layers=cfg.n_dense_layers, experts=cfg.n_experts,
               top_k=cfg.experts_per_token, mtp=cfg.mtp,
               cuts=ds_cuts(cfg, batch=[256, TRAIN_B],
                            microbatches=[registry.microbatches(
                                DS_ARCH, "train_4k"), micro],
                            f32_step=ds_cuts(cfg32, positions=[
                                TRAIN_S, F32_TRAIN_S])),
               batch=TRAIN_B, seq=TRAIN_S, microbatches=micro,
               optimizer=opt.kind, lr=opt.lr, steps=steps,
               moe_first_step=moe[:2 * micro * n_moe],
               recompute_routes_as_forward=recompute_same,
               seconds_per_step=sec,
               tokens_per_s=TRAIN_B * TRAIN_S / sec, peak_mem_bytes=peak,
               resident_at_start_bytes=resident,
               resident_at_f32_step_bytes=resident_f32,
               f32_setup_seconds=f32_setup_s,
               launches_per_step=want, launches=counts, f32=f32,
               seconds=time.perf_counter() - t_phase)
    log(phase=f"train/{DS_ARCH}", **res)
    return res


def time_bwd_kernel(dev, info: dict) -> dict:
    """The backward kernels at the train cell's shape (a microbatch: q
    [1, 4096, 32, 128], kv 4, causal, bf16) and at the serving shape
    ([4, 1024, 32, 128], bf16 and f32; bf16 runs the tensor-core kernel,
    f32 the CUDA-core kernel, each with the LSE of
    ``flash_attention_fwd_lse``; also each forward without and with the
    LSE, in turns W, L, L, W): CUDA events over back-to-back calls, each
    pass's device time (``torch.profiler``) and its rate on the products
    it runs (D: none; dk/dv: S, dP, dV, dK; dq: S, dP, dQ), the plain
    version, and the backward of one
    scaled_dot_product_attention(is_causal=True, enable_gqa=True) on the
    same inputs (its forward run once outside the timed calls; each timed
    call is one autograd.grad of that output, retain_graph=True), with
    the bound of the five products and each pass's registers, spills,
    shared memory and blocks per SM (``info``, from
    :func:`bwd_kernel_info`) at width 128."""
    import torch.nn.functional as F
    kf, _ = model_kernel_modules()
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    rows = {}
    for tag, (B, S, dt) in (("train", (1, TRAIN_S, BF16)),
                            ("serve", (SERVE_B, SERVE_P, BF16)),
                            ("serve_f32", (SERVE_B, SERVE_P, F32))):
        H, K, h = 32, 4, 128
        route = bwd_route(dt)
        kernel = kf.KERNEL_BWD_BF16 if dt == BF16 else kf.KERNEL_BWD
        q = randn(gen, (B, S, H, h), dev, dt)
        k = randn(gen, (B, S, K, h), dev, dt)
        v = randn(gen, (B, S, K, h), dev, dt)
        do = randn(gen, (B, S, H, h), dev, dt)
        o, lse = kf.flash_attention_fwd_lse(q, k, v)

        def bwd():
            return kf.flash_attention_bwd(q, k, v, o, do, lse=lse)
        before = kernel.launches
        reps = 10 if tag != "serve_f32" else 5
        ms = time_cuda(bwd, reps=reps, warmup=2)
        check(kernel.launches - before == reps + 2,
              f"{route} {tag}: timed calls did not launch it")
        plain_ms = time_cuda(lambda: kf.flash_attention_bwd_plain(
            q, k, v, o, do), reps=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        dout = do.transpose(1, 2)
        lib_grads = torch.autograd.grad(out, (qt, kt, vt), dout,
                                        retain_graph=True)
        want = kf.flash_attention_bwd_plain(q, k, v, o, do)
        lib_err = max(float((g.transpose(1, 2).float() - w.float())
                            .abs().max()) / max(1.0, float(
                                w.float().abs().max()))
                      for g, w in zip(lib_grads, want))
        library_ms = time_cuda(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dout, retain_graph=True), reps=reps,
            warmup=2)
        _, events = traced(bwd)
        dev_us = {name: sum(us for n, us in events if name in n)
                  for name in BWD_KERNELS[route]}
        check(all(dev_us.values()), f"{route} {tag}: profiler saw {dev_us}")
        rows[tag] = dict(
            kernel=route, shape=[B, S, H, K, h],
            dtype=str(dt).replace("torch.", ""), ms=ms, plain_ms=plain_ms,
            library_ms=library_ms,
            library="torch.autograd.grad of scaled_dot_product_attention("
                    "is_causal=True, enable_gqa=True)",
            library_vs_plain_rel_err=lib_err, device_us=dev_us,
            kernel_info={n: info[f"{n}/128"] for n in BWD_KERNELS[route]},
            **attention_bound(B, S, S, H, K, h, h, dt.itemsize,
                              backward=True))
        rows[tag]["tflops_per_s"] = rows[tag]["flops"] / (ms * 1e9)
        rows[tag]["over_bound"] = ms / rows[tag]["bound_ms"]
        rows[tag]["over_library"] = ms / library_ms
        # the passes' own products over the visible pairs: dk/dv 2 h + 4 hv
        # + 2 h flops a pair (S, dP, dV, dK), dq 2 h + 2 hv + 2 h (S, dP,
        # dQ): seven products in all
        pairs = B * H * S * (S + 1) // 2
        pass_flops = dict(zip(BWD_KERNELS[route][1:],
                              (pairs * 4 * (h + h), pairs * 2 * (h + h + h))))
        rows[tag]["kernel_flops"] = sum(pass_flops.values())
        rows[tag]["pass_tflops_per_s"] = {
            n: f / (dev_us[n] * 1e6) for n, f in pass_flops.items()}
        # the forward without and with its LSE, in turns
        fwd = [lambda: kf.flash_attention(q, k, v),
               lambda: kf.flash_attention_fwd_lse(q, k, v)]
        turns = [time_cuda(fwd[i], reps=10 if dt == BF16 else 5, warmup=2)
                 for i in (0, 1, 1, 0)]
        rows[tag]["forward_ms"] = dict(without_lse=turns[::3],
                                       with_lse=turns[1:3])
        log(phase="timing/flash_bwd", name=tag, **rows[tag])
        del q, k, v, do, o, lse, qt, kt, vt, out, lib_grads, want
        torch.cuda.empty_cache()
    return rows


# deepseek-v3's attention at full width (configs/deepseek_v3_671b.py): 128
# heads, MLA prefill folds the 64-wide rope key into each head's 128-wide
# key (q/k width 192, v width 128, G = 1)
MLA_H, MLA_QK, MLA_V = 128, 192, 128
MLA_F32_S = 256               # the f32 check path's sequence


def mla_entry(mla: dict, direction: str, dt, cases: list, tags: tuple,
              launches: dict, info: dict | None = None) -> dict:
    """The kernels line's record of a flash kernel's q/k width 192, v
    width 128 instantiation: its launches on deepseek-v3's model paths
    (``launches``: path -> count, each above 0), its cases in ``cases``
    of dtype ``dt``, and its timing at deepseek-v3's shapes (``mla``,
    from :func:`time_mla_flash`); for a backward route, each pass's
    registers, spills, shared bytes and blocks an SM at that width
    (``info``)."""
    check(all(n > 0 for n in launches.values()),
          f"the (192, 128) {direction} kernel in {dt} was not launched on "
          f"every deepseek-v3 path: {launches}")
    out = dict(launches_on_model_paths=launches,
               checked_cases=sum(c[5] > 128 and c[9] == dt for c in cases))
    for tag in tags:
        out[tag] = {k: mla[tag]["shape"] if k == "shape" else
                    mla[tag][direction][k] for k in (
            "shape", "ms", "device_us", "plain_ms", "library_ms",
            "library_kernels", "bound_ms", "bound_by", "flops", "bytes",
            "over_bound")}
    if info is not None:
        wide = width_key(MLA_QK, MLA_V)
        out["kernel_info"] = {n: i for n, i in info.items()
                              if f"/{wide}" in n and "4byte" not in n
                              and ("bf16" in n) == (dt == BF16)}
    return out


def sdpa_kernels(fn) -> list:
    """The CUDA kernels one call of ``fn`` launches, by name: which of
    scaled_dot_product_attention's backends ran."""
    _, events = traced(fn)
    return sorted({name[:120] for name, _ in events})


def time_mla_flash(dev) -> dict:
    """The flash kernels' q/k width 192, v width 128 instantiations at
    deepseek-v3's shapes (G = 1, causal): the bf16 forward at the serving
    prefill (q [4, 1024, 128, 192]) and at the train microbatch ([1,
    4096, 128, 192]), the bf16 backward at the microbatch, and the f32
    forward and backward at the f32 check shape ([1, 256, 128, 192]).
    Each: per call (CUDA events), device time by CUDA kernel
    (``torch.profiler``), the plain version (over :func:`head_groups`),
    one scaled_dot_product_attention(is_causal=True) call on the same
    inputs (its backward: one ``autograd.grad`` of that call's output,
    the forward outside the timed calls) with the kernels it launched,
    and the bound (:func:`attention_bound`)."""
    import torch.nn.functional as F
    kf, _ = model_kernel_modules()
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    rows = {}
    for tag, B, S, dt in (("serve", SERVE_B, SERVE_P, BF16),
                          ("train", 1, TRAIN_S, BF16),
                          ("f32", 1, MLA_F32_S, F32)):
        H, h, hv = MLA_H, MLA_QK, MLA_V
        q = randn(gen, (B, S, H, h), dev, dt)
        k = randn(gen, (B, S, H, h), dev, dt)
        v = randn(gen, (B, S, H, hv), dev, dt)
        do = randn(gen, (B, S, H, hv), dev, dt)
        fwd_kernel = kf.KERNEL_BF16 if dt == BF16 else kf.KERNEL
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        reps = 20 if tag == "serve" else 10
        before = fwd_kernel.launches
        ms = time_cuda(lambda: kf.flash_attention(q, k, v), reps=reps,
                       warmup=3)
        check(fwd_kernel.launches - before == reps + 3,
              f"mla {tag}: timed calls did not launch the forward kernel")
        _, events = traced(lambda: kf.flash_attention(q, k, v))
        lib_err = float((sdpa().transpose(1, 2).float()
                         - kf.flash_attention(q, k, v).float()).abs().max())
        row = dict(
            shape=[B, S, H, H, h, hv], dtype=str(dt).replace("torch.", ""),
            forward=dict(
                ms=ms, device_us=sum(us for _, us in events),
                plain_ms=time_cuda(lambda: plain_flash(q, k, v, causal=True),
                                   reps=2 if tag == "serve" else 1,
                                   warmup=1),
                library_ms=time_cuda(sdpa, reps=reps, warmup=3),
                library="scaled_dot_product_attention(is_causal=True)",
                library_kernels=sdpa_kernels(sdpa),
                library_vs_kernel_err=lib_err,
                **attention_bound(B, S, S, H, H, h, hv, dt.itemsize)))
        row["forward"]["over_bound"] = ms / row["forward"]["bound_ms"]
        if tag != "serve":
            bwd_kernel = kf.KERNEL_BWD_BF16 if dt == BF16 else kf.KERNEL_BWD
            o, lse = kf.flash_attention_fwd_lse(q, k, v)

            def bwd():
                return kf.flash_attention_bwd(q, k, v, o, do, lse=lse)
            before = bwd_kernel.launches
            bms = time_cuda(bwd, reps=5, warmup=2)
            check(bwd_kernel.launches - before == 7,
                  f"mla {tag}: timed calls did not launch the backward")
            _, events = traced(bwd)
            by_kernel = {}
            for name, us in events:
                m = re.search(r"flash_bwd_\w+?_kernel(<[^>]*>)?", name)
                key = m.group(0) if m else name[:80]
                by_kernel[key] = by_kernel.get(key, 0.0) + us
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            dout = do.transpose(1, 2)
            row["backward"] = dict(
                ms=bms, device_us=by_kernel,
                plain_ms=time_cuda(lambda: plain_bwd(q, k, v, o, do,
                                                     causal=True),
                                   reps=1, warmup=1),
                library_ms=time_cuda(lambda: torch.autograd.grad(
                    out, (qg, kg, vg), dout, retain_graph=True), reps=5,
                    warmup=2),
                library="torch.autograd.grad of scaled_dot_product_attention"
                        "(is_causal=True)",
                library_kernels=sdpa_kernels(lambda: torch.autograd.grad(
                    out, (qg, kg, vg), dout, retain_graph=True)),
                **attention_bound(B, S, S, H, H, h, hv, dt.itemsize,
                                  backward=True))
            row["backward"]["over_bound"] = bms / row["backward"]["bound_ms"]
            del o, lse, qg, kg, vg, out
        rows[tag] = row
        log(phase="timing/mla_flash", name=tag, **row)
        del q, k, v, do, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    if len(sys.argv) == 7 and sys.argv[1] == "--mesh-child":
        tag, rank, world, backend, d = sys.argv[2:]
        return mesh_child(tag, int(rank), int(world), backend, Path(d))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global HBM_BYTES_PER_S, BF16_FLOPS_PER_S
    from repro_torch.analysis import roofline
    HBM_BYTES_PER_S, BF16_FLOPS_PER_S = roofline.HBM_BW, roofline.PEAK_BF16
    # the train phases run in PyTorch's deterministic mode, which asks for
    # this cuBLAS setting before the process's first matrix product
    from repro_torch.train.trainer import set_cublas_workspace
    set_cublas_workspace()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))

    last = [time.perf_counter()]

    def mark(name: str) -> None:
        """Log the wall seconds since the previous mark."""
        now = time.perf_counter()
        log(phase_seconds=name, seconds=now - last[0])
        last[0] = now

    build_kernels()
    mark("build")
    errors = kernel_phase(dev)

    t0 = time.perf_counter()
    tiles_np = make_traffic(T_MAIN, SEED)
    tiles_cpu = [torch.from_numpy(x.view(np.int32)) for x in tiles_np]
    tiles_dev = [x.to(dev) for x in tiles_cpu]
    log(phase="traffic", seconds=time.perf_counter() - t0,
        bytes=sum(x.nbytes for x in tiles_np))

    # the main path: counts are reset right before each drive of it
    main_want, main = run_family("gated_recycled", tiles_cpu, tiles_dev,
                                 dev, host_ticks=True)
    main_launches = main["graph"]["launches"]
    retired = main["run"]["engine"].state.core.rs.retired
    check(int(retired.min()) >= 6 * W,
          f"only {int(retired.min()) / W:.2f} window generations retired")
    for family in ("plain", "recycled", "gated"):
        run_family(family, tiles_cpu, tiles_dev, dev, host_ticks=False)

    graph_kernel_phase(dev, tiles_dev)
    timings = time_kernels(dev, tiles_dev)
    single = time_quorum_single(dev)
    engine = time_engine(tiles_dev, dev)
    profile_ticks(tiles_dev, dev)
    del tiles_dev
    mark("engine")
    dense = dense_ticks_phase(dev)
    dryrun_phase()
    mark("dense_ticks, dryrun")
    # the closed pipeline: its drive resets the counts first
    pipe = pipeline_phase(dev, engine["ticks_per_s"])
    # adaptive batching and its subtick mode: each drive resets the
    # counts first; then the bandwidth accounting
    t0 = time.perf_counter()
    adaptive = adaptive_engine_phase(dev, tiles_cpu)
    pipe_adaptive = adaptive_pipeline_phase(dev, pipe, engine["ticks_per_s"])
    bandwidth = bandwidth_phase(dev)
    log(phase="adaptive/seconds", seconds=time.perf_counter() - t0)
    # the meshed engine: each world's children reset their counts
    # before each drive
    mesh = mesh_phase(dev, tiles_np, main_want, main["run"]["engine"].state,
                      adaptive, pipe)
    del tiles_np
    torch.cuda.empty_cache()
    mark("pipeline, adaptive, mesh")

    # the model-serving path: each model's drive resets the counts first
    model_errors = model_kernel_phase(dev)
    serves = {kernel: serve_phase(arch, kernel, dev)
              for arch, kernel, _ in SERVE_ARCHS}
    serves_f32 = serve_f32_phase(dev)
    serve_cpu_phase(dev)
    serve_cli(dev)
    model_timing = time_model_kernels(dev)
    mark("serve")

    # the training path: the train cell's drive resets the counts first
    bwd_check = bwd_kernel_phase(dev)
    for name, err in bwd_check["forward_max_abs_err"].items():
        model_errors[name] = max(model_errors[name], err)
    wkv_bwd_check = wkv_bwd_phase(dev)
    train = train_phase(dev)
    train_f32 = train_f32_phase(dev)
    checkpoint_phase(dev)
    # the training service over the port's HT-Paxos: its drive resets
    # the counts first
    smr = smr_phase(dev)
    mark("train")
    # RWKV6 through the WKV6 backward kernel: its drive resets the counts
    # first
    rwkv_train = rwkv_train_phase(dev)
    mark(f"train/{RWKV_ARCH}")
    # the vision-language family: each drive resets the counts first
    vlm_serve = vlm_serve_phase(dev)
    mark(f"serve/{VLM_ARCH}")
    vlm_train = vlm_train_phase(dev)
    mark(f"train/{VLM_ARCH}")
    # the MoE family: each drive resets the counts first
    moe_serve = moe_serve_phase(dev)
    mark(f"serve/{MOE_ARCH}")
    moe_train = moe_train_phase(dev)
    mark(f"train/{MOE_ARCH}")
    # the hybrid family: each drive resets the counts first
    hymba_serve = hymba_serve_phase(dev)
    mark(f"serve/{HYMBA_ARCH}")
    hymba_train = hymba_train_phase(dev)
    mark(f"train/{HYMBA_ARCH}")
    # the encoder-decoder family: each drive resets the counts first
    whisper_serve = whisper_serve_phase(dev)
    mark(f"serve/{WHISPER_ARCH}")
    whisper_train = whisper_train_phase(dev)
    mark(f"train/{WHISPER_ARCH}")
    # the MLA family: each drive resets the counts first
    ds_serve = ds_serve_phase(dev)
    mark(f"serve/{DS_ARCH}")
    ds_train = ds_train_phase(dev)
    mark(f"train/{DS_ARCH}")
    bwd_timing = time_bwd_kernel(dev, bwd_check["info"])
    mark("timing/flash_bwd")
    mla = time_mla_flash(dev)
    mark("timing/mla_flash")

    cells = f"gloo{MESH_GLOO_WORLDS[0]}"    # the mesh's adaptive, pipeline
    by_name = {}
    for row in timings:                  # first row per kernel: main shape
        by_name.setdefault(row["name"], row)
    kernels = []
    for i, (name, src, replaces) in enumerate((
            ("quorum_update_grouped", "src/repro_torch/kernels/csrc/quorum.cu",
             "src/repro/kernels/quorum.py:108"),
            ("stability_update_grouped",
             "src/repro_torch/kernels/csrc/dissem.cu",
             "src/repro/kernels/dissem.py:63"))):
        row, launches = by_name[name], main_launches[i]
        graph = main["graph"]
        replayed = (graph["recorded"][name] * graph["replays"])
        by_path = {"engine/graph": launches,
                   "engine/graph/replayed_run":
                       graph["replayed_run_device_launches"][i],
                   "engine": main["run"]["launches"][i],
                   "pipeline/graph": pipe["graph_replayed"][i],
                   **{f"adaptive/{k}/graph": v["graph_recorded"][name]
                      * v["graph_replays"] for k, v in adaptive.items()},
                   "pipeline": pipe["launches"][i],
                   **{f"adaptive/{k}": v["launches"][i]
                      for k, v in adaptive.items()},
                   "pipeline/adaptive": pipe_adaptive["launches"][i],
                   **{f"engine/mesh/{tag}": sum(r["run"]["launches"][i]
                                                for r in ranks)
                      for tag, ranks in mesh.items()},
                   **{f"{path}/mesh": sum(r[path]["launches"][i]
                                          for r in mesh[cells])
                      for path in ("adaptive", "pipeline")},
                   "dense_ticks": dense["launches"][i]}
        check(all(v > 0 for v in by_path.values()),
              f"{name} was not launched on every engine path: {by_path}")
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=launches,
                     launches_counted="kernel events on the card in a "
                                      "torch.profiler trace of the main "
                                      "path's run: the capture's warm-up "
                                      "step, then T replays",
                     launches_replayed=replayed,
                     capture_host_calls=graph["capture_host_calls"][i],
                     main_path="Engine.run, captured: a warm-up step and "
                               "the capture, then T replays",
                     launches_by_path=by_path,
                     max_abs_err=errors[name],
                     ms=row["ms"], plain_ms=row["plain_ms"],
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=None, parity="bit-exact",
                     device_ms=row["device_ms"], floor_ms=row["floor_ms"],
                     enqueue_us=row["enqueue_us"],
                     bare_enqueue_us=row["bare_enqueue_us"],
                     shapes=[{k: r[k] for k in (
                         "shape", "ms", "plain_ms", "device_ms", "floor_ms",
                         "enqueue_us", "bare_enqueue_us", "bound_ms",
                         "bytes")}
                         for r in timings if r["name"] == name])
        if name == "quorum_update_grouped":
            entry["also_replaces"] = "src/repro/kernels/quorum.py:72"
            entry["also_replaces_timing"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "device_ms",
                                   "bound_ms", "bound_by", "bytes")}
                for r in single]
        kernels.append(entry)
    csrc = "src/repro_torch/kernels/csrc/"
    vlm_path = (f"serve/{VLM_ARCH} prefill (full depth, {SERVE_B} x "
                f"{vlm_serve['prefill']} positions); train/{VLM_ARCH} "
                f"({vlm_train['layers']} layers, {VLM_TRAIN_STEPS} steps of "
                f"{TRAIN_B} x {TRAIN_S} positions)")
    smr_path = (f"train/smr ({smr['arch']}, {smr['layers']} layers, "
                f"{smr['steps_applied']} steps in the service's pods)")
    hymba_path = (f"serve/{HYMBA_ARCH} prefill ({hymba_serve['layers']} "
                  f"layers, {hymba_serve['windowed_layers']} with window "
                  f"{hymba_serve['window']}, {SERVE_B} x "
                  f"{hymba_serve['positions']} positions); "
                  f"train/{HYMBA_ARCH} ({hymba_train['layers']} layers, "
                  f"{HYMBA_TRAIN_STEPS} steps of {TRAIN_B} x "
                  f"{hymba_train['positions']} positions)")
    whisper_path = (f"serve/{WHISPER_ARCH} prefill ("
                    f"{whisper_serve['encoder_layers']} encoder and "
                    f"{whisper_serve['layers']} decoder layers, {SERVE_B} x "
                    f"{whisper_serve['frames']} frames and {SERVE_P} "
                    f"tokens: encoder, causal and cross calls); "
                    f"train/{WHISPER_ARCH} ({WHISPER_TRAIN_STEPS} steps of "
                    f"{TRAIN_B} x {TRAIN_S} tokens against "
                    f"{whisper_train['frames']} frames)")
    ds_path = (f"serve/{DS_ARCH} prefill ({ds_serve['layers']} layers, "
               f"{ds_serve['experts']} experts at top-"
               f"{ds_serve['top_k']}, {SERVE_B} x {SERVE_P} tokens; MLA at "
               f"q/k width 192, v width 128); train/{DS_ARCH} "
               f"({ds_train['layers']} layers and the MTP block, "
               f"{ds_train['experts']} experts, {DS_TRAIN_STEPS} steps of "
               f"{TRAIN_B} x {TRAIN_S} tokens)")
    ds_fwd = {f"serve/{DS_ARCH} prefill": ds_serve["launches"]
              ["flash_attention"],
              f"train/{DS_ARCH}": ds_train["launches"]["flash_attention"]}
    ds_f32 = {f"serve/{DS_ARCH}/f32 forward and prefill":
              ds_serve["f32"]["launches"],
              f"train/{DS_ARCH}/f32": ds_train["f32"]["launches"]
              ["flash_attention_f32"]}
    ds_bwd = {f"train/{DS_ARCH}": ds_train["launches"]
              ["flash_attention_bwd"]}
    ds_bwd_f32 = {f"train/{DS_ARCH}/f32": ds_train["f32"]["launches"]
                  ["flash_attention_bwd_f32"]}
    moe_path = (f"serve/{MOE_ARCH} prefill ({moe_serve['layers']} layers, "
                f"{moe_serve['experts']} experts, {SERVE_B} x {SERVE_P} "
                f"tokens); train/{MOE_ARCH} ({moe_train['layers']} layers, "
                f"{moe_train['experts']} experts, {MOE_TRAIN_STEPS} steps of "
                f"{TRAIN_B} x {TRAIN_S} tokens)")
    for name, src, replaces in (
            ("flash_attention", csrc + "flash_attention_bf16.cu",
             "src/repro/kernels/flash_attention.py:92"),
            ("wkv6_chunked", csrc + "wkv6.cu",
             "src/repro/kernels/rwkv6_scan.py:66")):
        row, serve = model_timing[name], serves[name]
        launches = serve["launches"][name]
        check(launches > 0, f"{name} was not launched on its serving path")
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, path=f"serve/{serve['arch']} prefill "
                                    f"({serve['layers']} layers)",
            max_abs_err=model_errors[name], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            library=row["library"],
            device_ms=serve["prefill_kernel_us"] / 1e3, shape=row["shape"],
            dtype=row["dtype"])
        if name == "wkv6_chunked":
            # one call runs three CUDA kernels: device time of each, per
            # call, in the prefill and in the timing phase; the train
            # path's launches (forward and recompute) and device time
            train_wkv = {f"train/{RWKV_ARCH}": rwkv_train["launches"][name],
                         f"train/{RWKV_ARCH}/f32":
                         rwkv_train["f32"]["launches"][name]}
            check(all(v > 0 for v in train_wkv.values()),
                  f"wkv6 was not launched on its train paths: {train_wkv}")
            entry.update(
                phase_device_ms={p: us / 1e3 for p, us in
                                 serve["prefill_kernel_phase_us"].items()},
                timing_phase_device_ms={p: us / 1e3 for p, us in
                                        row["phase_device_us"].items()},
                workspace_bytes=row["workspace_bytes"],
                train_launches=train_wkv,
                train_device_ms_per_call=rwkv_train["profiled_step"]
                ["wkv_fwd_us_per_call"] / 1e3)
        if name == "flash_attention":
            # the f32 check path: its own kernel, launched by the f32
            # prefill of serve/f32
            f32, f32_src = model_timing["flash_attention_f32"], \
                csrc + "flash_attention.cu"
            f32_launches = serves_f32["yi-6b"]["launches"]
            check(f32_launches > 0, "flash_attention_f32 was not launched "
                  "on the f32 serving path")
            vlm_fwd = {f"serve/{VLM_ARCH} prefill":
                       vlm_serve["launches"][name],
                       f"train/{VLM_ARCH}": vlm_train["launches"][name]}
            vlm_f32 = {f"serve/{VLM_ARCH}/f32 prefill":
                       vlm_serve["f32"]["launches"],
                       f"train/{VLM_ARCH}/f32":
                       vlm_train["f32"]["launches"]["flash_attention_f32"]}
            check(all(v > 0 for v in (*vlm_fwd.values(),
                                      *vlm_f32.values())),
                  f"flash was not launched on every {VLM_ARCH} path: "
                  f"{vlm_fwd}, {vlm_f32}")
            moe_fwd = {f"serve/{MOE_ARCH} prefill":
                       moe_serve["launches"][name],
                       f"train/{MOE_ARCH}": moe_train["launches"][name]}
            moe_f32 = {f"serve/{MOE_ARCH}/f32 forward":
                       moe_serve["f32"]["launches"],
                       f"train/{MOE_ARCH}/f32":
                       moe_train["f32"]["launches"]["flash_attention_f32"]}
            check(all(v > 0 for v in (*moe_fwd.values(),
                                      *moe_f32.values())),
                  f"flash was not launched on every {MOE_ARCH} path: "
                  f"{moe_fwd}, {moe_f32}")
            hymba_fwd = {f"serve/{HYMBA_ARCH} prefill":
                         hymba_serve["launches"][name],
                         f"train/{HYMBA_ARCH}":
                         hymba_train["launches"][name]}
            hymba_f32 = {f"serve/{HYMBA_ARCH}/f32 forward and prefill":
                         hymba_serve["f32"]["launches"],
                         f"train/{HYMBA_ARCH}/f32":
                         hymba_train["f32"]["launches"]
                         ["flash_attention_f32"]}
            check(all(v > 0 for v in (*hymba_fwd.values(),
                                      *hymba_f32.values())),
                  f"flash was not launched on every {HYMBA_ARCH} path: "
                  f"{hymba_fwd}, {hymba_f32}")
            whisper_fwd = {f"serve/{WHISPER_ARCH} prefill":
                           whisper_serve["launches"][name],
                           f"train/{WHISPER_ARCH}":
                           whisper_train["launches"][name]}
            whisper_f32 = {f"serve/{WHISPER_ARCH}/f32 forward and prefill":
                           whisper_serve["f32"]["launches"],
                           f"train/{WHISPER_ARCH}/f32":
                           whisper_train["f32"]["launches"]
                           ["flash_attention_f32"]}
            check(all(v > 0 for v in (*whisper_fwd.values(),
                                      *whisper_f32.values())),
                  f"flash was not launched on every {WHISPER_ARCH} path: "
                  f"{whisper_fwd}, {whisper_f32}")
            hymba_win = hymba_serve["flash"]["window"]
            entry.update(
                train_launches=train["launches"][name],
                train_path=f"train/{train['arch']} ({TRAIN_STEPS} steps)",
                train_device_ms_per_call=train["profiled_step"]
                ["flash_fwd_us_per_call"] / 1e3,
                smr_launches=smr["launches"][name],
                smr_path=smr_path,
                vlm_launches=vlm_fwd,
                vlm_path=vlm_path,
                moe_launches=moe_fwd,
                moe_path=moe_path,
                hymba_launches=hymba_fwd,
                hymba_path=hymba_path,
                hymba_window={k: hymba_win[k] for k in (
                    "shape", "window", "device_us", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "flops")},
                **{f"hymba_{key}": {k: hymba_serve["flash"][key][k]
                                    for k in ("shape", "window",
                                              "device_us", "ms",
                                              "plain_ms", "library_ms",
                                              "bound_ms", "bound_by")}
                   for key in ("global", "train_window")},
                whisper_launches=whisper_fwd,
                whisper_path=whisper_path,
                deepseek_launches=ds_fwd,
                deepseek_path=ds_path,
                **{f"whisper_{key}": {k: row[k] for k in (
                    "shape", "causal", "device_us", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")}
                   for key, row in whisper_serve["flash"].items()},
                sources=[src, f32_src],
                launches_by_source={src: launches, f32_src: f32_launches},
                mla_192x128=mla_entry(mla, "forward", BF16, FLASH_CASES,
                                      ("serve", "train"), ds_fwd),
                f32=dict(source=f32_src, launches=f32_launches,
                         path="serve/f32 yi-6b prefill",
                         mla_192x128=mla_entry(mla, "forward", F32,
                                               FLASH_CASES, ("f32",),
                                               ds_f32),
                         vlm_launches=vlm_f32,
                         moe_launches=moe_f32,
                         hymba_launches=hymba_f32,
                         whisper_launches=whisper_f32,
                         deepseek_launches=ds_f32,
                         max_abs_err=model_errors["flash_attention_f32"],
                         **{k: f32[k] for k in (
                             "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "shape", "dtype")}))
        kernels.append(entry)
    # the backward kernels: no Pallas counterpart, they replace jax.vjp
    # through the jnp flash_attend; bf16 (the train path) on the tensor
    # cores, the f32 check path (train/f32) on the CUDA cores
    row, f32_row = bwd_timing["train"], bwd_timing["serve_f32"]
    launches = train["launches"]["flash_attention_bwd"]
    f32_launches = train_f32["launches"]["flash_attention_bwd_f32"]
    check(launches > 0 and f32_launches > 0
          and vlm_train["launches"]["flash_attention_bwd"] > 0
          and moe_train["launches"]["flash_attention_bwd"] > 0
          and moe_train["f32"]["launches"]["flash_attention_bwd_f32"] > 0
          and hymba_train["launches"]["flash_attention_bwd"] > 0
          and hymba_train["f32"]["launches"]["flash_attention_bwd_f32"] > 0
          and whisper_train["launches"]["flash_attention_bwd"] > 0
          and whisper_train["f32"]["launches"]["flash_attention_bwd_f32"]
          > 0,
          "a flash backward kernel was "
          f"not launched on its train path: bf16 {launches}, f32 "
          f"{f32_launches}")
    bwd_src, bwd_f32_src = (csrc + "flash_attention_bwd_bf16.cu",
                            csrc + "flash_attention_bwd.cu")
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda", source=bwd_src,
        replaces="src/repro/models/layers.py:111",
        pallas_counterpart=None,
        replaces_what="no Pallas kernel: jax.vjp through "
                      "models/layers.py::flash_attend",
        launches=launches, path=f"train/{train['arch']} ({TRAIN_STEPS} "
                                f"steps)",
        smr_launches=smr["launches"]["flash_attention_bwd"],
        smr_path=smr_path,
        vlm_launches={f"train/{VLM_ARCH}":
                      vlm_train["launches"]["flash_attention_bwd"]},
        vlm_path=vlm_path,
        moe_launches={f"train/{MOE_ARCH}":
                      moe_train["launches"]["flash_attention_bwd"]},
        moe_path=moe_path,
        hymba_launches={f"train/{HYMBA_ARCH}":
                        hymba_train["launches"]["flash_attention_bwd"]},
        hymba_path=hymba_path,
        whisper_launches={f"train/{WHISPER_ARCH}":
                          whisper_train["launches"]["flash_attention_bwd"]},
        whisper_path=whisper_path,
        deepseek_launches=ds_bwd,
        deepseek_path=ds_path,
        max_abs_err=bwd_check["max_abs_err"]["flash_attention_bwd"],
        max_err_over_scale=bwd_check["worst_err_over_scale"]
        ["flash_attention_bwd"],
        lse_max_abs_err=bwd_check["lse_max_abs_err"]["flash_attention_bwd"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        library=row["library"],
        device_ms=train["profiled_step"]["flash_bwd_us_per_call"] / 1e3,
        shape=row["shape"], dtype=row["dtype"],
        other_shapes={k: {m: r[m] for m in (
            "shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for k, r in bwd_timing.items()
            if r["kernel"] == "flash_attention_bwd" and k != "train"},
        kernel_info=row["kernel_info"],
        mla_192x128=mla_entry(mla, "backward", BF16, BWD_CASES, ("train",),
                              ds_bwd, info=bwd_check["info"]),
        sources=[bwd_src, bwd_f32_src],
        launches_by_source={bwd_src: launches, bwd_f32_src: f32_launches},
        f32=dict(source=bwd_f32_src, launches=f32_launches,
                 path=f"train/f32 (one step, {F32_TRAIN_LAYERS} layers)",
                 vlm_launches={f"train/{VLM_ARCH}/f32": vlm_train["f32"]
                               ["launches"]["flash_attention_bwd_f32"]},
                 moe_launches={f"train/{MOE_ARCH}/f32": moe_train["f32"]
                               ["launches"]["flash_attention_bwd_f32"]},
                 hymba_launches={f"train/{HYMBA_ARCH}/f32": hymba_train[
                     "f32"]["launches"]["flash_attention_bwd_f32"]},
                 whisper_launches={f"train/{WHISPER_ARCH}/f32":
                                   whisper_train["f32"]["launches"]
                                   ["flash_attention_bwd_f32"]},
                 deepseek_launches=ds_bwd_f32,
                 max_abs_err=bwd_check["max_abs_err"]
                 ["flash_attention_bwd_f32"],
                 max_err_over_scale=bwd_check["worst_err_over_scale"]
                 ["flash_attention_bwd_f32"],
                 lse_max_abs_err=bwd_check["lse_max_abs_err"]
                 ["flash_attention_bwd_f32"],
                 kernel_info=f32_row["kernel_info"],
                 mla_192x128=mla_entry(mla, "backward", F32, BWD_CASES,
                                       ("f32",), ds_bwd_f32,
                                       info=bwd_check["info"]),
                 **{k: f32_row[k] for k in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "shape", "dtype", "device_us", "pass_tflops_per_s",
                     "tflops_per_s", "over_bound", "over_library",
                     "forward_ms")})))
    # the WKV6 backward: no Pallas counterpart, it replaces jax.grad through
    # the jnp chunked RWKV6 time mix; launched by train/rwkv6-3b (bf16) and
    # its f32 step
    row = model_timing["wkv6_chunked_bwd"]
    launches = rwkv_train["launches"]["wkv6_chunked_bwd"]
    f32_launches = rwkv_train["f32"]["launches"]["wkv6_chunked_bwd"]
    check(launches > 0 and f32_launches > 0, "the WKV6 backward kernel was "
          f"not launched on its train paths: {launches}, {f32_launches}")
    kernels.append(dict(
        name="wkv6_chunked_bwd", route="cuda", source=csrc + "wkv6_bwd.cu",
        replaces="src/repro/models/ssm.py:72", pallas_counterpart=None,
        replaces_what="no Pallas kernel: jax.grad through "
                      "models/ssm.py::rwkv6_chunked",
        launches=launches,
        path=f"train/{RWKV_ARCH} ({rwkv_train['layers']} layers, "
             f"{RWKV_TRAIN_STEPS} steps of {RWKV_TRAIN_B} x {TRAIN_S} "
             f"tokens in {rwkv_train['microbatches']} microbatches)",
        f32_launches={f"train/{RWKV_ARCH}/f32": f32_launches},
        max_abs_err=wkv_bwd_check["max_abs_err"],
        worst_err_over_tol=wkv_bwd_check["worst_err_over_tol"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        library=row["library"],
        device_ms=rwkv_train["profiled_step"]["wkv_bwd_us_per_call"] / 1e3,
        pass_device_ms={p: us / 1e3 for p, us in rwkv_train["profiled_step"]
                        ["wkv_bwd_pass_us_per_call"].items()},
        timing_pass_device_ms={p: us / 1e3 for p, us in
                               row["phase_device_us"].items()},
        shape=row["shape"], dtype=row["dtype"],
        workspace_bytes=row["workspace_bytes"],
        kernel_info=row["kernel_info"]))
    log(train={k: train[k] for k in ("seconds_per_step", "tokens_per_s",
                                     "peak_mem_bytes")},
        train_rwkv={k: rwkv_train[k] for k in (
            "seconds_per_step", "tokens_per_s", "peak_mem_bytes",
            "seconds")},
        smr={k: smr[k] for k in (
            "seconds_per_step", "tokens_per_s", "ckpt_save_seconds",
            "ckpt_restore_seconds", "des_host_seconds", "peak_mem_bytes",
            "seconds")})
    graph_profiles = {"engine": main["graph"]["profile"],
                      "pipeline": pipe["graph_profile"],
                      "adaptive_skew": adaptive["skew"]["graph_profile"]}
    log(engine={k: engine[k] for k in (
        "ticks_per_s", "committed_ids_per_s", "graph_ticks_per_s",
        "graph_committed_ids_per_s", "eager_turn_ticks_per_s",
        "graph_turn_ticks_per_s", "replay_host_us", "step_host_us",
        "tick_loop_ticks_per_s", "generations_min")},
        graph_profile={k: {m: v[m] for m in (
            "kernels_per_step", "device_us_per_step", "wall_us_per_step",
            "device_busy_share")} for k, v in graph_profiles.items()},
        pipeline={k: pipe["timing"][k] for k in (
            "ticks_per_s", "committed_ids_per_s", "committed_requests_per_s",
            "ratio_to_engine_ticks_per_s", "graph_ticks_per_s",
            "eager_ticks_per_s", "graph_committed_requests_per_s")},
        adaptive={k: {m: v[m] for m in (
            "passes", "rounds_sum", "k_times_passes",
            "lockstep_committed_ids_per_s", "adaptive_committed_ids_per_s",
            "adaptive_over_lockstep_ids_per_s",
            "graph_lockstep_committed_ids_per_s",
            "graph_adaptive_committed_ids_per_s",
            "graph_adaptive_over_lockstep_ids_per_s")}
            for k, v in adaptive.items()},
        pipeline_adaptive={k: {m: v[m] for m in (
            "ticks_per_s", "committed_ids_per_s",
            "committed_requests_per_s")}
            for k, v in pipe_adaptive["timing"].items()},
        bandwidth={r["groups"]: r["per_node_in_bytes"] for r in bandwidth},
        mesh={tag: dict(run_ticks_per_s=[r["run"]["ticks_per_s"]
                                         for r in ranks],
                        **ranks[0].get("timing", {}))
              for tag, ranks in mesh.items()})
    log(serve={s["arch"]: {k: s[k] for k in (
        "prefill_tokens_per_s", "decode_tokens_per_s", "peak_mem_bytes")}
        for s in (*serves.values(), vlm_serve, moe_serve, hymba_serve,
                  whisper_serve, ds_serve)},
        vlm={f"serve/{VLM_ARCH}": {k: vlm_serve[k] for k in (
            "prefill_ms", "prefill_tokens_per_s", "decode_ms_per_step",
            "decode_tokens_per_s", "peak_mem_bytes", "seconds")},
            f"train/{VLM_ARCH}": {k: vlm_train[k] for k in (
                "seconds_per_step", "tokens_per_s", "peak_mem_bytes",
                "seconds")}},
        moe={f"serve/{MOE_ARCH}": {k: moe_serve[k] for k in (
            "prefill_ms", "prefill_tokens_per_s", "decode_ms_per_step",
            "decode_tokens_per_s", "peak_mem_bytes", "moe", "seconds")},
            f"train/{MOE_ARCH}": {k: moe_train[k] for k in (
                "seconds_per_step", "tokens_per_s", "peak_mem_bytes",
                "seconds")}},
        hymba={f"serve/{HYMBA_ARCH}": {k: hymba_serve[k] for k in (
            "prefill_ms", "prefill_tokens_per_s", "meta_ms_per_step",
            "teacher_forced_ms_per_step", "decode_ms_per_step",
            "decode_tokens_per_s", "peak_mem_bytes", "seconds")},
            f"train/{HYMBA_ARCH}": {k: hymba_train[k] for k in (
                "seconds_per_step", "tokens_per_s", "peak_mem_bytes",
                "seconds")},
            "mamba_share": {"prefill": hymba_serve["mamba"]["prefill_share"],
                            "train_step": hymba_train["mamba"]
                            ["step_share"]}},
        whisper={f"serve/{WHISPER_ARCH}": {k: whisper_serve[k] for k in (
            "prefill_ms", "prefill_tokens_per_s",
            "teacher_forced_ms_per_step", "decode_ms_per_step",
            "decode_tokens_per_s", "peak_mem_bytes", "seconds")},
            f"train/{WHISPER_ARCH}": {k: whisper_train[k] for k in (
                "seconds_per_step", "tokens_per_s", "peak_mem_bytes",
                "seconds")}},
        deepseek={f"serve/{DS_ARCH}": {k: ds_serve[k] for k in (
            "prefill_ms", "prefill_tokens_per_s", "prefill_device_us",
            "teacher_forced_ms_per_step", "decode_ms_per_step",
            "decode_tokens_per_s", "peak_mem_bytes", "moe", "seconds")},
            f"train/{DS_ARCH}": {k: ds_train[k] for k in (
                "seconds_per_step", "tokens_per_s", "peak_mem_bytes",
                "seconds")}},
        profile_retries=PROFILE_RETRIES,
        seconds=time.perf_counter() - START)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
