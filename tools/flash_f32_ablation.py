#!/usr/bin/env python3
"""Time the f32 flash-attention kernel (``csrc/flash_attention.cu``)
against variants of its own source on one CUDA card.

Usage, from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/flash_f32_ablation.py [--parent DIR]

Every variant is the committed source with one design choice taken back
(a text edit that must apply), built with the port's nvcc flags and
launched through its C launcher at the yi-6b prefill shape in f32 (q
[4,1024,32,128], k/v [4,1024,4,128], causal). Each is checked against
the plain version (2e-5) and timed with CUDA events (20 calls after 3 of
warm-up), twice: in order, then in reverse order. ``--parent DIR`` adds
the kernel of another checkout (for example ``git archive`` of the
parent commit, unpacked into a directory that ``.gitignore`` lists), with
the launcher signature it has. One JSON line per variant; the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SHAPE = (4, 1024, 32, 4, 128)        # B, S, H, K, h = hv
TOL = 2e-5

WAIT_TOP = """    cp_async_wait_all();  // this tile (and Q) has landed for this thread,
    __syncthreads();      // for every thread, and no warp still reads the
                          // other stage
    if (kt < kt_end) {    // the next tile into the other stage"""
WAIT_ONE = 'asm volatile("cp.async.wait_group 1;\\n" ::: "memory");'
COMMIT = """    cp_async_commit();
    const float* sk = skv + stage * 2 * kTile;"""
LOOP_END = """    stage ^= 1;
  }"""
LOAD_LOOP = """  const int c = kPer * (tid % kCols), r = tid / kCols;
  const bool col_in = c < width;
  size_t off = (size_t)(row0 + r) * row_stride + c;
  uint32_t to = smem_addr(dst + r * kS + c);
#pragma unroll
  for (int it = 0; it < kR / kStep; ++it) {
    const bool in = col_in && row0 + r + it * kStep < n_rows;
    if constexpr (kVec)
      cp_async16(to, in ? src + off : src, in ? 16 : 0);
    else
      cp_async4(to, in ? src + off : src, in ? 4 : 0);
    off += kStep * row_stride;
    to += kStep * kS * sizeof(float);
  }"""
LOAD_PER_COPY = """#pragma unroll
  for (int it = 0; it < kR / kStep; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kCols, c = kPer * (i % kCols);
    const bool in = row0 + r < n_rows && c < width;
    const float* p = in ? src + (size_t)(row0 + r) * row_stride + c : src;
    if constexpr (kVec)
      cp_async16(smem_addr(dst + r * kS + c), p, in ? 16 : 0);
    else
      cp_async4(smem_addr(dst + r * kS + c), p, in ? 4 : 0);
  }"""
HEAVIEST = "const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;"
TILE = (("constexpr int kBK = 32;", "constexpr int kBK = 16;"),
        ("constexpr int kKeys = 4; ", "constexpr int kKeys = kBK / 8; "),
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)"))
D_LOOP = "#pragma unroll 8\n    for (int d = 0; d < D; d += 4) {"
K_LOOP = "#pragma unroll 8\n    for (int c = 0; c < kBK; ++c) {"


def edit(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise SystemExit(f"variant edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants(src: str) -> dict[str, str]:
    """name -> source; each takes back one choice of the design."""
    return {
        "kernel": src,
        # the ring with a barrier before the next tile's copy and one
        # after the tile, instead of one barrier a tile
        "two_barriers": edit(
            src,
            (WAIT_TOP, "    if (kt < kt_end) {"),
            (COMMIT, f"    cp_async_commit();\n    {WAIT_ONE}\n"
                     "    __syncthreads();\n"
                     "    const float* sk = skv + stage * 2 * kTile;"),
            (LOOP_END, "    __syncthreads();\n" + LOOP_END)),
        # the next tile's copy waited for at once: no copy under compute
        "no_copy_overlap": edit(
            src, (COMMIT, "    cp_async_commit();\n    cp_async_wait_all();\n"
                          "    const float* sk = skv + stage * 2 * kTile;")),
        # the query tiles in ascending order: the heaviest causal tiles last
        "lightest_first": edit(src, (HEAVIEST,
                                     "const int q0 = blockIdx.z * kBQ;")),
        # each copy computes its row and column from its index
        "index_per_copy": edit(src, (LOAD_LOOP, LOAD_PER_COPY)),
        # 16-key tiles (72 KB of shared memory at D = 128) and registers
        # capped for 3 blocks per SM, against 32-key tiles at 2
        "keys16_3_blocks": edit(src, *TILE),
        # the two products' loops unrolled fully, not by 8
        "unroll_full": edit(src, (D_LOOP, D_LOOP.replace(" 8", "")),
                            (K_LOOP, K_LOOP.replace(" 8", ""))),
    }


def build(named: dict[str, Path], out_dir: Path) -> dict[str, dict]:
    """Compile every source (all nvcc processes at once) with the port's
    flags; name -> {"lib": path, "ptxas": [register/spill lines]}."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in named.items():
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{text}")
        built[name] = dict(lib=lib, ptxas=[
            ln.strip() for ln in text.splitlines()
            if "Used" in ln or "spill" in ln])
    return built


def time_cuda(fn, reps=20, warmup=3) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose f32 kernel is timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    work = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "ablation"
    work.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, text in variants((ROOT / SOURCE).read_text()).items():
        sources[name] = work / f"{name}.cu"
        sources[name].write_text(text)
    if args.parent is not None:
        sources["parent"] = args.parent.resolve() / SOURCE
    built = build(sources, work)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as kf
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    B, S, H, K, h = SHAPE
    q = torch.randn((B, S, H, h), generator=gen, device=dev)
    k = torch.randn((B, S, K, h), generator=gen, device=dev)
    v = torch.randn((B, S, K, h), generator=gen, device=dev)
    want = kf.flash_attention_plain(q, k, v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    base = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            S, H, K, h, h, 1, -1, 1.0 / math.sqrt(h)]
    calls = {}
    for name, b in built.items():
        fn = ctypes.CDLL(str(b["lib"])).flash_attention_launch
        fn.restype = I
        # a launcher with (width, vec) before the stream, or without
        plan = "int vec" in sources[name].read_text()
        fn.argtypes = [P] * 4 + [I] * 9 + [ctypes.c_float] + \
            ([I, I] if plan else []) + [P]
        extra = [128, 1] if plan else []
        calls[name] = (fn, base + extra + [stream])
        if name == "kernel":    # the same kernel's 4-byte copy path
            calls["copy_4byte"] = (fn, base + [128, 0, stream])
    flops = B * H * S * (S + 1) // 2 * 4 * h
    rows = {}
    for name, (fn, argv) in calls.items():
        out.zero_()
        err = fn(*argv)
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"{name}: launch error {err}")
        diff = float((out - want).abs().max())
        if not diff <= TOL:
            raise SystemExit(f"{name}: max abs err {diff} > {TOL}")
        key = "kernel" if name == "copy_4byte" else name
        rows[name] = dict(variant=name, max_abs_err=diff, us=[],
                          ptxas=built[key]["ptxas"])
    order = list(calls)
    for name in order + order[::-1]:
        fn, argv = calls[name]
        rows[name]["us"].append(1e3 * time_cuda(lambda: fn(*argv)))
    for row in rows.values():
        row["tflops_per_s"] = flops / (min(row["us"]) * 1e6)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
