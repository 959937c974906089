#!/usr/bin/env python3
"""Time the WKV6 backward kernel (``csrc/wkv6_bwd.cu``) against the same
kernel of another checkout on one CUDA card, in turns.

Usage, from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/wkv6_bwd_turns.py --parent DIR [--reps 20]

``DIR`` is another checkout (for example ``git archive`` of the parent
commit, unpacked into a directory that ``.gitignore`` lists) whose
``wkv6_bwd.cu`` has the same C launcher and workspace rule. Both sources
are built with the port's nvcc flags (registers and spills from ptxas,
and each pass's registers, spill bytes, shared bytes and blocks per SM
from ``wkv6_bwd_info``). At the rwkv6-3b train microbatch [1, 4096, 40,
64] and at hd 128 ([1, 4096, 20, 128]), r/k/v bf16, on one forward's
saved states, each kernel is checked against ``wkv6_chunked_bwd_plain``
(the tolerances of ``chip_smoke.py``'s WKV_BWD_TOL) and for equal bytes
over two launches, then timed with CUDA events (``--reps`` calls after 3
of warm-up) in the turns parent, kernel, kernel, parent; each pass's
device time comes from ``torch.profiler``. One JSON line per (shape,
kernel); the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from flash_f32_ablation import build, time_cuda

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "src/repro_torch/kernels/csrc/wkv6_bwd.cu"
SHAPES = ((1, 4096, 40, 64), (1, 4096, 20, 128))
PASSES = ("wkv6bwd_adjoint_kernel", "wkv6bwd_scan_kernel",
          "wkv6bwd_grad_kernel", "wkv6bwd_du_kernel")
TOL = {"dr": 8e-3, "dk": 8e-3, "dv": 8e-3, "dwlog": 2e-5, "du": 2e-5}


def pass_info(lib) -> dict:
    """Each pass's registers, spill bytes, shared bytes and blocks/SM at
    hd 64 and 128 (``wkv6_bwd_info``, the bf16 instantiation)."""
    out = {}
    for hd in (64, 128):
        for phase, name in enumerate(PASSES, start=1):
            vals = [ctypes.c_int() for _ in range(4)]
            err = lib.wkv6_bwd_info(phase, hd, *map(ctypes.byref, vals))
            if err:
                raise SystemExit(f"wkv6_bwd_info({phase}, {hd}): {err}")
            out[f"{name}/hd{hd}"] = dict(zip(
                ("registers", "spill_bytes", "smem_bytes_per_block",
                 "blocks_per_sm"), (v.value for v in vals)))
    return out


def pass_us(fn, calls: int = 5) -> dict:
    """Device µs a call of each pass under torch.profiler, behind a
    lead-in of ``torch.cuda._sleep(0)`` launches (the profiler may lose
    the first records of a trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(PASSES, 0.0)
    for ev in prof.events():
        for name in PASSES:
            if name in ev.name and ev.device_type == DeviceType.CUDA:
                us[name] += ev.time_range.elapsed_us() / calls
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the checkout whose backward kernel is timed too")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv6_bwd_turns: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    work = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "turns"
    built = build({"kernel": ROOT / SOURCE,
                   "parent": args.parent.resolve() / SOURCE}, work)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import rwkv6_scan as kw
    P, I = ctypes.c_void_p, ctypes.c_int
    fns, info = {}, {}
    for name, b in built.items():
        lib = ctypes.CDLL(str(b["lib"]))
        fn = lib.wkv6_bwd_launch
        fn.argtypes, fn.restype = [P] * 13 + [I] * 5 + [P], I
        fns[name] = fn
        info[name] = pass_info(lib)
    dev = torch.device("cuda")
    for B, S, H, hd in SHAPES:
        gen = torch.Generator(dev).manual_seed(S + H + hd)
        r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        wlog = -torch.nn.functional.softplus(0.3 * torch.randn(
            (B, S, H, hd), generator=gen, device=dev)) - 1e-4
        u = 0.1 * torch.randn((H, hd), generator=gen, device=dev)
        do = torch.randn((B, S, H, hd), generator=gen, device=dev)
        _, states = kw.wkv6_fwd(r, k, v, wlog, u)
        want = kw.wkv6_chunked_bwd_plain(r, k, v, wlog, u, do, chunk=kw.CHUNK)
        outs = [torch.empty_like(x) for x in (r, k, v, wlog, u)]
        wsp = torch.empty((kw.bwd_workspace_floats(B, S, H, hd),),
                          dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        for name, fn in fns.items():
            argv = [x.data_ptr() for x in (r, k, v, wlog, u, do, states,
                                           *outs, wsp)] + [B, S, H, hd, 1,
                                                           stream]

            def call(fn=fn, argv=argv):
                err = fn(*argv)
                if err:
                    raise SystemExit(f"wkv6_bwd_launch: error {err}")
            calls[name] = call
        rows = {}
        for name, call in calls.items():
            call()
            first = [x.clone() for x in outs]
            call()
            torch.cuda.synchronize()
            errs = {}
            for key, a, b in zip(TOL, first, want):
                scale = float(b.float().abs().max()) + 1.0
                err = float((a.float() - b.float()).abs().max())
                if not (bool(torch.isfinite(a).all()) and
                        err <= TOL[key] * scale):
                    raise SystemExit(f"{name} {key}: max abs err {err} > "
                                     f"{TOL[key]} x {scale}")
                errs[key] = err / (TOL[key] * scale)
            rows[name] = dict(
                shape=[B, S, H, hd], kernel=name, err_over_tol=errs,
                same_bytes_twice=all(torch.equal(a, b)
                                     for a, b in zip(first, outs)),
                ms=[], pass_us=pass_us(call), ptxas=built[name]["ptxas"],
                info={key: val for key, val in info[name].items()
                      if key.endswith(f"hd{hd}")})
        for name in ("parent", "kernel", "kernel", "parent"):
            rows[name]["ms"].append(time_cuda(calls[name], reps=args.reps))
        for row in rows.values():
            print(json.dumps(row), flush=True)
        del r, k, v, wlog, u, do, states, want, outs, wsp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
