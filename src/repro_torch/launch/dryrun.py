"""Multi-pod dry run: lay out every (arch × shape × mesh) cell on the
meta device. Counterpart of ``repro.launch.dryrun``.

For each cell this launcher:
  * builds the cell's state (train: parameters, optimizer state and step;
    prefill and decode: the parameters), batch and, for decode, its cache
    on the meta device (shapes and dtypes, no storage);
  * lays each of them out on the production mesh (``launch.mesh``:
    16 × 16, or 2 × 16 × 16 with two pods; abstract, with no ranks) with
    the layout rules of ``launch.sharding``: the state by its logical axes
    (``train.trainer.state_axes``), the batch by ``batch_pspec``, the
    cache by ``cache_shardings``; a non-divisible rule falls back as the
    reference's does;
  * records ``argument_bytes_per_device``: the bytes of every argument
    leaf's shard under its layout, summed (the counterpart of XLA's
    ``memory_analysis().argument_size_in_bytes``), and the same split by
    input in ``argument_bytes_by_input``.

The record keeps the reference's keys that have a counterpart: ``arch``,
``shape``, ``mesh``, ``chips``, ``kind``, ``seq_len``, ``global_batch``,
``status``, ``reason`` (a skipped cell), ``opt``, ``microbatches``,
``params``, ``grad_dtype``; a cell that raises is recorded with
``status: "error"``, ``error`` and ``trace``. It leaves out what only
XLA's compile of the step gives: ``t_lower_s``, ``t_compile_s``,
``xla_flops_per_device``, ``xla_bytes_accessed``,
``hlo_flops_per_device``, ``hlo_bytes_per_device``,
``collective_bytes_per_device``, ``collectives``, the rest of
``memory_analysis`` (output, temp, alias and generated-code bytes),
``hlo_n_computations`` and ``hlo_text_path`` (``--keep-hlo``). The dry
run allocates nothing and runs no step, so it needs no card.

Inputs keep the reference's shapes (:func:`input_specs`). Their dtypes
are the port's entry points': tokens, labels and the decode step's
``index`` are int64 (the reference's are int32), positions int32,
embeddings and frames ``cfg.dtype``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out dryrun_results.json
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import traceback

import torch

from ..configs import registry
from ..models import decode as D
from ..models import transformer as T
from ..models.common import SHAPES, ModelConfig, param_count
from ..train.optimizer import OptConfig, choose_optimizer
from ..train.trainer import make_state, state_axes
from .mesh import make_production_mesh
from .sharding import (Sharding, batch_pspec, cache_shardings,
                       sharded_bytes, tree_shardings)

META = torch.device("meta")


# ---------------------------------------------------------------------------
# meta inputs per (arch × shape)
# ---------------------------------------------------------------------------

def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta stand-ins for every model input of this cell, in the
    reference's shapes. Modality frontends are stubs: audio supplies
    precomputed frame embeddings, vlm supplies embeddings and M-RoPE
    position ids."""
    cell = SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    i64, i32 = torch.int64, torch.int32
    if cell.kind in ("train", "prefill"):
        batch = {"tokens": _empty((B, S), i64)}
        if cfg.family == "vlm":
            batch["embeds"] = _empty((B, S, cfg.d_model), cfg.dtype)
            batch["positions"] = _empty((3, B, S), i32)
            batch["labels"] = _empty((B, S), i64)
        if cfg.is_encoder_decoder:
            batch["frames"] = _empty((B, cfg.encoder_len, cfg.d_model),
                                     cfg.dtype)
        return batch
    # decode: one new token against a seq_len cache
    batch = {"index": _empty((), i64)}
    if cfg.family == "vlm":
        batch["embeds"] = _empty((B, 1, cfg.d_model), cfg.dtype)
        batch["positions"] = _empty((3, B, 1), i32)
    else:
        batch["token"] = _empty((B, 1), i64)
    return batch


def batch_shardings(mesh, batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        if k == "positions":
            spec = batch_pspec(mesh, tuple(v.shape), batch_dim=1)
        elif v.dim() == 0:
            spec = ()
        else:
            spec = batch_pspec(mesh, tuple(v.shape), batch_dim=0,
                               seq_dim=1 if v.dim() > 1 else None)
        out[k] = Sharding(mesh, spec)
    return out


def cell_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: long_500k requires "
                       "sub-quadratic attention (spec skip, DESIGN.md)")
    return True, ""


# ---------------------------------------------------------------------------
# laying out one cell
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _meta_params(arch: str):
    return T.init_lm(registry.get(arch), None, META)


@functools.lru_cache(maxsize=None)
def _meta_state(arch: str, opt_kind: str):
    cfg, opt = registry.get(arch), OptConfig(kind=opt_kind)
    state = make_state(cfg, opt, None, META)
    return state, state_axes(cfg, opt, state["params"])


def state_bytes_per_device(cfg: ModelConfig, opt_cfg: OptConfig,
                           mesh) -> int:
    """One device's bytes of :func:`make_state`'s state laid out on
    ``mesh`` by its logical axes, from the state on the meta device."""
    state = make_state(cfg, opt_cfg, None, META)
    axes = state_axes(cfg, opt_cfg, state["params"])
    return sharded_bytes(state, tree_shardings(mesh, state, axes))


def lower_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = registry.get(arch)
    cell = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod
        else "single", "chips": mesh.size, "kind": cell.kind,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
    }
    ok, why = cell_applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    batch = input_specs(cfg, shape_name)
    by_input = {"batch": sharded_bytes(batch, batch_shardings(mesh, batch))}
    if cell.kind == "train":
        n_params = param_count(_meta_params(arch))
        opt_kind = choose_optimizer(n_params)
        state, axes = _meta_state(arch, opt_kind)
        by_input["state"] = sharded_bytes(
            state, tree_shardings(mesh, state, axes))
        rec.update(opt=opt_kind,
                   microbatches=registry.microbatches(arch, shape_name),
                   params=n_params,
                   grad_dtype="bfloat16" if n_params >= 3e11
                   else "float32")
    else:
        params = _meta_params(arch)
        by_input["params"] = sharded_bytes(
            params, tree_shardings(mesh, params, T.param_axes(cfg)))
        if cell.kind == "decode":
            cspec = D.cache_spec(cfg, cell.global_batch, cell.seq_len)
            by_input["cache"] = sharded_bytes(
                D.cache_abstract(cspec), cache_shardings(mesh, cspec))
        rec.update(params=param_count(params))
    rec.update(status="ok",
               argument_bytes_per_device=sum(by_input.values()),
               argument_bytes_by_input=by_input)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    archs = registry.ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "multi" if mp else "single")
                if key in done:
                    print(f"[skip-cached] {key}")
                    continue
                print(f"[layout] {key} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape, mp)
                except Exception as e:  # a failure IS a result: a bug
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                if rec.get("status") == "ok":
                    print(f"   ok: argument bytes/device "
                          f"{rec['argument_bytes_per_device'] / 2**30:.2f}"
                          f" GiB", flush=True)
                else:
                    print(f"   {rec['status']}: "
                          f"{rec.get('reason', rec.get('error', ''))[:300]}",
                          flush=True)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skipped")
    n_err = sum(1 for r in results if r.get("status") == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped(spec), {n_err} errors")


if __name__ == "__main__":
    main()
