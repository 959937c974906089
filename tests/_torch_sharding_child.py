"""One rank of the 4-rank layout run (``tests/test_torch_sharding.py``).

Run as a script, one process per rank:

    python tests/_torch_sharding_child.py OUT_JSON RANK WORLD INIT_FILE

Each rank joins a gloo process group (``file://INIT_FILE``, a 60 s
timeout), builds the host mesh (``launch.mesh.make_host_mesh``), draws
the smoke train states of qwen3-14b and deepseek-v3-671b from seed 0 on
the CPU (the same on every rank), lays every leaf out with
``tree_shardings`` and ``place``, and writes, per leaf (in the order of
``models.common.reference_leaves``, one row per layer of a stacked leaf),
its path, its spec, the sha256 of its local block's bytes and whether
``full_tensor()`` equals the leaf bit for bit. Then it pins DTensors of a few shapes with
``models.pconstraint``'s ``constrain_batch`` and ``constrain_expert``
and writes the placements that came out. Imports torch, numpy and
``repro_torch`` only.
"""
from __future__ import annotations

import hashlib
import json
import sys
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.models import pconstraint as PC  # noqa: E402
from repro_torch.models.common import reference_leaves  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

ARCHS = ("qwen3-14b", "deepseek-v3-671b")
# (shape, batch_dim, model_dim) for constrain_batch; (shape, expert_dim)
# for constrain_expert
BATCH_CASES = [((4, 6, 8), 0, None), ((4, 6, 8), 0, 2), ((3, 6, 8), 0, None),
               ((3, 6, 8), 0, 2), ((6, 4), 1, None), ((2, 5, 3), 0, 1)]
EXPERT_CASES = [((4, 6, 8), 0), ((3, 6, 8), 0), ((6, 4, 8), 1)]


def sha(t: torch.Tensor) -> str:
    a = t.detach().contiguous()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return hashlib.sha256(a.numpy().tobytes()).hexdigest()


def pinned(x, out) -> object:
    """The placements of a pinned DTensor, or "same" where the call
    returned its input itself."""
    if out is x:
        return "same"
    return [str(p) for p in out.placements]


def main() -> int:
    out_path, rank, world, init = sys.argv[1:5]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    warnings.filterwarnings("ignore")
    mesh = M.make_host_mesh()
    res = {"mesh": mesh.shape, "device_mesh": mesh.device_mesh is not None,
           "coords": mesh.device_mesh.get_coordinate(), "leaves": {}}
    for arch in ARCHS:
        cfg = registry.get_smoke(arch)
        opt = O.OptConfig(kind="adafactor")
        state = TR.make_state(cfg, opt, torch.Generator().manual_seed(0),
                              "cpu")
        shardings = SH.tree_shardings(
            mesh, state, TR.state_axes(cfg, opt, state["params"]))
        rows = []
        for (path, leaves, stacked), (_, shs, _) in zip(
                reference_leaves(state), reference_leaves(shardings),
                strict=True):
            for i, (leaf, sh) in enumerate(zip(leaves, shs, strict=True)):
                dt = SH.place(leaf, sh)
                local = dt.to_local()
                rows.append({
                    "path": list(path), "layer": i if stacked else None,
                    "shape": list(leaf.shape), "spec": list(sh.spec),
                    "local_shape": list(local.shape),
                    "shard_shape": list(sh.shard_shape(leaf.shape)),
                    "sha": sha(local),
                    "full": bool(torch.equal(dt.full_tensor(),
                                             leaf.detach()))})
        res["leaves"][arch] = rows
    from torch.distributed.tensor import Replicate, distribute_tensor
    PC.set_mesh(mesh)
    rep = [Replicate()] * len(mesh.axis_names)
    gen = torch.Generator().manual_seed(1)
    res["batch"] = []
    for shape, bdim, mdim in BATCH_CASES:
        x = distribute_tensor(torch.randn(shape, generator=gen),
                              mesh.device_mesh, rep)
        res["batch"].append(pinned(x, PC.constrain_batch(x, bdim, mdim)))
    res["expert"] = []
    for shape, edim in EXPERT_CASES:
        x = distribute_tensor(torch.randn(shape, generator=gen),
                              mesh.device_mesh, rep)
        res["expert"].append(pinned(x, PC.constrain_expert(x, edim)))
    plain = torch.ones(4, 6)
    res["plain_same"] = PC.constrain_batch(plain) is plain
    PC.set_mesh(None)
    Path(out_path).write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
