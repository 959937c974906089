"""Sharded checkpointing with HT-Paxos-style quorum commit. Counterpart
of ``repro.runtime.checkpoint``, with the same directory layout, the same
leaf order and the same bytes: a checkpoint written by either package
restores in the other.

Layout: ``<dir>/step_<n>/shard_<k>_rep<r>.npz`` + ``manifest_<n>.json``.
A checkpoint is COMMITTED only when a majority of shard replicas acked
their write — mirroring the dissemination-layer stability rule (§4.1: an
id enters ``stable_ids`` only when a majority of disseminators hold the
payload, guaranteeing f+1 durable copies). Restore scans for the newest
*committed* manifest and ignores torn/uncommitted saves, which is exactly
the crash-restart story of the paper's stable-storage model (§3).

The leaves are the reference's (``models.common.reference_leaves``:
keys sorted, segment leaves stacked along the layer axis), numbered in
that order and range-partitioned round-robin across ``n_shards``; each is
stored in its native dtype, bf16 as numpy void ``|V2`` (what ``np.savez``
writes for a JAX bf16 array). Restore writes into the template state's
tensors in place.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..convert import tensor_from_numpy, tensor_to_numpy
from ..models.common import reference_leaves
from .statemachine import tree_digest


def _leaf_array(tensors: list, stacked: bool) -> np.ndarray:
    """One reference leaf as a numpy array on the host, bf16 as |V2."""
    arrays = [tensor_to_numpy(t, native=True) for t in tensors]
    return np.stack(arrays) if stacked else arrays[0]


def save_sharded(state, directory: str, step: int, n_shards: int = 4,
                 fail_shards: set | None = None) -> dict:
    """Write shards with replication factor 2: shard k is written by node
    k (replica 0) and node (k+1) mod n (replica 1) — the dissemination-
    layer rule that a payload must exist at multiple nodes before its id
    can stabilize. ``fail_shards`` = failed NODES (fault injection): a
    dead node writes neither its primary shard nor its backup copy.

    Commit requires (a) a majority of node acks AND (b) every shard
    surviving on ≥1 replica — committed ⇒ restorable."""
    fail_shards = fail_shards or set()
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    groups = reference_leaves(state)
    shard_replicas: dict[int, list[int]] = {k: [] for k in range(n_shards)}
    node_acks = []
    for node in range(n_shards):
        if node in fail_shards:
            continue
        node_acks.append(node)
        for rep, k in ((0, node), (1, (node - 1) % n_shards)):
            part = {str(i): _leaf_array(ts, stacked)
                    for i, (_, ts, stacked) in enumerate(groups)
                    if i % n_shards == k}
            np.savez(os.path.join(d, f"shard_{k}_rep{rep}.npz"), **part)
            shard_replicas[k].append(rep)
    majority = n_shards // 2 + 1
    committed = (len(node_acks) >= majority
                 and all(len(v) >= 1 for v in shard_replicas.values()))
    manifest = {
        "step": step,
        "n_shards": n_shards,
        "n_leaves": len(groups),
        "acked_nodes": node_acks,
        "shard_replicas": {str(k): v for k, v in shard_replicas.items()},
        "committed": committed,
        "digest": tree_digest(state["params"]) if "params" in state
        else tree_digest(state),
        "time": time.time(),
    }
    # the commit record itself is the paper's "decided" marker: written
    # only after the ack quorum is in
    if manifest["committed"]:
        with open(os.path.join(directory, f"manifest_{step:08d}.json"),
                  "w") as f:
            json.dump(manifest, f)
    return manifest


def latest_committed_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("manifest_") and name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                m = json.load(f)
            if m.get("committed"):
                steps.append(m["step"])
    return max(steps) if steps else None


@torch.no_grad()
def restore_sharded(template_state, directory: str,
                    step: Optional[int] = None):
    """Fill ``template_state`` (in place) from the newest committed
    checkpoint, reading any surviving replica per shard (commit
    guarantees ≥1 exists). Returns ``(template_state, manifest)``."""
    if step is None:
        step = latest_committed_step(directory)
        if step is None:
            raise FileNotFoundError("no committed checkpoint")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(directory, f"manifest_{step:08d}.json")) as f:
        manifest = json.load(f)
    groups = reference_leaves(template_state)
    found: dict[int, np.ndarray] = {}
    for k_str, reps in manifest["shard_replicas"].items():
        for rep in reps:
            path = os.path.join(d, f"shard_{k_str}_rep{rep}.npz")
            if not os.path.exists(path):
                continue
            with np.load(path) as z:
                for key in z.files:
                    found[int(key)] = z[key]
            break   # one surviving replica per shard is enough
    if len(found) != len(groups):
        raise IOError(f"checkpoint step {step} incomplete: "
                      f"{len(found)}/{len(groups)} leaves")
    for i, (path, tensors, stacked) in enumerate(groups):
        raw = found[i]
        parts = list(raw) if stacked else [raw]
        if len(parts) != len(tensors):
            raise IOError(f"leaf {'.'.join(path)}: {len(parts)} layers "
                          f"stored, {len(tensors)} in the template")
        for t, part in zip(tensors, parts):
            t.copy_(tensor_from_numpy(part, t.dtype, t.device).reshape(
                t.shape))
    return template_state, manifest
