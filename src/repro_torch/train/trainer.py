"""Train step: microbatched gradient accumulation and the optimizer.
Counterpart of ``repro.train.trainer``.

``make_train_step(cfg, opt_cfg, ...)`` returns ``train_step(state,
batch) -> (state, metrics)``. The reference returns a pure function for
``jax.jit`` with the state donated; the port updates the state in place
(parameters, optimizer state and step) and returns the same dict. The
reference's ``lax.scan`` over microbatches is a loop: each microbatch's
loss goes through ``loss.backward()`` (every block recomputed under
activation checkpointing), and its gradients are added into accumulators
of ``grad_dtype`` (f32), then divided by the number of microbatches.
Each microbatch is its own MoE dispatch, whose capacity follows the
microbatch's tokens, as in the reference's scan.

On the CUDA card a step runs with ``torch.use_deterministic_algorithms
(True)`` and restores the previous setting after: two pods of the
replicated trainer must end bitwise equal (``runtime.statemachine``), so
every op whose CUDA kernel has a nondeterministic default (the backward
of the embedding gather and of the loss's gather, which accumulate rows
that repeat) takes its deterministic one, and an op that has none raises
instead of running. The flash and WKV6 backward kernels are
deterministic by design, and cuBLAS is on one stream. The MoE's dispatch
and combine (``models.layers.moe_apply``) use only ops with a
deterministic CUDA implementation: a stable sort, ``searchsorted``,
advanced-index gathers and ``index_put`` (whose backward accumulates
deterministically in this mode), ``topk``. cuBLAS's deterministic mode needs
``CUBLAS_WORKSPACE_CONFIG`` set before the process's first matrix product
(PyTorch reads it once): entry points set it to ``:4096:8`` before they
touch the card (:func:`set_cublas_workspace`), and a step on the card
raises where it is not set.
"""
from __future__ import annotations

import contextlib
import os

import torch

from ..device import resolve_device
from ..models import transformer as T
from ..models.common import ModelConfig, reference_leaves
from .optimizer import OptConfig, apply_opt, init_opt

CUBLAS_WORKSPACE = ":4096:8"
# the settings under which cuBLAS is deterministic
CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


def make_state(cfg: ModelConfig, opt_cfg: OptConfig,
               generator: torch.Generator | None = None,
               device=None) -> dict:
    """``{"params", "opt", "step"}``: the model drawn from ``generator``
    (a ``torch.Generator`` on ``device``, seed 0 if None), its optimizer
    state and an int32 step of 0. ``device`` defaults to the CUDA card
    and raises without one. The reference also returns the logical
    sharding axes, which have no counterpart without a mesh."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    params = T.init_lm(cfg, generator, dev)
    return {"params": params, "opt": init_opt(opt_cfg, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _split_microbatch(x: torch.Tensor, m: int, global_batch: int):
    """Split the first axis of size ``global_batch`` into [m, gb/m, ...]
    (the microbatch axis first, the rest in their order); a tensor with no
    such axis is repeated over the m microbatches. The reference's rule:
    M-RoPE positions [3, B, S] split on axis 1 (where B != 3), embeddings
    [B, S, D] and the encoder-decoder's frames [B, T, D] on axis 0."""
    for ax in range(x.dim()):
        if x.shape[ax] == global_batch:
            moved = torch.movedim(x, ax, 0)
            out = moved.reshape(m, global_batch // m, *moved.shape[1:])
            return torch.movedim(out, 1, ax + 1)
    return x.expand(m, *x.shape)


def set_cublas_workspace() -> None:
    """``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless it is set: the setting
    PyTorch's deterministic mode asks for. Call it before the process's
    first matrix product on the card."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms on a CUDA device for the duration: an op
    with no deterministic CUDA implementation raises. Raises on entry
    where ``CUBLAS_WORKSPACE_CONFIG`` is not a deterministic setting
    (:func:`set_cublas_workspace` comes before the first matrix
    product)."""
    if device.type != "cuda":
        yield
        return
    got = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if got not in CUBLAS_DETERMINISTIC:
        raise RuntimeError(
            f"CUBLAS_WORKSPACE_CONFIG is {got!r}, not one of "
            f"{CUBLAS_DETERMINISTIC}: call set_cublas_workspace() before "
            "the process's first matrix product on the card")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (f32)."""
    total = None
    for leaf in grads:
        sq = sum(torch.square(g.float()).sum() for g in leaf)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient; zeros for a parameter the loss does not use
    (RWKV6's ``ln_x``), as the reference's gradient tree has."""
    return torch.zeros_like(p) if p.grad is None else p.grad


def make_grad_fn(cfg: ModelConfig, *, microbatches: int = 1,
                 global_batch: int, grad_dtype=torch.float32):
    """``grads_of(params, batch) -> (grads, loss)``: the gradients of the
    mean loss over the microbatches in ``grad_dtype``, one list per leaf of
    ``reference_leaves(params)`` (the reference's leaves, one tensor a
    layer), and that loss. The parameters' ``.grad`` are left empty."""
    grads_metrics = _grads_and_metrics_fn(cfg, microbatches, global_batch,
                                          grad_dtype)

    def grads_of(params, batch):
        grads, loss, _ = grads_metrics(params, batch)
        return grads, loss

    return grads_of


def _grads_and_metrics_fn(cfg: ModelConfig, microbatches: int,
                          global_batch: int, grad_dtype):
    """:func:`make_grad_fn`'s function, returning also the mean over the
    microbatches of the MoE auxiliary loss (``"aux"``) and, with
    ``cfg.mtp``, of the MTP term (``"mtp"``), as a dict."""
    keys = ("aux", "mtp") if cfg.mtp else ("aux",)
    if global_batch % microbatches:
        raise ValueError(f"global batch {global_batch} is not a multiple "
                         f"of {microbatches} microbatches")

    def grads_of(params, batch):
        leaves = reference_leaves(params)
        flat = [p for _, ps, _ in leaves for p in ps]
        for p in flat:
            p.grad = None
        if microbatches == 1:
            loss, metrics = T.lm_loss(params, cfg, batch)
            loss.backward()
            acc = [_grad(p).to(grad_dtype) for p in flat]
            for p in flat:
                p.grad = None
            loss = loss.detach()
            means = {k: metrics[k].detach() for k in keys}
        else:
            mbs = {k: _split_microbatch(v, microbatches, global_batch)
                   for k, v in batch.items()}
            acc = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                   for p in flat]
            losses, seen = [], {k: [] for k in keys}
            for i in range(microbatches):
                loss, metrics = T.lm_loss(params, cfg,
                                          {k: v[i] for k, v in mbs.items()})
                loss.backward()
                with torch.no_grad():
                    for a, p in zip(acc, flat):
                        a.add_(_grad(p))
                        p.grad = None
                losses.append(loss.detach())
                for k in keys:
                    seen[k].append(metrics[k].detach())
            with torch.no_grad():
                for a in acc:
                    a.div_(microbatches)
            loss = torch.stack(losses).mean()
            means = {k: torch.stack(v).mean() for k, v in seen.items()}
        grads, i = [], 0
        for _, ps, _ in leaves:
            grads.append(acc[i:i + len(ps)])
            i += len(ps)
        return grads, loss, means

    return grads_of


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    microbatches: int = 1, global_batch: int,
                    grad_dtype=torch.float32):
    """The train step of ``cfg`` with ``opt_cfg``: ``train_step(state,
    batch) -> (state, {"loss", "grad_norm", "aux"})``, f32 scalars on the
    state's device (``aux``, the MoE auxiliary loss averaged over the
    microbatches, is 0 without MoE; with ``cfg.mtp`` also ``"mtp"``, the
    MTP term averaged the same way; the reference's step reports loss and
    grad_norm only); ``batch["tokens"]`` is [global_batch, S], or for the
    vision-language family ``batch`` holds ``embeds`` [global_batch, S,
    D], ``positions`` [3, global_batch, S] and ``labels``; the
    encoder-decoder's also holds ``frames`` [global_batch, T, D]."""
    grads_of = _grads_and_metrics_fn(cfg, microbatches, global_batch,
                                     grad_dtype)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        with deterministic(state["step"].device):
            grads, loss, means = grads_of(params, batch)
            apply_opt(opt_cfg, params, grads, state["opt"], state["step"])
            with torch.no_grad():
                state["step"] += 1
                metrics = {"loss": loss.float(),
                           "grad_norm": _global_norm(grads),
                           **{k: v.float() for k, v in means.items()}}
        return state, metrics

    return train_step
