"""AdamW and Adafactor. Counterpart of ``repro.train.optimizer``.

The math is the reference's, in f32, and parameters keep their dtype.
The reference's state tree mirrors its parameter tree, whose dense and
RWKV6 segments are stacked along a leading layer axis; the port keeps one
tensor per layer for the parameters but holds the optimizer state in the
reference's stacked layout (``[L, ...]`` f32 tensors under the same
nested keys), so that checkpoints and digests of the two packages are
interchangeable. Two rules of the reference act on the stacked shape,
and the port keeps both:

- weight decay applies where the stacked leaf has two or more dims, so
  every segment leaf is decayed (a layer's norm scale is ``[L, D]``),
  while ``ln_f`` (``[D]``) is not;
- Adafactor factors a leaf by its last two stacked dims and clips its
  update by the RMS over the whole stacked leaf, across all L layers: a
  leaf of per-layer matrices takes two passes over its layers (the sum of
  squares, then the update), and a leaf of per-layer vectors is stacked
  and updated as one tensor.

:func:`apply_opt` updates the parameters and the state in place under
``torch.no_grad``, one layer at a time (the counterpart of the
reference's buffer donation): beyond one layer's temporaries it makes no
copy of a leaf's parameters or state. AdamW, which is elementwise, takes
a tensor in slices of its first dim of at most ``ADAMW_CHUNK`` elements,
so its temporaries are a slice's (the same bytes as a whole-tensor
update); on the CPU at most ``ADAMW_CHUNK_HOST``, so that they stay in
the host's caches. The reference's ``init_opt`` also returns the
state's logical sharding axes; here :func:`opt_axes` gives them, in the
state's stacked layout, so ``launch.sharding.tree_shardings`` lays the
state out as it lays out the parameters (ZeRO-style).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.common import reference_leaves


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # adafactor
    decay_rate: float = 0.8
    clip_threshold: float = 1.0
    min_dim_factored: int = 128


# AdamW's slice of a tensor (16 MB in f32): its temporaries stay small
# where a tensor is large (llama4's f32 embedding table is 4.1 GB), and on
# the host they come from the allocator's heap instead of fresh pages
# (a 4.1 GB table's update: 12.7-14.0 s in slices of 2**22 against
# 19.3-21.1 s whole or in slices of 2**25 on the H100 machine's host).
# On the CPU a slice is at most ADAMW_CHUNK_HOST (1 MB in f32), so that
# the ~15 elementwise passes over it run in the host's caches and not
# from memory; on the card ADAMW_CHUNK keeps the launches few.
ADAMW_CHUNK = 1 << 22
ADAMW_CHUNK_HOST = 1 << 18


def choose_optimizer(n_params: int) -> str:
    """Archs of about 30B parameters or more take adafactor (memory),
    smaller ones adamw."""
    return "adafactor" if n_params >= 30e9 else "adamw"


def _stacked_shape(tensors: list, stacked: bool) -> tuple:
    shape = tuple(tensors[0].shape)
    return (len(tensors), *shape) if stacked else shape


def _factored(cfg: OptConfig, shape: tuple) -> bool:
    return len(shape) >= 2 and min(shape[-2:]) >= cfg.min_dim_factored


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def init_opt(cfg: OptConfig, params) -> dict:
    """The optimizer state of ``params`` (an ``LM``): a nested dict with
    the reference's keys, f32 zeros on the parameters' device in the
    stacked shapes. AdamW: ``{"m", "v"}`` per leaf; Adafactor: ``{"vr",
    "vc"}`` where the stacked leaf's last two dims are both at least
    ``min_dim_factored``, else ``{"v"}``."""
    state: dict = {}
    for path, tensors, stacked in reference_leaves(params):
        shape = _stacked_shape(tensors, stacked)

        def zeros(s, dev=tensors[0].device):
            return torch.zeros(s, dtype=torch.float32, device=dev)
        if cfg.kind == "adamw":
            leaf = {"m": zeros(shape), "v": zeros(shape)}
        elif _factored(cfg, shape):
            leaf = {"vr": zeros(shape[:-1]),
                    "vc": zeros(shape[:-2] + shape[-1:])}
        else:
            leaf = {"v": zeros(shape)}
        _set(state, path, leaf)
    return state


def opt_axes(cfg: OptConfig, params, axes) -> dict:
    """The logical axes of :func:`init_opt`'s state, in its layout: each
    state leaf takes its parameter leaf's axes in the reference's stacked
    form (a leading "layers" where the leaf is stacked). AdamW's ``m``
    and ``v`` take them whole; Adafactor's factored ``vr`` drops the last
    and ``vc`` the second-to-last, as the reference's ``init_opt`` does.
    ``params`` is an ``LM`` (the meta device will do: only shapes are
    read), ``axes`` its axes tree (``models.transformer.param_axes``)."""
    out: dict = {}
    for (path, tensors, stacked), (apath, a, _) in zip(
            reference_leaves(params), reference_leaves(axes), strict=True):
        if path != apath:
            raise ValueError(f"axes tree at {apath} for the leaf {path}")
        shape = _stacked_shape(tensors, stacked)
        ax = ("layers", *a[0]) if stacked else a[0]
        if cfg.kind == "adamw":
            leaf = {"m": ax, "v": ax}
        elif _factored(cfg, shape):
            leaf = {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
        else:
            leaf = {"v": ax}
        _set(out, path, leaf)
    return out


# -- the update of one tensor (a whole leaf, or one layer of a leaf) ---------
# Each writes its results into the tensors it is given (``p`` and the
# state's tensors ``s``), so a stacked leaf is updated one layer at a
# time and no new copy of its parameters or state is made.

def _adamw(cfg: OptConfig, p, g32, s: dict, stepf, decay: bool) -> None:
    chunk = ADAMW_CHUNK if p.is_cuda else ADAMW_CHUNK_HOST
    rows = max(1, chunk // max(1, p[0].numel())) if p.dim() else 0
    if p.dim() and p.shape[0] > rows:
        for i in range(0, p.shape[0], rows):
            sl = slice(i, i + rows)
            _adamw(cfg, p[sl], g32[sl], {k: t[sl] for k, t in s.items()},
                   stepf, decay)
        return
    m = cfg.b1 * s["m"] + (1 - cfg.b1) * g32
    v = cfg.b2 * s["v"] + (1 - cfg.b2) * torch.square(g32)
    s["m"].copy_(m)
    s["v"].copy_(v)
    mh = m / (1 - cfg.b1 ** stepf)
    vh = v / (1 - cfg.b2 ** stepf)
    upd = mh / (torch.sqrt(vh) + cfg.eps)
    if decay:
        upd = upd + cfg.weight_decay * p.float()
    p.copy_((p.float() - cfg.lr * upd).to(p.dtype))


def _adafactor_moments(g32, s: dict, beta) -> None:
    """Adafactor's new second moments of ``g32``, written into ``s``."""
    g2 = torch.square(g32) + 1e-30
    if "vr" in s:
        s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
        s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
    else:
        s["v"].copy_(beta * s["v"] + (1 - beta) * g2)


def _adafactor_dir(g32, s: dict):
    """Adafactor's update before its clip, from the new moments ``s``."""
    if "vr" in s:
        vr, vc = s["vr"], s["vc"]
        denom = (vr[..., None] / vr.mean(dim=-1, keepdim=True)[..., None]) \
            * vc[..., None, :]
        return g32 * torch.rsqrt(denom + 1e-30)
    return g32 * torch.rsqrt(s["v"] + 1e-30)


def _adafactor_apply(cfg: OptConfig, p, upd, rms, decay: bool) -> None:
    upd = upd / torch.clamp(rms / cfg.clip_threshold, min=1.0)
    if decay:
        upd = upd + cfg.weight_decay * p.float()
    p.copy_((p.float() - cfg.lr * upd).to(p.dtype))


def _rms(sumsq, numel: int):
    return torch.sqrt(sumsq / numel + 1e-30)


def _update_leaf(cfg: OptConfig, ps: list, gs: list, s: dict, stepf,
                 stacked: bool) -> None:
    """One reference leaf, in place: ``ps`` its tensors (one a layer when
    ``stacked``), ``gs`` their gradients, ``s`` its state (in the stacked
    layout)."""
    decay = stacked or ps[0].dim() >= 2
    if stacked and ps[0].dim() == 1:
        # per-layer vectors: the reference's [L, d] leaf, as one tensor
        p = torch.stack(ps)
        _update_leaf(cfg, [p], [torch.stack(gs)], s, stepf, False)
        for dst, src in zip(ps, p.unbind(0)):
            dst.copy_(src)
        return
    beta = 1.0 - stepf ** (-cfg.decay_rate)
    if not stacked:
        p, g32 = ps[0], gs[0].float()
        if cfg.kind == "adamw":
            _adamw(cfg, p, g32, s, stepf, decay=decay)
        else:
            _adafactor_moments(g32, s, beta)
            upd = _adafactor_dir(g32, s)
            rms = _rms(torch.square(upd).sum(), upd.numel())
            _adafactor_apply(cfg, p, upd, rms, decay)
        return
    layer_state = [{k: t[i] for k, t in s.items()} for i in range(len(ps))]
    if cfg.kind == "adamw":
        for p, g, si in zip(ps, gs, layer_state):
            _adamw(cfg, p, g.float(), si, stepf, decay=True)
        return
    # the clip's RMS runs over all layers: each layer's moments and the sum
    # of squares of its update first, then each layer's update again from
    # the same new moments (the same bytes)
    sumsq = torch.zeros((), device=ps[0].device)
    for g, si in zip(gs, layer_state):
        g32 = g.float()
        _adafactor_moments(g32, si, beta)
        sumsq = sumsq + torch.square(_adafactor_dir(g32, si)).sum()
    rms = _rms(sumsq, len(ps) * ps[0].numel())
    for p, g, si in zip(ps, gs, layer_state):
        g32 = g.float()
        _adafactor_apply(cfg, p, _adafactor_dir(g32, si), rms, True)


@torch.no_grad()
def apply_opt(cfg: OptConfig, params, grads: list, state: dict,
              step: torch.Tensor):
    """One optimizer step, in place: writes the new values into
    ``params``' tensors and ``state``'s and returns ``(params, state)``.
    ``grads`` holds one list of gradients per leaf of
    ``reference_leaves(params)``, in that order (any float dtype; the
    math is f32); ``step`` is the int32 count of steps taken."""
    stepf = step.float() + 1.0
    leaves = reference_leaves(params)
    if len(grads) != len(leaves):
        raise ValueError(f"{len(grads)} gradient leaves for {len(leaves)} "
                         f"parameter leaves")
    for (path, ps, stacked), gs in zip(leaves, grads):
        _update_leaf(cfg, ps, gs, _get(state, path), stepf, stacked)
    return params, state
