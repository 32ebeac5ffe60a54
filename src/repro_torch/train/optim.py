"""Optimizers: AdamW, Adafactor, Lion, written out (no ``torch.optim``).

Port of ``src/repro/train/optim.py``, the same math. Each optimizer exposes
``init/update/axes``; ``axes`` maps the parameter logical-axes tree to the
state's logical axes (kept as data for the tensor-parallel slice).

Mixed precision: parameters live in their model dtype (bf16 at full width);
AdamW and Lion keep a float32 master copy in the state, Adafactor factored
float32 second moments and, by default, a float32 master too.

Unlike the reference, which returns new trees, ``update`` works **in
place**: it writes the new moments and master into the state's tensors and
the new values into the parameter tensors, and returns those same trees.
:func:`clip_by_global_norm` scales the gradient tensors in place too. Trees
are nested dicts; leaves are visited in sorted-key order. Each leaf of
three or more dims is updated, normed and clipped a slice of whole
matrices at a time (:func:`_slices`), so that a float32 temporary holds one
slice, not the leaf: the elementwise arithmetic is the reference's bit for
bit; sums over a leaf (the global norm, Adafactor's update RMS) add the
slices' float32 sums, which differs from one sum by float32 rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.sharding.params import Axes, tree_leaves, tree_map

F32 = torch.float32


# elements of a slice of a leaf (a float32 temporary of 256 MB) where its
# matrices are small enough to be grouped
_SLICE_ELEMS = 1 << 26


def _split(t: torch.Tensor, keep: int, per: int,
           grouped: bool) -> list[torch.Tensor]:
    """Views of ``t`` down to its trailing ``keep`` dims, in order: ``per``
    of them to a view where ``grouped`` (``t`` contiguous), else one."""
    if grouped:
        return list(t.view(-1, *t.shape[t.dim() - keep:]).split(per))
    if t.dim() == keep:
        return [t]
    return [v for s in t.unbind(0) for v in _split(s, keep, per, False)]


def _slices(leaves: list, keeps: list | None = None) -> list[tuple]:
    """Views that cut tensors stacked alike (a leaf and its optimizer
    state, or its factored moments with ``keeps`` 1) the same way, zipped:
    ``[tuple(leaves)]`` when the first has fewer than three dims, else
    slices of its trailing 2-d matrices, consecutive ones grouped while a
    slice holds at most ``_SLICE_ELEMS`` elements (one a slice past that,
    or where a tensor is not contiguous). An update runs on one slice at a
    time, which bounds its float32 temporaries: a stacked (1, 8, 6144,
    32768) expert leaf goes one (6144, 32768) matrix at a time."""
    t = leaves[0]
    if t.dim() < 3:
        return [tuple(leaves)]
    r, c = t.shape[-2:]
    per = max(1, _SLICE_ELEMS // max(1, r * c))
    grouped = all(x.is_contiguous() for x in leaves)
    return list(zip(*(_split(x, k, per, grouped)
                      for x, k in zip(leaves, keeps or [2] * len(leaves)))))


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's float32 scalars are."""
    return float(np.float32(x))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-dim tensor
    on the leaves' device)."""
    total = None
    for leaf in tree_leaves(tree):
        sq = sum(torch.sum(torch.square(r.to(F32)))
                 for r, in _slices([leaf]))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` **in place** so that their global norm is at most
    ``max_norm``; the scaled values are rounded back to each gradient's
    dtype, as the reference does. Returns ``(grads, norm before)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        for r, in _slices([g]):
            r.copy_(r.to(F32) * scale)
    return grads, norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``update(grads, state, params, lr) -> (params, state, metrics)``,
    writing ``params`` and ``state`` in place and returning them."""

    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, float], tuple[Any, Any, dict]]
    axes: Callable[[Any], Any]   # param axes tree -> state axes tree


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def _master(p):
    return p.detach().to(F32, copy=True)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"step": 0, "master": tree_map(_master, params),
                "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        if clip:
            grads, gnorm = clip_by_global_norm(grads, clip)
        else:
            gnorm = global_norm(grads)
        state["step"] += 1
        t = np.float32(state["step"])
        c1 = _f32(np.float32(1.0) - np.float32(b1) ** t)
        c2 = _f32(np.float32(1.0) - np.float32(b2) ** t)
        lr = _f32(lr)
        for g, m, v, master, p in zip(
                *(tree_leaves(x) for x in (grads, state["m"], state["v"],
                                           state["master"], params))):
            for gr, mr, vr, wr, pr in _slices([g, m, v, master, p]):
                gr = gr.to(F32)
                mr.mul_(b1).add_(gr, alpha=1 - b1)
                vr.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                u = (mr / c1) / (torch.sqrt(vr / c2) + eps)
                wr.sub_(lr * (u + weight_decay * wr))
                pr.copy_(wr)
        return params, state, {"grad_norm": gnorm}

    def axes(param_axes):
        return {"step": Axes(), "master": param_axes, "m": param_axes,
                "v": param_axes}

    return Optimizer("adamw", init, update, axes)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; memory ~O(rows+cols) for matrices)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adafactor(eps: float = 1e-30, clip_thresh: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              master: bool = True) -> Optimizer:
    def init(params):
        def vr(p):
            return (torch.zeros(p.shape[:-1], dtype=F32, device=p.device)
                    if _factored(p.shape) else _zeros_f32(p))

        def vc(p):
            shape = ((*p.shape[:-2], p.shape[-1]) if _factored(p.shape)
                     else (1,))
            return torch.zeros(shape, dtype=F32, device=p.device)

        st = {"step": 0, "vr": tree_map(vr, params), "vc": tree_map(vc, params)}
        if master:
            st["master"] = tree_map(_master, params)
        return st

    def direction(g, vr, vc, factored: bool):
        """The unclipped update u of one slice from its updated moments."""
        if factored:
            rfac = torch.rsqrt(vr / torch.clamp(vr.mean(-1, keepdim=True),
                                                min=eps))
            cfac = torch.rsqrt(vc)
            return g * rfac[..., None] * cfac[..., None, :]
        return g * torch.rsqrt(vr)

    @torch.no_grad()
    def update(grads, state, params, lr):
        state["step"] += 1
        beta = _f32(np.float32(1.0) - (np.float32(state["step"]) + np.float32(1.0))
                    ** np.float32(-decay))
        lr = _f32(lr)
        masters = (tree_leaves(state["master"]) if "master" in state
                   else [None] * len(tree_leaves(params)))
        for g, vr, vc, p, mstr in zip(tree_leaves(grads),
                                      tree_leaves(state["vr"]),
                                      tree_leaves(state["vc"]),
                                      tree_leaves(params), masters):
            # one slice at a time (:func:`_slices`); the factored moments
            # are per matrix, the update-clipping RMS per leaf, so a first
            # pass updates the moments and sums u * u over the slices in
            # float32, a second recomputes u and applies it
            factored = _factored(g.shape)
            leaves = [g, vr, vc, p] + ([] if mstr is None else [mstr])
            slices = (_slices(leaves, [2, 1, 1, 2, 2]) if factored
                      else [tuple(leaves)])
            if mstr is None:
                slices = [s + (None,) for s in slices]
            sq = None
            for gs, vrs, vcs, _, _ in slices:
                gs = gs.to(F32)
                g2 = gs * gs + eps
                if factored:
                    vrs.mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
                    vcs.mul_(beta).add_(g2.mean(-2), alpha=1 - beta)
                else:
                    vrs.mul_(beta).add_(g2, alpha=1 - beta)
                del g2
                u = direction(gs, vrs, vcs, factored)
                part = torch.sum(u * u)
                sq = part if sq is None else sq + part
            # update clipping (RMS <= clip_thresh)
            rms = torch.sqrt(sq / g.numel() + 1e-30)
            denom = torch.clamp(rms / clip_thresh, min=1.0)
            for gs, vrs, vcs, ps, ms in slices:
                u = direction(gs.to(F32), vrs, vcs, factored) / denom
                base = ms if ms is not None else ps.to(F32)
                new = base - lr * (u + weight_decay * base)
                if ms is not None:
                    ms.copy_(new)
                ps.copy_(new)
        return params, state, {"grad_norm": global_norm(grads)}

    def axes(param_axes):
        def vr_ax(a):
            dims = tuple(a)
            return Axes(*dims[:-1]) if len(dims) >= 2 else Axes(*dims)

        def vc_ax(a):
            dims = tuple(a)
            return Axes(*dims[:-2], dims[-1]) if len(dims) >= 2 else Axes(None)

        st = {"step": Axes(), "vr": tree_map(vr_ax, param_axes),
              "vc": tree_map(vc_ax, param_axes)}
        if master:
            st["master"] = param_axes
        return st

    return Optimizer("adafactor", init, update, axes)


# ---------------------------------------------------------------------------
# Lion
# ---------------------------------------------------------------------------


def lion(b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.1,
         clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"step": 0, "master": tree_map(_master, params),
                "m": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        if clip:
            grads, _ = clip_by_global_norm(grads, clip)
        lr = _f32(lr)
        for g, m, master, p in zip(
                *(tree_leaves(x) for x in (grads, state["m"],
                                           state["master"], params))):
            for gr, mr, wr, pr in _slices([g, m, master, p]):
                gr = gr.to(F32)
                u = torch.sign(b1 * mr + (1 - b1) * gr)
                mr.mul_(b2).add_(gr, alpha=1 - b2)
                wr.sub_(lr * (u + weight_decay * wr))
                pr.copy_(wr)
        state["step"] += 1
        return params, state, {}

    def axes(param_axes):
        return {"step": Axes(), "master": param_axes, "m": param_axes}

    return Optimizer("lion", init, update, axes)


def get(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "lion": lion}[name](**kw)
