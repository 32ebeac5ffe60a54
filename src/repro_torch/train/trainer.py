"""Train step construction on one device: gradient accumulation, mixed
precision, remat (through the model config), the z-loss.

Port of the single-device part of ``src/repro/train/trainer.py``
(``TrainConfig``, ``make_loss_fn``, ``make_train_step``); the sharded
assembly waits for the tensor-parallel slice. Parameters and optimizer
state are updated **in place** (see :mod:`repro_torch.train.optim`).

The public trees keep the reference's stacked layers (a leading layer axis
on the leaves of ``blocks``, or griffin's ``triples``:
:func:`repro_torch.models.registry.stacked`). Inside a step each layer
gets its own leaf tensors (views of its slice of the stacked leaves,
detached), so that autograd produces one gradient per layer instead of
writing a stack-sized zero tensor for every index into a stacked leaf. The
per-layer gradients are gathered back into stacked trees for the
optimizer, whose math (Adafactor's factoring included) then sees the
reference's shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.params import tree_leaves, tree_map
from repro_torch.train import optim as optim_lib

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    accum: int = 1                 # gradient-accumulation microbatches
    accum_dtype: str = "float32"   # grad accumulation buffer dtype
    aux_weight: float = 0.01       # MoE load-balance loss weight
    z_loss: float = 1e-4
    clip: float = 1.0


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    """``loss_fn(params, batch) -> (loss, {"ce", "aux"})`` for one
    microbatch: ``batch["labels"]`` (B, S) and ``batch["tokens"]`` (B, S)
    or, for a stubbed front end, ``batch["embeds"]`` (B, S, d_model)
    (``src/repro/train/trainer.py:37-45``)."""
    def loss_fn(params, batch):
        logits, aux = registry.forward(params, cfg,
                                       tokens=batch.get("tokens"),
                                       embeds=batch.get("embeds"))
        ce = L.cross_entropy(logits, batch["labels"].to(logits.device),
                             z_loss=tc.z_loss).mean()
        return ce + tc.aux_weight * aux, {"ce": ce, "aux": aux}

    return loss_fn


def _layer_leaves(params, key: str, n_super: int):
    """``(tree, leaves)``: ``tree`` is ``params`` with ``params[key]`` (the
    stacked layers) as a list of per-layer trees whose leaves, like the
    other leaves, are detached views that require grad; ``leaves`` lists
    them in the order :func:`_grads_by_leaf` reads them back."""
    top = {k: tree_map(lambda t: t.detach().requires_grad_(), v)
           for k, v in params.items() if k != key}
    layers = [tree_map(lambda t, s=s: t[s].detach().requires_grad_(),
                       params[key]) for s in range(n_super)]
    leaves = [x for k in sorted(top) for x in tree_leaves(top[k])]
    leaves += [x for layer in layers for x in tree_leaves(layer)]
    return dict(top, **{key: layers}), leaves


def _grads_by_leaf(params, grads: list, key: str, n_super: int):
    """Split the flat gradient list of :func:`_layer_leaves` into
    ``(top, per_stacked_leaf)``: the other gradients in order, and for
    each stacked leaf the list of its per-layer gradients."""
    n_top = sum(len(tree_leaves(v)) for k, v in params.items() if k != key)
    top, rest = grads[:n_top], grads[n_top:]
    n_blk = len(tree_leaves(params[key]))
    per_leaf = [[rest[s * n_blk + i] for s in range(n_super)]
                for i in range(n_blk)]
    return top, per_leaf


def _rebuild(params, key: str, top: list, blocks: list):
    """A tree shaped like ``params`` from flat lists of leaves (the other
    leaves in order, then the stacked leaves of ``params[key]`` in
    order)."""
    it_top, it_blk = iter(top), iter(blocks)
    out = {}
    for k in sorted(params):
        it = it_blk if k == key else it_top
        out[k] = tree_map(lambda _: next(it), params[k])
    return out


def make_grad_fn(cfg: ModelConfig, tc: TrainConfig):
    """Returns ``grad_fn(params, batch) -> (loss, metrics, grads)``: the
    gradients a train step hands its optimizer, a tree shaped like
    ``params``, and the loss and metrics averaged over the microbatches.

    ``batch`` leaves have shape (accum, microbatch, ...) and may live on the
    CPU. With ``accum == 1`` the gradients stay in the parameters' dtype
    (bf16 at full width), as in the reference. With ``accum > 1`` each
    microbatch's gradients are taken with ``torch.autograd.grad`` and added
    into ``accum_dtype`` (float32) buffers, then divided by ``accum``.
    """
    loss_fn = make_loss_fn(cfg, tc)
    acc_dt = getattr(torch, tc.accum_dtype)
    key, n_super = registry.stacked(cfg)

    def microbatch(params, batch, i):
        tree, leaves = _layer_leaves(params, key, n_super)
        mb = {k: v[i] for k, v in batch.items()}
        loss, metrics = loss_fn(tree, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            _grads_by_leaf(params, grads, key, n_super)

    def grad_fn(params, batch):
        if tc.accum == 1:
            loss, metrics, (top, per_leaf) = microbatch(params, batch, 0)
            # one layer's gradient is its stack as a view: no copy of the
            # largest tensors a one-layer run holds
            return loss, metrics, _rebuild(params, key, top, [
                gs[0].unsqueeze(0) if len(gs) == 1 else torch.stack(gs)
                for gs in per_leaf])
        top_acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                   for k in sorted(params) if k != key
                   for p in tree_leaves(params[k])]
        blk_acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                   for p in tree_leaves(params[key])]
        losses, metricses = [], []
        for i in range(tc.accum):
            loss, metrics, (top, per_leaf) = microbatch(params, batch, i)
            for a, g in zip(top_acc, top):
                a.add_(g.to(acc_dt))
            for a, gs in zip(blk_acc, per_leaf):
                for s, g in enumerate(gs):
                    a[s].add_(g.to(acc_dt))
            del top, per_leaf
            losses.append(loss)
            metricses.append(metrics)
        for a in top_acc + blk_acc:
            a.div_(tc.accum)
        metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                   for k in metricses[0]}
        return (torch.stack(losses).mean(), metrics,
                _rebuild(params, key, top_acc, blk_acc))

    return grad_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns ``(train_step, optimizer)``; ``train_step(params, opt_state,
    batch) -> (params, opt_state, metrics)`` takes the gradients of
    :func:`make_grad_fn` and updates ``params`` and ``opt_state`` in place
    and returns them. With ``accum == 1`` the clip rounds its scaled
    gradients back to the parameters' dtype, as in the reference."""
    optimizer = optim_lib.get(tc.optimizer)
    grad_fn = make_grad_fn(cfg, tc)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_fn(params, batch)
        params, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, params, tc.lr)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step, optimizer
