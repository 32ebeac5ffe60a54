"""Parameter declaration: one source of truth for shape, logical axes, init.

Port of ``src/repro/sharding/params.py``. A model is declared as a nested
dict of :class:`ParamDecl`; :func:`init_tree` materialises it as torch
tensors drawn from a ``torch.Generator`` on the target device, so the
full-width weights can be made directly on the card. Trees are plain
dicts (the JAX package's pytrees); leaves are visited in sorted-key order,
as ``jax.tree`` flattens a dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


class Axes:
    """Logical axis names of one array (not a tree container, so an axes
    tree has the same structure as its parameter tree)."""

    __slots__ = ("dims",)

    def __init__(self, *dims: str | None):
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = tuple(dims[0])
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        return isinstance(other, Axes) and self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"Axes{self.dims}"

    def prepend(self, name: str | None) -> "Axes":
        return Axes(name, *self.dims)


def is_axes(x) -> bool:
    return isinstance(x, Axes)


# float32 elements drawn at a time (256 MB): the bound on init's transient
DRAW_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declaration of a single parameter tensor."""

    shape: tuple[int, ...]
    axes: Axes
    init: str = "normal"       # normal | zeros | ones | fan_in
    scale: float | None = None  # explicit std for "normal"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"decl rank mismatch: {self.shape} vs {self.axes}")

    def materialize(self, generator: torch.Generator, device: torch.device,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
        """Draw this tensor on ``device`` (the generator must live there) in
        ``dtype`` (default the decl's).

        The normal draws are made in float32 and scaled in place, a slice
        of at most :data:`DRAW_CHUNK` elements of the flattened leaf at a
        time, each cast into the leaf as it is drawn: the float32 transient
        is bounded whatever the leaf's size (grok-1's stacked expert leaf
        ``(4, 8, 6144, 32768)`` is 25.8 GB in float32, 12.9 GB in bf16).
        """
        dtype = dtype or self.dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "normal":
            std = self.scale if self.scale is not None else 0.02
        elif self.init == "fan_in":
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        else:
            raise ValueError(f"unknown init {self.init}")
        out = torch.empty(self.shape, dtype=dtype, device=device)
        flat = out.view(-1)
        for start in range(0, flat.numel(), DRAW_CHUNK):
            n = min(DRAW_CHUNK, flat.numel() - start)
            x = torch.randn((n,), generator=generator, dtype=torch.float32,
                            device=device)
            flat[start:start + n].copy_(x.mul_(std))
        return out

    def stacked(self, n: int, axis_name: str | None = None) -> "ParamDecl":
        return dataclasses.replace(
            self, shape=(n, *self.shape), axes=self.axes.prepend(axis_name))


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (dicts are the nodes),
    visiting leaves in sorted-key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_map2(fn: Callable[[Any, Any], Any], a: Any, b: Any) -> Any:
    """``fn`` over the paired leaves of two nested dicts of the same
    structure, in sorted-key order."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise ValueError("the two trees differ in structure")
        return {k: tree_map2(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


def tree_leaves(tree: Any) -> list:
    """Leaves in sorted-key order (the order ``jax.tree.leaves`` uses)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def stack_tree(tree: Any, n: int, axis_name: str | None = None) -> Any:
    """Stack every decl in a layer tree n times (stacked per-layer weights)."""
    return tree_map(lambda d: d.stacked(n, axis_name), tree)


def axes_tree(tree: Any) -> Any:
    """The tree of :class:`Axes` of a decl tree (the sharding rules'
    input)."""
    return tree_map(lambda d: d.axes, tree)


def init_tree(tree: Any, seed: int | torch.Generator,
              device: torch.device, dtype: torch.dtype | None = None) -> Any:
    """Materialise a decl tree on ``device``, every leaf in ``dtype``
    (default each decl's own), drawn straight in it
    (:meth:`ParamDecl.materialize`).

    Leaves draw in sorted-key order from one ``torch.Generator`` on
    ``device`` (``seed`` may be an int or such a generator). The numbers
    differ from the JAX package's for the same seed; tests that compare
    the two packages make weights once and bridge them
    (:mod:`repro_torch.bridge`).
    """
    device = torch.device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    return tree_map(lambda d: d.materialize(gen, device, dtype), tree)


def count_params(tree: Any) -> int:
    """Elements over every leaf (decls or tensors)."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))

