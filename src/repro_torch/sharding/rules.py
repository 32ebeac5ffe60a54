"""Logical-axis -> mesh-axis rule engine (a copy of
``src/repro/sharding/rules.py``).

The engine is the software analogue of the X-HEEP bus/addressing-mode
configuration (paper §III-A3): the same model code is laid out on the machine
according to a small declarative table, and changing the table is the whole
configuration act — no model-code fork, mirroring XAIF's no-RTL-fork property.

Robustness properties (unit- and property-tested):

* divisibility fallback — a logical dim whose size does not divide the mesh
  axes assigned to it is silently replicated instead of failing to lower;
* no mesh axis is used twice within one PartitionSpec;
* unknown logical names map to replication.

The port owns its :class:`PartitionSpec` (a tuple of entries, each ``None``,
a mesh axis name or a tuple of them) and reads a mesh only through
``axis_names`` and ``devices.shape``, so the rules work on
:class:`repro_torch.launch.mesh.Mesh` and on any stand-in with those two.
The serving rules at the end drive the tensor-parallel paged decode
(:mod:`repro_torch.serve.paged`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

from repro_torch.sharding import axes as lax_
from repro_torch.sharding.params import axes_tree, tree_map, tree_map2


MeshAxes = tuple[str, ...]


class PartitionSpec(tuple):
    """How one array is laid out on a mesh: entry ``i`` names the mesh
    axis (or axes) dimension ``i`` is split over, ``None`` replicated;
    trailing dimensions not named are replicated."""

    def __new__(cls, *entries):
        return super().__new__(
            cls, tuple(tuple(e) if isinstance(e, list) else e
                       for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _as_tuple(v) -> MeshAxes:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class Rules:
    """A mapping from logical axis names to mesh axis tuples."""

    table: Mapping[str, MeshAxes]
    name: str = "custom"

    def lookup(self, logical: str | None) -> MeshAxes:
        if logical is None:
            return ()
        return _as_tuple(self.table.get(logical, ()))

    def override(self, name: str | None = None, **updates) -> "Rules":
        t = dict(self.table)
        for k, v in updates.items():
            t[k] = _as_tuple(v)
        return Rules(t, name or self.name)


def fully_connected(mesh) -> Rules:
    """The 'fully-connected bus' preset: DP/FSDP over (pod, data), TP/EP over
    model, sequence parallelism for long-context activations."""
    has_pod = "pod" in mesh.axis_names
    batch = ("pod", "data") if has_pod else ("data",)
    return Rules(
        {
            lax_.BATCH: batch,
            lax_.DECODE_BATCH: batch,
            lax_.SEQ: (),
            # decode-time context parallelism: KV cache sharded along its
            # sequence axis over `model` (GQA kv-head counts rarely divide it)
            lax_.CACHE_SEQ: ("model",),
            # FSDP: parameter/optimizer d_model dim sharded over `data`
            # (ZeRO-3): without it the ≥300B configs cannot fit 16 GiB HBM.
            # Activations are unaffected (batch claims `data` first).
            lax_.EMBED: ("data",),
            lax_.MLP: ("model",),
            lax_.HEADS: ("model",),
            lax_.KV_HEADS: ("model",),
            lax_.VOCAB: ("model",),
            lax_.EXPERT: ("model",),
            lax_.RNN_WIDTH: ("model",),
            lax_.FSDP: ("data",),
        },
        name="fully_connected",
    )


def one_at_a_time(mesh) -> Rules:
    """The paper-faithful minimal-bus baseline: a single master at a time.

    Only data parallelism over one axis; parameters replicated. Matches the
    paper's one-at-a-time topology, whose bandwidth is flat no matter how many
    ports exist (Fig. 2b) — on the pod this manifests as all-reduce-everything
    with replicated memory, the starting point the optimized layouts beat.
    """
    has_pod = "pod" in mesh.axis_names
    batch = ("pod", "data") if has_pod else ("data",)
    return Rules(
        {lax_.BATCH: batch, lax_.DECODE_BATCH: batch},
        name="one_at_a_time",
    )


PRESETS = {"fully_connected": fully_connected, "one_at_a_time": one_at_a_time}


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(
    shape: Sequence[int],
    logical: Sequence[str | None],
    rules: Rules,
    mesh,
) -> PartitionSpec:
    """Build a PartitionSpec for one array, with divisibility fallback."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} vs logical axes {logical} rank mismatch")
    sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    out: list[Any] = []
    for dim, name in zip(shape, logical):
        assigned = rules.lookup(name)
        if name in lax_.UNSHARDED:
            assigned = ()
        keep: list[str] = []
        prod = 1
        for ax in assigned:
            if ax in used or ax not in sizes:
                continue
            if dim % (prod * sizes[ax]) != 0:
                continue
            keep.append(ax)
            prod *= sizes[ax]
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def tree_specs(abstract: Any, axes_tree: Any, rules: Rules, mesh) -> Any:
    """Map a tree of shaped leaves (tensors, meta tensors or
    :class:`~repro_torch.sharding.params.ParamDecl`) and a matching tree of
    Axes leaves to a tree of PartitionSpecs."""
    return tree_map2(
        lambda a, ax: spec_for(tuple(a.shape), tuple(ax), rules, mesh),
        abstract, axes_tree)


# ---------------------------------------------------------------------------
# Serving tensor parallelism (head-axis sharding for the paged decode)
# ---------------------------------------------------------------------------


def validate_serve_tp(cfg, tp: int) -> None:
    """Loudly reject a (config, tp) pair the head-sharded paged decode
    cannot serve — the serving counterpart of :func:`spec_for`'s silent
    divisibility fallback, which would quietly replicate a KV cache the
    caller asked to shard.

    Requirements (each failure names its cause):

    * a transformer-family config with paged KV decode (MoE and the
      SSM/hybrid lane-fallback families have no head axis to shard);
    * ``n_kv_heads % tp == 0`` — the pool arenas shard over the KV-head
      axis, so every device must hold whole KV heads (this also implies
      ``n_heads % tp == 0``: query heads are ``groups × n_kv_heads``).
      MQA (``n_kv_heads == 1``) therefore cannot shard beyond tp=1.
    """
    from repro_torch.models import registry

    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if not registry.supports_paged(cfg):
        raise ValueError(
            f"{cfg.name} ({cfg.family}) cannot serve tensor-parallel: the "
            "head-sharded decode requires the paged backend (MoE routing "
            "and SSM/hybrid lane caches have no KV-head axis to shard)")
    if tp == 1:
        return
    if cfg.n_kv_heads % tp:
        detail = ("MQA has a single shared KV head" if cfg.n_kv_heads == 1
                  else f"{cfg.n_kv_heads} KV heads")
        raise ValueError(
            f"{cfg.name}: n_kv_heads {cfg.n_kv_heads} % tp {tp} != 0 — the "
            f"pool arenas shard whole KV heads per device ({detail}, "
            f"cannot split across {tp} devices)")


def serve_param_spec(axes, tp_axis: str = "model") -> PartitionSpec:
    """PartitionSpec of one parameter under serving tensor parallelism.

    The rule is the logical-axis rendition of Megatron-style attention TP:
    a projection *into* head space (its :class:`~repro_torch.sharding.
    params.Axes` contain HEADS/KV_HEADS and end in HEAD_DIM — wq/wk/wv)
    shards that head axis over ``tp_axis``; everything else — including the
    output projection wo, whose trailing axis is EMBED and which consumes
    the gathered heads — stays replicated, so the only exchange in the
    decode step is the one gather of heads before the output projection.
    """
    dims = tuple(axes)
    if not dims or dims[-1] != lax_.HEAD_DIM:
        return PartitionSpec()
    out: list = []
    sharded = False
    for name in dims:
        if not sharded and name in (lax_.HEADS, lax_.KV_HEADS):
            out.append(tp_axis)
            sharded = True
        else:
            out.append(None)
    if not sharded:
        return PartitionSpec()
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def serve_param_specs(cfg, tp_axis: str = "model"):
    """Tree of per-parameter PartitionSpecs for the TP paged decode,
    derived from the registry's own logical-axis declarations (one source
    of truth with training: :func:`repro_torch.sharding.params.axes_tree`)."""
    from repro_torch.models import registry

    return tree_map(lambda ax: serve_param_spec(ax, tp_axis),
                    axes_tree(registry.decls(cfg)))


def serve_pool_spec(tp_axis: str = "model") -> PartitionSpec:
    """PartitionSpec of a KV pool arena ``(L, P, page, Kh, Dh)``: sharded
    over the KV-head axis only — page ids (and the block tables indexing
    them) stay device-invariant, so host-side allocation is unchanged."""
    return PartitionSpec(None, None, None, tp_axis)


def shard_bytes(shape: Sequence[int], spec: PartitionSpec, mesh,
                dtype_bytes: int) -> int:
    """Per-device bytes of an array under a spec (for memory napkin math)."""
    sizes = _mesh_sizes(mesh)
    n = math.prod(shape) if shape else 1
    denom = 1
    for entry in spec:
        for ax in _as_tuple(entry):
            denom *= sizes.get(ax, 1)
    return int(n * dtype_bytes / max(denom, 1))
