"""Shared neural layers, as plain functions on tensors.

Port of ``src/repro/models/layers.py`` for the dense decode and training
paths, the hybrid family's serving and the MoE family's serving: norms,
positional encodings, the multi-token attention entry, the four MLP kinds,
the mixture of experts (capacity-grouped dispatch, the expert FFN through
the grouped-matmul op, the dense oracle), the depthwise causal conv, the
LM head, the cross-entropy loss and the naive attention oracle, with the
reference's dtype boundaries (norm and rope in float32, cast back to the
input dtype; router and combine in float32; the loss in float32) and mask
constant (``-1e30``).

Every kernel call of a model path goes through the XAIF registry
(:data:`repro_torch.core.xaif.REGISTRY`), by op name and the impl key that
:func:`impl_key` makes of the config's ``attn_impl``, ``scan_impl`` or
``moe_impl``, as the reference's models dispatch
(``src/repro/models/layers.py:313,441``): an accelerator registered under
a new key plugs in without an edit here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.xaif import REGISTRY
# imported for their XAIF registrations under "cuda"
from repro_torch.kernels.attention import ops as _attn_ops  # noqa: F401
from repro_torch.kernels.moe import ops as _moe_ops  # noqa: F401
from repro_torch.sharding import axes as lx
from repro_torch.sharding.params import Axes, ParamDecl

F32 = torch.float32
NEG_INF = -1e30

# the reference's backend names; the port has one backend for them all
_REFERENCE_IMPLS = ("ref", "chunked", "pallas")


def impl_key(impl: str) -> str:
    """The registry's impl key for a config's ``attn_impl``, ``scan_impl``
    or ``moe_impl``: the reference's own names (``"ref"``, ``"chunked"``,
    ``"pallas"``) are the port's one backend, ``"cuda"`` (its wrapper sends
    a CPU tensor to the plain version and a CUDA tensor to the kernel);
    any other name is a key of its own, and an unregistered one raises the
    registry's ``KeyError`` at the call."""
    return "cuda" if impl in _REFERENCE_IMPLS else impl


# ---------------------------------------------------------------------------
# Norms / embeddings / positional
# ---------------------------------------------------------------------------


def rmsnorm_decl(d: int) -> ParamDecl:
    return ParamDecl((d,), Axes(lx.EMBED), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x.dtype``."""
    dt = x.dtype
    x = x.to(F32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(F32)).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(cos, sin)`` of shape ``(..., seq, 1, head_dim // 2)`` for
    :func:`apply_rope`; one pair serves every layer of a step."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=F32, device=positions.device)
                      / half)
    ang = positions.to(F32)[..., None] * freqs
    ang = ang[..., None, :]          # broadcast over heads
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of ``x`` (..., seq, heads, head_dim) in float32,
    cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    xf = x.to(F32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(1e4)
                      * torch.arange(half, dtype=F32, device=positions.device)
                      / half)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention oracle
# ---------------------------------------------------------------------------


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """Naive full-score oracle. q:(B,Sq,H,D) k,v:(B,Sk,K,D); GQA folds
    head ``h`` onto KV head ``h // (H // K)``. ``kv_len`` (an int, a 0-d
    tensor, or a (B,) tensor: one length a batch row) masks the keys at
    and past it."""
    b, sq, h, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    qf = q.reshape(b, sq, nkv, h // nkv, d).to(F32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.to(F32)) / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        mask = mask & (kpos < kv_len.reshape(-1, 1, 1, 1, 1))
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(F32))
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              impl: str = "cuda") -> torch.Tensor:
    """Multi-token attention of the training path: q (B,S,H,D), k/v
    (B,S,K,D) -> (B,S,H,D), differentiable.

    Every call dispatches op ``"attention"`` under :func:`impl_key` of
    ``impl`` (``"cuda"``: :func:`repro_torch.kernels.attention.ops.
    flash_attention`, the CUDA kernels on the card, the plain versions on
    the CPU). Unlike the reference (``layers.py:293-298``) it does not
    repeat KV to the full head count: the kernels read KV head ``h // G``
    for query head ``h``, and sum dk/dv over each group in float32, which
    is what the transpose of the repeat computes.
    """
    return REGISTRY.dispatch("attention", impl_key(impl), q, k, v,
                             causal=causal, window=window)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def mlp_decls(d: int, f: int, kind: str) -> dict[str, ParamDecl]:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamDecl((d, f), Axes(lx.EMBED, lx.MLP), init="fan_in"),
            "w_up": ParamDecl((d, f), Axes(lx.EMBED, lx.MLP), init="fan_in"),
            "w_down": ParamDecl((f, d), Axes(lx.MLP, lx.EMBED), init="fan_in"),
        }
    return {  # gelu / squared_relu: plain 2-matrix MLP
        "w_up": ParamDecl((d, f), Axes(lx.EMBED, lx.MLP), init="fan_in"),
        "w_down": ParamDecl((f, d), Axes(lx.MLP, lx.EMBED), init="fan_in"),
    }


def mlp(x: torch.Tensor, p: dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh")
                * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w_up"]
    if kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif kind == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts: capacity-grouped dispatch
# ---------------------------------------------------------------------------


def moe_decls(d: int, f: int, n_exp: int, kind: str = "swiglu",
              shared: bool = False) -> dict:
    def e(shape, ax):
        return ParamDecl((n_exp, *shape), Axes(lx.EXPERT, *ax), init="fan_in")

    decls: dict = {
        "router": ParamDecl((d, n_exp), Axes(lx.EMBED, None), init="fan_in"),
        "w_gate": e((d, f), (lx.EMBED, lx.MLP)),
        "w_up": e((d, f), (lx.EMBED, lx.MLP)),
        "w_down": e((f, d), (lx.MLP, lx.EMBED)),
    }
    if shared:
        decls["shared"] = mlp_decls(d, f, kind)
    return decls


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router of ``moe``: tokens xt (T, d) -> ``(probs (T, E), gates (T, k),
    experts (T, k))``, in float32 (the router is lifted to float32 whatever
    its dtype). The top k by a stable descending sort, so equal
    probabilities take the lower expert first, as ``lax.top_k`` does
    (``torch.topk`` does not promise an order among ties). Gates are
    renormalised over the k chosen."""
    probs = torch.softmax(xt.to(F32) @ router.to(F32), dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :top_k], eidx[:, :top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, eidx


def capacity(t: int, top_k: int, capacity_factor: float, n_exp: int) -> int:
    """Slots per expert (``layers.py:416-417``): the float share truncated,
    rounded up to a multiple of 8, at least 8, at most ``t``."""
    cap = int(max(8, -(-int(t * top_k * capacity_factor / n_exp) // 8) * 8))
    return min(cap, t)


def moe(x: torch.Tensor, p: dict, *, n_exp: int, top_k: int,
        capacity_factor: float = 1.25, kind: str = "swiglu",
        impl: str = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> ``(out (B, S, d), aux_loss)`` (``layers.py:396-453``).

    Dispatch is sort-based with a static per-expert capacity: each token's
    k choices are stably sorted by expert, a slot past the expert's
    capacity is dropped (it contributes nothing: GShard semantics), and the
    kept tokens are gathered into an (E, capacity, d) buffer, zero rows in
    the free slots. The expert FFN runs on that buffer through op
    ``"moe_ffn"`` under :func:`impl_key` of ``impl`` (``"cuda"``:
    :func:`repro_torch.kernels.moe.ops.moe_ffn`, three launches of the
    grouped-matmul kernel on the card), and the outputs are combined
    back per token in float32, weighted by the renormalised gates. The aux
    loss is Switch's load-balance term ``E * sum_e f_e * p_e``. Only
    ``impl="chunked"``'s arithmetic exists here; the op is the kernel on
    the card, the plain version on the CPU.
    """
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    probs, gates, eidx = route(xt, p["router"], top_k)

    me = probs.mean(dim=0)
    ce = torch.zeros((n_exp,), dtype=F32, device=dev).index_add_(
        0, eidx.reshape(-1), torch.ones((t * top_k,), dtype=F32, device=dev))
    aux = n_exp * torch.sum(me * (ce / (t * top_k)))

    cap = capacity(t, top_k, capacity_factor, n_exp)
    slot_e = eidx.reshape(-1)                          # (T*k,)
    slot_g = gates.reshape(-1)
    order = torch.argsort(slot_e, stable=True)         # as jnp.argsort
    sorted_e = slot_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_exp, dtype=sorted_e.dtype, device=dev))
    pos = torch.arange(t * top_k, device=dev) - seg_start[sorted_e]
    keep = pos < cap
    dest = sorted_e * cap + pos                        # flat slot id
    tok = order // top_k                               # token of each slot

    # gather tokens into (E, cap, d); a free slot reads the zero row t.
    # Dropped slots write to one extra entry, cut off after (the
    # reference's mode="drop" write at index n_exp * cap)
    buf = torch.full((n_exp * cap + 1,), t, dtype=torch.long, device=dev)
    buf[torch.where(keep, dest, n_exp * cap)] = tok
    xg = torch.cat([xt, xt.new_zeros((1, d))])[buf[:-1]]
    hg = REGISTRY.dispatch("moe_ffn", impl_key(impl),
                           xg.reshape(n_exp, cap, d), p, kind)

    slot_out = hg.reshape(n_exp * cap, d)[torch.where(keep, dest, 0)]
    w = (slot_g[order] * keep).to(F32)[:, None]
    # at most top_k addends a token, each into zero: the sum is the same in
    # any order, so index_add_'s atomics on the card stay exact for k <= 2
    out = torch.zeros((t, d), dtype=F32, device=dev).index_add_(
        0, tok, slot_out.to(F32) * w)
    out = out.to(x.dtype).reshape(b, s, d)
    if "shared" in p:
        out = out + mlp(x, p["shared"], kind)
    return out, aux


def moe_lanes(x: torch.Tensor, p: dict, *, n_exp: int, top_k: int,
              kind: str = "swiglu", impl: str = "cuda") -> torch.Tensor:
    """x (B, 1, d) -> out (B, 1, d): each row routed as a batch of its own,
    as the reference's lane engine routes a lane under ``vmap``.

    A lane is one token, so its capacity is ``capacity(1, ...) = 1`` and
    no slot is ever dropped (its k experts are distinct); :func:`moe`
    over the B rows together would share a capacity of at most 8 slots an
    expert among them and drop past it. The lanes' (E, 1, d) dispatch
    buffers are packed along the capacity axis into one (E, B, d) buffer,
    lane b in row b, zero where the lane did not pick the expert, so the
    expert FFN is one ``"moe_ffn"`` dispatch for all lanes, as in
    :func:`moe` (three grouped-matmul launches on the card): rows of a
    product are independent, so each row is the lane's own result. The k
    outputs of a lane are weighted by its gates and summed in float32 in
    expert order, as the reference's combine adds them.
    """
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"moe_lanes routes one token a lane, got {s}")
    xt = x.reshape(b, d)
    _, gates, eidx = route(xt, p["router"], top_k)
    picked = torch.zeros((n_exp, b), dtype=torch.bool, device=x.device)
    picked[eidx.T, torch.arange(b, device=x.device)] = True
    xg = torch.where(picked[..., None], xt, xt.new_zeros(()))
    hg = REGISTRY.dispatch("moe_ffn", impl_key(impl), xg, p, kind)  # (E, B, d)
    order = torch.argsort(eidx, dim=-1, stable=True)
    eidx, gates = eidx.gather(1, order), gates.gather(1, order)
    lanes = torch.arange(b, device=x.device)
    out = torch.zeros((b, d), dtype=F32, device=x.device)
    for j in range(top_k):
        out = out + hg[eidx[:, j], lanes].to(F32) * gates[:, j:j + 1]
    out = out.to(x.dtype).reshape(b, 1, d)
    if "shared" in p:
        out = out + mlp(x, p["shared"], kind)
    return out


def moe_dense_ref(x: torch.Tensor, p: dict, *, n_exp: int, top_k: int,
                  kind: str = "swiglu", impl: str = "cuda") -> torch.Tensor:
    """Oracle: every expert on every token, then mixed by the gates
    (``layers.py:456-470``). O(E) FLOPs; equals :func:`moe` when no slot is
    dropped."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    _, gates, eidx = route(xt, p["router"], top_k)
    full = torch.zeros((t, n_exp), dtype=F32, device=x.device).scatter_(
        1, eidx, gates)
    outs = REGISTRY.dispatch("moe_ffn", impl_key(impl),
                             xt.expand(n_exp, t, d).contiguous(), p, kind)
    out = torch.einsum("te,etd->td", full, outs.to(F32))
    if "shared" in p:
        out = out + mlp(x, p["shared"], kind).reshape(t, d).to(F32)
    return out.to(x.dtype).reshape(b, s, d)


# ---------------------------------------------------------------------------
# Lanes
# ---------------------------------------------------------------------------


def keep_lanes(keep: torch.Tensor | None, new: torch.Tensor,
               old: torch.Tensor) -> torch.Tensor:
    """``new`` where ``keep`` (B,) bool is set, ``old`` elsewhere: the
    masked update of a lane engine's chunk step (a masked lane keeps its
    old values bit for bit). The batch axis is ``new``'s first;
    ``keep=None`` keeps every lane and returns ``new`` itself."""
    if keep is None:
        return new
    return torch.where(keep.reshape(-1, *(1,) * (new.dim() - 1)), new, old)


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (griffin's temporal conv)
# ---------------------------------------------------------------------------


def conv1d_decl(width: int, channels: int) -> ParamDecl:
    return ParamDecl((width, channels), Axes(lx.CONV, lx.RNN_WIDTH),
                     init="fan_in")


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D), w (W,D), state (B,W-1,D) -> ``(y, new_state)``.

    ``layers.py:477-490``: the depthwise sum of the W products of ``w[i]``
    with ``[state, x]`` shifted by ``i``, in the input dtype (each product
    and each partial sum rounds to it); the new state is the last W-1 rows
    of ``[state, x]``. Plain PyTorch on every device: the reference computes
    it in pure JAX too, not through its ``conv1d_causal`` Pallas kernel.
    """
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xx = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = xx[:, :s] * w[0]
    for i in range(1, width):
        y = y + xx[:, i:i + s] * w[i]
    new_state = xx[:, -(width - 1):] if width > 1 else state
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------


def embed_decl(cfg) -> ParamDecl:
    return ParamDecl((cfg.padded_vocab, cfg.d_model), Axes("vocab_in", lx.EMBED),
                     init="normal", scale=0.02)


def head_decl(cfg) -> ParamDecl:
    return ParamDecl((cfg.d_model, cfg.padded_vocab), Axes(lx.EMBED, lx.VOCAB),
                     init="fan_in")


def lm_head(x: torch.Tensor, params, cfg) -> torch.Tensor:
    """x: (..., d_model) -> logits (..., padded_vocab) with padding masked
    to ``-1e30``."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["head"].to(x.dtype)
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = NEG_INF
    return logits


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Per-token cross entropy in float32, with the max detached and an
    optional z-loss ``z_loss * lse**2`` (``layers.py:526-540``)."""
    logits = logits.to(F32)
    m = logits.amax(-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(-1)) + m[..., 0]
    picked = shifted.gather(-1, labels[..., None].long())[..., 0] + m[..., 0]
    loss = lse - picked
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss
