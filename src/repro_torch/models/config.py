"""ModelConfig — one dataclass covering all assigned architecture families.

A copy of ``src/repro/models/config.py``: the port keeps its own copy so
that it imports nothing of the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int | None = None
    sliding_window: int | None = None      # SWA window (None = global attention)
    # mlp
    d_ff: int = 0
    mlp_type: str = "swiglu"               # swiglu|geglu|gelu|squared_relu
    # embeddings
    pos_emb: str = "rope"                  # rope|sinusoidal|none
    rope_theta: float = 1e4
    embed_inputs: bool = True              # False: modality stub feeds embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_interleave: int = 1                # MoE every k-th layer (1 = all)
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_compute_dtype: str = "float32"   # bfloat16: halve SSD scan traffic
    # hybrid (recurrentgemma / griffin)
    rnn_width: int | None = None
    attn_window: int | None = None         # local-attention window in hybrid
    block_pattern: tuple[str, ...] = ()    # e.g. ("rec","rec","attn")
    rglru_c: float = 8.0
    # vocab padding: round embedding/head vocab up to this multiple so the
    # vocab axis stays shardable (e.g. 49155 -> 49408 with pad 128*k); padded
    # logits are masked to -inf in the head. 0 disables.
    vocab_pad_multiple: int = 0
    # numerics / execution
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"             # ref|chunked|pallas
    scan_impl: str = "chunked"             # ssd/rglru backend
    moe_impl: str = "chunked"
    remat: str = "full"                    # none|full|dots
    q_block: int = 512
    kv_block: int = 512

    def __post_init__(self):
        if self.family in ("dense", "moe", "audio", "vlm", "hybrid"):
            if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
                raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.family == "moe" and self.moe_experts < 2:
            raise ValueError("moe family needs moe_experts >= 2")

    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad_multiple:
            return self.vocab
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def is_subquadratic(self) -> bool:
        """True if prefill/decode cost does not grow quadratically without
        bound in sequence length — the long_500k eligibility test."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True  # RG-LRU + windowed local attention
        return self.sliding_window is not None

    def param_count(self) -> int:
        from repro_torch.models import registry
        from repro_torch.sharding.params import count_params

        return count_params(registry.decls(self))

    def active_param_count(self) -> int:
        """Active-per-token params (differs from total only for MoE)."""
        if self.family != "moe":
            return self.param_count()
        total = self.param_count()
        n_moe_layers = len([i for i in range(self.n_layers)
                            if i % self.moe_interleave == self.moe_interleave - 1])
        per_expert = 3 * self.d_model * self.d_ff
        inactive = n_moe_layers * per_expert * (self.moe_experts - self.moe_top_k)
        return total - inactive
