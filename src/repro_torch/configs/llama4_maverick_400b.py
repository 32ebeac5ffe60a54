"""llama4-maverick-400b-a17b [moe]: 128 experts, top-1, shared expert.
[hf:meta-llama/Llama-4-*; unverified] — 48L d_model=5120 40H (kv=8)
d_ff=8192 vocab=202048.

Config note (see DESIGN.md): the assignment line with MoE on *every* layer
yields ~790 B params, inconsistent with the 400B-A17B name; we follow the
published Llama-4 structure — MoE every 2nd layer + a shared expert — landing
at ~398 B total / ~17 B active. Full attention assumed: long_500k skipped."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, mlp_type="swiglu", pos_emb="rope",
    moe_experts=128, moe_top_k=1, moe_interleave=2, moe_shared_expert=True,
    moe_capacity_factor=1.25,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, mlp_type="swiglu",
        moe_experts=4, moe_top_k=1, moe_interleave=2, moe_shared_expert=True,
        q_block=8, kv_block=8, remat="none",
    )
