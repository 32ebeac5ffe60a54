"""grok-1-314b [moe]: 8 experts, top-2 routing. [hf:xai-org/grok-1;
unverified] — 64L d_model=6144 48H (kv=8) d_ff=32768 vocab=131072.
Expert count (8) < model-axis size (16), so the rule engine automatically
falls back to tensor-parallel expert FFNs (d_ff over `model`) with experts
replicated — recorded in DESIGN.md. Full attention: long_500k skipped."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, mlp_type="swiglu", pos_emb="rope",
    moe_experts=8, moe_top_k=2, moe_interleave=1,
    moe_capacity_factor=1.25,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="grok-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, mlp_type="swiglu",
        moe_experts=4, moe_top_k=2, q_block=8, kv_block=8, remat="none",
    )
