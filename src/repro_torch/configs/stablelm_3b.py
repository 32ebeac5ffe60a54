"""stablelm-3b [dense]: MHA (kv=32) decoder. [hf:stabilityai/stablelm-2-1_6b;
unverified] — 32L d_model=2560 32H d_ff=6912 vocab=50304. Pure full attention:
long_500k skipped (noted in DESIGN.md)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304, mlp_type="swiglu", pos_emb="rope",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=256, mlp_type="swiglu",
        q_block=8, kv_block=8, remat="none",
    )
