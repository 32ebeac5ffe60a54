"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000. SWA makes it long_500k-eligible (window 4096)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab=32000, mlp_type="swiglu", pos_emb="rope",
    rope_theta=10_000.0, sliding_window=4096,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, mlp_type="swiglu", sliding_window=16,
        q_block=8, kv_block=8, remat="none",
    )
