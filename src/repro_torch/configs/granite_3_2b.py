"""granite-3-2b [dense]: GQA. [hf:ibm-granite/granite-3.0-2b-base; hf] —
40L d_model=2048 32H (kv=8) d_ff=8192 vocab=49155, tied embeddings.
Full attention: long_500k skipped."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=49155, mlp_type="swiglu", pos_emb="rope",
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, mlp_type="swiglu", tie_embeddings=True,
        q_block=8, kv_block=8, remat="none",
    )
