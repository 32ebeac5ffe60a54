"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP + 256k vocabulary
(vocab-sharding stress case). [arXiv:2402.16819; unverified] —
32L d_model=6144 48H (kv=8) d_ff=24576 vocab=256000.
Full attention: long_500k skipped."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000, mlp_type="squared_relu", pos_emb="rope",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=512, mlp_type="squared_relu",
        q_block=8, kv_block=8, remat="none",
    )
