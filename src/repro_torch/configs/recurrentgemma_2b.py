"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, pattern
(rec, rec, attn). [arXiv:2402.19427; hf] — 26L d_model=2560 10H (MQA kv=1)
d_ff=7680 vocab=256000, rnn_width=2560, window=2048, tied embeddings.
Sub-quadratic: long_500k RUNS."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, mlp_type="geglu", pos_emb="rope",
    rnn_width=2560, attn_window=2048, block_pattern=("rec", "rec", "attn"),
    ssm_conv_width=4, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, mlp_type="geglu", rnn_width=64, attn_window=16,
        block_pattern=("rec", "rec", "attn"), ssm_conv_width=4,
        tie_embeddings=True, q_block=8, kv_block=8, remat="none",
    )
