"""musicgen-large [audio]: decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf] — 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (brief requirement). Full attention: long_500k skipped."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, mlp_type="gelu", pos_emb="sinusoidal",
    embed_inputs=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=64, mlp_type="gelu", pos_emb="sinusoidal",
        embed_inputs=False, q_block=8, kv_block=8, remat="none",
    )
