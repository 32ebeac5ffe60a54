"""internvl2-76b [vlm]: InternViT + InternLM2 — BACKBONE ONLY per the brief;
the vision tower is a STUB (input_specs() provides precomputed patch
embeddings). [arXiv:2404.16821; unverified] — 80L d_model=8192 64H (kv=8)
d_ff=28672 vocab=128256. Full attention: long_500k skipped."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, mlp_type="swiglu", pos_emb="rope",
    embed_inputs=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, mlp_type="swiglu", embed_inputs=False,
        q_block=8, kv_block=8, remat="none",
    )
