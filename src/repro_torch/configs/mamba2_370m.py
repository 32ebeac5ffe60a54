"""mamba2-370m [ssm]: SSD (state-space duality). [arXiv:2405.21060;
unverified] — 48L d_model=1024, ssm_state=128, head_dim=64, expand=2,
vocab=50280, tied embeddings. Attention-free: long_500k RUNS."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=256, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, vocab=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv_width=4,
        ssm_chunk=8, tie_embeddings=True, remat="none",
    )
