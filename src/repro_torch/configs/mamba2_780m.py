"""Mamba2-780M — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", arch_type="ssm", source="arXiv:2405.21060",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_heads=48, ssm_head_dim=64,  # expand=2: 48*64 = 2*d_model
)

# Constant-size recurrent state: long_500k runs natively.
LONG_500K_POLICY = "run"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", arch_type="ssm",
        num_layers=2, d_model=128, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_heads=4, ssm_head_dim=64, ssm_chunk=32,
    )
