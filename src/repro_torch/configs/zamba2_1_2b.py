"""Zamba2-1.2B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", arch_type="hybrid", source="arXiv:2411.15242",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_heads=64, ssm_head_dim=64,   # expand=2: 64*64 = 2*d_model
    hybrid_attn_every=6,                           # shared attn block every 6 mamba layers
)

# Hybrid (SSM-dominant) is sub-quadratic; the shared attention block uses a
# sliding window at 500k to keep its cache bounded.
LONG_500K_POLICY = "run"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", arch_type="hybrid",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512,
        ssm_state=16, ssm_heads=4, ssm_head_dim=64, ssm_chunk=32,
        hybrid_attn_every=2,
    )
