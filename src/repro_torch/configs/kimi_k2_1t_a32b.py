"""Kimi-K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe", source="arXiv:2501.kimi2",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=112, d_ff=2048, vocab_size=163840,
    num_experts=384, experts_per_token=8,
    moe_capacity_factor=1.25,
)

LONG_500K_POLICY = "skip"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", arch_type="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=64, vocab_size=512,
        num_experts=4, experts_per_token=2,
    )
