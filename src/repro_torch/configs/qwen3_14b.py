"""Qwen3-14B — dense, GQA kv=8, qk_norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", arch_type="dense", source="hf:Qwen/Qwen3-8B",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=17408, vocab_size=151936,
    qk_norm=True, rope_theta=1000000.0,
)

LONG_500K_POLICY = "swa"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, qk_norm=True,
    )
