"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", arch_type="moe", source="arXiv:2409.02060",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, num_experts=64, experts_per_token=8,
    rope_theta=10000.0,
)

# long_500k: full attention, no SWA variant in the source model -> skip.
LONG_500K_POLICY = "skip"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", arch_type="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=512, num_experts=4, experts_per_token=2,
    )
