"""DeepSeek-Coder-33B — llama-arch dense, GQA kv=8 [arXiv:2401.14196]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", arch_type="dense", source="arXiv:2401.14196",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256, rope_theta=100000.0,
)

# Dense full-attention: long_500k runs only via the sliding-window variant
# (window 4096), per DESIGN.md §4.
LONG_500K_POLICY = "swa"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512,
    )
