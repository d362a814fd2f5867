"""InternLM2-20B — dense, GQA kv=8 [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", arch_type="dense", source="arXiv:2403.17297",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544, rope_theta=1000000.0,
)

LONG_500K_POLICY = "swa"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512,
    )
