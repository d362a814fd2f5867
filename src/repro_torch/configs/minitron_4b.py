"""Minitron-4B — pruned Nemotron, dense GQA kv=8 [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", arch_type="dense", source="arXiv:2407.14679",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab_size=256000,
)

LONG_500K_POLICY = "swa"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke", arch_type="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512,
    )
