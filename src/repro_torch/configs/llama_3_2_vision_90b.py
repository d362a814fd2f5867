"""Llama-3.2-Vision-90B — cross-attention image layers [hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision tower + projector are STUBBED per the assignment:
``input_specs()`` provides (B, num_image_tokens, d_model) patch embeddings.
100 layers = 80 self-attention + 20 cross-attention (one every 4 self layers).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", arch_type="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, rope_theta=500000.0,
    cross_attn_every=4, num_image_tokens=1601,
)

# Self-attention goes sliding-window at 500k; cross-attention is already
# O(num_image_tokens) per query.
LONG_500K_POLICY = "swa"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", arch_type="vlm",
        num_layers=3, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, cross_attn_every=2, num_image_tokens=16,
    )
