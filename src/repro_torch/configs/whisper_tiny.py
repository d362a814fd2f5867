"""Whisper-tiny — encoder-decoder audio transformer [arXiv:2212.04356].

The mel-spectrogram + conv frontend is STUBBED per the assignment:
``input_specs()`` provides (B, encoder_ctx, d_model) frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", arch_type="audio", source="arXiv:2212.04356",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_ctx=1500,
)

# Pure full attention, decoder context in the source model is 448; a 500k
# decode is meaningless for this arch -> skip (DESIGN.md §4.1).
LONG_500K_POLICY = "skip"


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", arch_type="audio",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, encoder_layers=2, encoder_ctx=64,
    )
