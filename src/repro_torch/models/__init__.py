"""The port's model code: layers, the paged KV cache, the decoder (dense
or MoE FFN), the pure-SSM LM, the Mamba2 + shared-attention hybrid, the
enc-dec audio model and the VLM. ``get_model(cfg)`` returns the family
module (the reference's ``repro/models/__init__.py::get_model``)."""
from __future__ import annotations


def get_model(cfg):
    """The family module: ``transformer`` for dense and MoE decoders,
    ``mamba_lm`` for the SSM family, ``hybrid`` for the hybrid,
    ``encdec`` for the enc-dec audio family, ``vlm`` for the VLM."""
    from repro_torch.models import (encdec, hybrid, mamba_lm, transformer,
                                    vlm)
    return {"dense": transformer, "moe": transformer, "ssm": mamba_lm,
            "hybrid": hybrid, "audio": encdec, "vlm": vlm}[cfg.arch_type]
