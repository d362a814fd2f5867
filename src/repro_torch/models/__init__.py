"""The port's model code: layers, the paged KV cache, the dense decoder,
the pure-SSM LM and the Mamba2 + shared-attention hybrid.
``get_model(cfg)`` returns the family module (the reference's
``repro/models/__init__.py::get_model``) for the families ported so far;
the others raise naming their ROADMAP.md item."""
from __future__ import annotations

#: family -> what is missing for it, for the families not ported yet
_TODO = {"moe": "the MoE FFN (ROADMAP.md Queue 1 item 10)",
         "audio": "the enc-dec audio family (ROADMAP.md Queue 1 item 10)",
         "vlm": "the VLM family (ROADMAP.md Queue 1 item 10)"}


def get_model(cfg):
    """The family module: ``transformer`` for dense decoders, ``mamba_lm``
    for the SSM family, ``hybrid`` for the hybrid."""
    from repro_torch.models import hybrid, mamba_lm, transformer
    if cfg.arch_type == "dense" and not cfg.is_moe:
        return transformer
    if cfg.arch_type == "ssm":
        return mamba_lm
    if cfg.arch_type == "hybrid":
        return hybrid
    what = _TODO.get("moe" if cfg.is_moe else cfg.arch_type,
                     "ROADMAP.md Queue 1 item 10")
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.arch_type} family is not ported to "
        f"repro_torch yet: {what}")
