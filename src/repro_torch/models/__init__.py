"""The port's model code: layers, the paged KV cache, the decoder (dense
or MoE FFN), the pure-SSM LM, the Mamba2 + shared-attention hybrid and
the enc-dec audio model. ``get_model(cfg)`` returns the family module
(the reference's ``repro/models/__init__.py::get_model``) for the
families ported so far; the others raise naming their ROADMAP.md item."""
from __future__ import annotations

#: family -> what is missing for it, for the families not ported yet
_TODO = {"vlm": "the VLM family (ROADMAP.md Queue 1 item 10)"}


def get_model(cfg):
    """The family module: ``transformer`` for dense and MoE decoders,
    ``mamba_lm`` for the SSM family, ``hybrid`` for the hybrid,
    ``encdec`` for the enc-dec audio family."""
    from repro_torch.models import encdec, hybrid, mamba_lm, transformer
    family = {"dense": transformer, "moe": transformer, "ssm": mamba_lm,
              "hybrid": hybrid, "audio": encdec}.get(cfg.arch_type)
    if family is not None:
        return family
    what = _TODO.get(cfg.arch_type, "ROADMAP.md Queue 1 item 10")
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.arch_type} family is not ported to "
        f"repro_torch yet: {what}")
