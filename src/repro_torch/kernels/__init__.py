"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (the CPU path and the on-card reference). Sources live in
``repro_torch/csrc`` and are built at first use (``kernels/build.py``)."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import fused_mlp as _fused_mlp
from repro_torch.kernels import paged_attention as _paged_attention
from repro_torch.kernels import ssd_scan as _ssd_scan

#: the wrappers whose ``launches`` count shows a run went through them
WRAPPERS = {"paged_attention": _paged_attention.paged_attention,
            "fused_mlp": _fused_mlp.fused_mlp,
            "flash_attention": _flash_attention.flash_attention,
            "ssd_scan": _ssd_scan.ssd_scan}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
