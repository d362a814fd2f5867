"""repro_torch — the PyTorch + CUDA port of the ``repro`` package for an
NVIDIA H100.

It imports ``torch``, numpy and the standard library, never ``jax`` and
nothing of ``repro``: the JAX package stays the reference, and the port
keeps its own copies of what it needs from it. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the card the
paged-attention and fused-MLP paths run the hand-written kernels of
``repro_torch/csrc``, on the CPU their plain PyTorch versions.
"""
