"""Fused SwiGLU MLP: the hand-written CUDA kernels (``csrc/fused_mlp.cu``)
and their plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/fused_mlp.py::fused_mlp``
(body ``_kernel``), which keeps a ``(block_m, d)`` fp32 accumulator in
VMEM across the ``d_ff`` axis so the gated intermediate never reaches
HBM. At d = 5120 that accumulator is 20 KB per row and does not fit a
Hopper block's shared memory at a useful ``block_m``, so the port splits
the work in two tiled GEMMs (design (i) in the source note): gate/up with
the ``silu(g) * u`` epilogue writing ``h`` in Wd's dtype to a scratch
buffer that stays in L2 at the serving batch, then the down-projection.
No float atomics: every output element is summed by one thread in a fixed
order, so greedy serving is reproducible run to run.

Contract: x ``(T, d)``; w_gate/w_up ``(d, f)``; w_down ``(f, d)`` ->
``(T, d)`` in x's dtype = ``(silu(x·Wg) ∘ (x·Wu))·Wd`` with fp32
accumulation and ``h`` cast to Wd's dtype before the down-projection.
Ragged T, d and f are masked, not asserted.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build


def fused_mlp_plain(x, w_gate, w_up, w_down):
    """fp32 math; ``h`` rounded to Wd's dtype as the kernels store it."""
    x32 = x.float()
    g = x32 @ w_gate.float()
    u = x32 @ w_up.float()
    h = (F.silu(g) * u).to(w_down.dtype)
    return (h.float() @ w_down.float()).to(x.dtype)


def fused_mlp_cuda(x, w_gate, w_up, w_down):
    """Launch the gate/up and down kernels on PyTorch's current stream."""
    t, d = x.shape
    f = w_gate.shape[1]
    if w_gate.shape != (d, f) or w_up.shape != (d, f) or \
            w_down.shape != (f, d):
        raise ValueError(
            f"fused_mlp: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
            f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError("fused_mlp kernel takes float32 or bfloat16 x and "
                        "weights of one dtype")
    for a in (x, w_gate, w_up, w_down):
        if not a.is_cuda or not a.is_contiguous():
            raise ValueError("fused_mlp kernel takes contiguous CUDA "
                             "tensors")
    h = torch.empty((t, f), dtype=w_down.dtype, device=x.device)
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    lib = build.load("fused_mlp")
    fn = lib.fused_mlp_bf16 if x.dtype == torch.bfloat16 \
        else lib.fused_mlp_f32
    code = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
              w_down.data_ptr(), h.data_ptr(), out.data_ptr(), t, d, f,
              torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fused_mlp")
    fused_mlp.launches += 1
    return out


def fused_mlp(x, w_gate, w_up, w_down):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernels for CUDA tensors. ``x`` may carry leading batch axes.
    ``fused_mlp.launches`` counts calls that launched the kernel pair."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = fused_mlp_plain(x2, w_gate, w_up, w_down)
    else:
        y = fused_mlp_cuda(x2.contiguous(), w_gate, w_up, w_down)
    return y.reshape(*lead, y.shape[-1])


fused_mlp.launches = 0
