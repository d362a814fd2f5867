"""Fused SwiGLU MLP: the hand-written CUDA kernels (``csrc/fused_mlp.cu``)
and their plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/fused_mlp.py::fused_mlp``
(body ``_kernel``), which keeps a ``(block_m, d)`` fp32 accumulator in
VMEM across the ``d_ff`` axis so the gated intermediate never reaches
HBM. At d = 5120 that accumulator is 20 KB per row and does not fit a
Hopper block's shared memory at a useful ``block_m``, so the port splits
the work in two tiled GEMMs (design (i) in the source note): gate/up with
the ``silu(g) * u`` epilogue writing ``h`` in Wd's dtype to a scratch
buffer that stays in L2 at the serving batch, then the down-projection. In
bf16 both run on TMA and ``wgmma``; blocks that split K (:func:`mlp_plan`)
write fp32 sums to a scratch whose parts a second pass adds in a fixed
order. No float atomics: the same call gives the same bits, so
greedy serving is reproducible run to run.

Contract: x ``(T, d)``; w_gate/w_up ``(d, f)``; w_down ``(f, d)`` ->
``(T, d)`` in x's dtype = ``(silu(x·Wg) ∘ (x·Wu))·Wd`` with fp32
accumulation and ``h`` cast to Wd's dtype before the down-projection.
Ragged T, d and f are masked, not asserted; the bf16 kernels take d and f
that are multiples of 8 (TMA's 16-byte row strides) and raise otherwise.
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


def needs_grad(*tensors) -> bool:
    """True when autograd would record an op on ``tensors``."""
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


def mlp_plan(t: int, d: int, f: int, sms: int):
    """How the bf16 kernels split their work on ``sms`` SMs (one block an
    SM): ``(down_splits, gate_tail, gate_splits, scratch_floats)``.

    Gate/up takes 128 x 128 output units, one block each, in waves of
    ``sms``. A last wave that would leave most SMs idle (8 units of 272
    at T = 256, f = 17408 on 132 SMs) is split in K instead: its
    ``gate_tail`` units take ``gate_splits`` shorter blocks each, at most
    16 and one a 64-deep K block. The down GEMM's 128 x 256 units (40 at
    T = 256, d = 5120) are split in K to cover the SMs once
    (``down_splits``, at most 8). ``scratch_floats`` sizes the fp32
    scratch both splits share (0 when neither splits)."""
    units = -(-t // 128) * -(-f // 128)
    tail = units % sms if units > sms else 0
    gate_splits = min(16, sms // tail, -(-d // 64)) if tail else 1
    if gate_splits < 2:
        tail, gate_splits = 0, 1
    down_units = max(1, -(-t // 128) * -(-d // 256))
    down_splits = max(1, min(8, sms // down_units, -(-f // 64)))
    scratch = max(down_splits * t * d if down_splits > 1 else 0,
                  tail * gate_splits * 2 * 128 * 128)
    return down_splits, tail, gate_splits, scratch


def fused_mlp_cuda(x, w_gate, w_up, w_down):
    """Launch the gate/up and down kernels on PyTorch's current stream.
    The kernels have no backward and write through raw pointers, so a
    call that autograd would have to record raises."""
    if needs_grad(x, w_gate, w_up, w_down):
        raise RuntimeError(
            "fused_mlp kernel has no backward: with a gradient required, "
            "use the plain SwiGLU of repro_torch.models.layers.mlp (it "
            "takes it by itself), or call under torch.no_grad()")
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
    ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), h.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        *plan, scratch = mlp_plan(t, d, f, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        partials = torch.empty((scratch,), dtype=torch.float32,
                               device=x.device)
        code = lib.fused_mlp_bf16(*ptrs, partials.data_ptr(),
                                  out.data_ptr(), t, d, f, *plan, stream)
    else:
        code = lib.fused_mlp_f32(*ptrs, out.data_ptr(), t, d, f, stream)
    build.check(code, "fused_mlp")
    fused_mlp.launches += 1
    return out


def fused_mlp(x, w_gate, w_up, w_down):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernels for CUDA tensors (which raise when a gradient is required:
    the kernel pair has no backward). ``x`` may carry leading batch axes.
    ``fused_mlp.launches`` counts calls that launched the kernel pair."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = fused_mlp_plain(x2, w_gate, w_up, w_down)
    else:
        y = fused_mlp_cuda(x2.contiguous(), w_gate, w_up, w_down)
    return y.reshape(*lead, y.shape[-1])


fused_mlp.launches = 0
