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
that are multiples of 8 (TMA's 16-byte row strides): ``kernel_limits``
states it, and the wrapper raises ``ValueError`` otherwise. On a meta
tensor the wrapper takes the branch of the device the tensor stands in
for (``kernels/dispatch.py``): for "cuda" the kernels' checks, output and
scratch (:func:`buffers`, on :data:`H100_SMS` SMs), launching nothing.
:func:`cost` is the pair's work, charged on every launch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, dispatch

#: SMs of an H100 SXM: the split plan of a meta stand-in for the card
H100_SMS = 132


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


def cost(t: int, d: int, f: int, *, esize: int = 2):
    """(flops, bytes) of one call: the three GEMMs (``6·T·d·f``), x read
    and the output written once, each weight read once (``esize`` bytes
    an element). ``h`` stays in L2 at the serving batch and is scratch,
    not counted (:func:`buffers` sizes it)."""
    return 6.0 * t * d * f, esize * (3 * d * f + 2 * t * d)


def buffers(x, w_down, f: int):
    """The wrapper's scratch for ``x`` (T, d): ``h`` (T, f) in Wd's dtype
    and, for bf16, the split plan and its fp32 partials on the device's
    SMs (:data:`H100_SMS` for a meta stand-in). Returns ``(h, partials,
    plan)``; ``partials`` and ``plan`` None for fp32."""
    t, d = x.shape
    h = torch.empty((t, f), dtype=w_down.dtype, device=x.device)
    if x.dtype != torch.bfloat16:
        return h, None, None
    *plan, scratch = mlp_plan(t, d, f, _sms(x))
    partials = torch.empty((scratch,), dtype=torch.float32, device=x.device)
    return h, partials, plan


def _sms(x) -> int:
    return H100_SMS if x.is_meta else torch.cuda.get_device_properties(
        x.device).multi_processor_count


def scratch_bytes(x, w_down, f: int) -> int:
    """Bytes of :func:`buffers`' scratch, allocating nothing."""
    t, d = x.shape
    out = t * f * w_down.element_size()
    if x.dtype == torch.bfloat16:
        out += 4 * mlp_plan(t, d, f, _sms(x))[-1]
    return out


def kernel_limits(dtype, d: int, f: int) -> Optional[str]:
    """Why the kernels cannot take these widths, or None: the limits the C
    entries check (``csrc/fused_mlp.cu`` header), stated on the host so
    that a caller (the wrapper, the serving engine on a CUDA device)
    refuses before any launch."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in (torch.float32, torch.bfloat16):
        return f"takes float32 or bfloat16, not {dtype}"
    if dtype == torch.bfloat16 and (d % 8 or f % 8 or d < 8 or f < 8):
        return f"takes bfloat16 widths d and f that are multiples of 8 " \
               f"(TMA's 16-byte rows), not d={d}, f={f}"
    return None


def launch_entry(x, w_gate, w_up, w_down, out) -> int:
    """Call the C entry of x's dtype on these tensors (with ``h`` and the
    bf16 split-K scratch made here) and return its code: 0, or the CUDA
    error it refused with (nothing launched then). No check on this
    side: the wrapper checks ``kernel_limits`` first, and the card's
    tests call this past them to hold the table to the C entries."""
    t, d = x.shape
    f = w_gate.shape[1]
    h, partials, plan = buffers(x, w_down, f)
    lib = build.load("fused_mlp")
    ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), h.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        return lib.fused_mlp_bf16(*ptrs, partials.data_ptr(),
                                  out.data_ptr(), t, d, f, *plan, stream)
    return lib.fused_mlp_f32(*ptrs, out.data_ptr(), t, d, f, stream)


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
        if not dispatch.on_card(a) or not a.is_contiguous():
            raise ValueError("fused_mlp kernel takes contiguous CUDA "
                             "tensors")
    why = kernel_limits(x.dtype, d, f)
    if why:
        raise ValueError(f"fused_mlp kernel {why}")
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    if x.is_meta:
        buffers(x, w_down, f)         # launch_entry's allocations only
    else:
        # the C entry checks the same limits (csrc/fused_mlp.cu)
        build.check(launch_entry(x, w_gate, w_up, w_down, out), "fused_mlp")
        fused_mlp.launches += 1
    dispatch.charge("fused_mlp", cost(t, d, f, esize=x.element_size()),
                    scratch_bytes(x, w_down, f))
    return out


def fused_mlp(x, w_gate, w_up, w_down):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernels for CUDA tensors and meta ones standing in for them (which
    raise when a gradient is required:
    the kernel pair has no backward). ``x`` may carry leading batch axes.
    ``fused_mlp.launches`` counts calls that launched the kernel pair."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not dispatch.on_card(x):
        y = fused_mlp_plain(x2, w_gate, w_up, w_down)
    else:
        y = fused_mlp_cuda(x2.contiguous(), w_gate, w_up, w_down)
    return y.reshape(*lead, y.shape[-1])


fused_mlp.launches = 0
