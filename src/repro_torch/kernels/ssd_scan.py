"""Mamba2 SSD chunked scan: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``) and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(body ``_kernel``), which runs the chunk axis as a sequential grid
dimension with the ``(n, p)`` fp32 state in VMEM scratch. Here the scan
runs as the chunk-parallel passes of the SSD algorithm (C·Bᵀ and the
cumulative decay, chunk states, state passing, chunk scan), four launches
over grids of (batch, chunk, head); :func:`pass_grids` gives their sizes.
The design and its bound are in the source's header note.

Contract: x ``(b, s, h, p)``; dt ``(b, s, h)`` fp32; A ``(h,)`` fp32
(negative); B/C ``(b, s, n)``, one group shared by every head. With
``q = min(chunk, s)`` and ``s % q == 0`` (the reference's precondition,
``ssm.py:89``, ``ssd_scan.py:70``; a ``ValueError`` here), returns ``(y,
h_last)``: y ``(b, s, h, p)`` in x's dtype and the final state ``(b, h,
p, n)`` fp32 — ``repro/models/ssm.py::ssd_chunked``'s two results. All
arithmetic is fp32.

:func:`ssd_scan` takes the plain version only for a tensor on the CPU; on
a CUDA tensor it launches the kernel or raises. :func:`kernel_limits`
states on the host the shapes the kernel takes (p <= 64, n <= 128, at
most 128 rows a chunk). The kernel has no
backward: with a gradient required, callers take :func:`ssd_scan_plain`
(``models/ssm.py::ssd_chunked`` does so by itself), as the reference
trains through plain jnp. On a meta tensor the wrapper takes the branch of
the device the tensor stands in for (``kernels/dispatch.py``): for "cuda"
the kernel's checks, outputs and scratch (:func:`scratch_words`),
launching nothing. :func:`cost` is the scan's work, charged on every
launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.fused_mlp import needs_grad


def chunk_rows(s: int, chunk: int) -> int:
    """Rows a chunk, ``min(chunk, s)``; raises unless they divide ``s``."""
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(
            f"ssd_scan: s % min(chunk, s) == 0 is required (the "
            f"reference's precondition), got s={s}, chunk={chunk}")
    return q


#: threads a block and rows (and columns) of a C·Bᵀ tile
#: (``csrc/ssd_scan.cu``)
THREADS, CB_ROWS = 256, 32
#: the largest rows a chunk, state size and channels a head the kernel's
#: register tiles and shared memory are built for (``csrc/ssd_scan.cu``)
MAX_Q, MAX_N, MAX_P = 128, 128, 64


def kernel_limits(dtype, h: int, p: int, n: int, chunk: int) -> Optional[str]:
    """Why the kernel cannot take these heads, or None: the limits its C
    entries check (``csrc/ssd_scan.cu``), stated on the host so that a
    caller (the wrapper, a serving engine on a CUDA device) refuses before
    any launch. ``chunk`` is the rows of a chunk, ``min(ssm_chunk, s)``;
    an engine passes ``ssm_chunk``, which every prompt longer than it
    reaches."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in (torch.float32, torch.bfloat16):
        return f"takes float32 or bfloat16, not {dtype}"
    if h < 1:
        return f"needs at least one head, not {h}"
    if not 1 <= p <= MAX_P:
        return f"takes 1..{MAX_P} channels a head (ssm_head_dim), not {p}"
    if not 1 <= n <= MAX_N:
        return f"takes state sizes 1..{MAX_N} (ssm_state), not {n}"
    if not 1 <= chunk <= MAX_Q:
        return f"takes chunks of 1..{MAX_Q} rows (ssm_chunk), not {chunk}"
    return None


def pass_grids(b: int, s: int, h: int, p: int, n: int, chunk: int) -> dict:
    """Blocks of each of the kernel's four launches: C·Bᵀ tiles (b x
    chunks x 32 x 32 tiles, those past the diagonal exiting at once), chunk
    states and the chunk scan (b x chunks x heads each), state passing (b x
    heads x state elements / (4 x THREADS))."""
    q = chunk_rows(s, chunk)
    nc = s // q
    return {"prep": b * nc * (-(-q // CB_ROWS)) ** 2, "state": b * nc * h,
            "pass": b * h * -(-(p * n) // (4 * THREADS)),
            "chunk_scan": b * nc * h}


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128):
    """The port of ``repro/models/ssm.py::ssd_chunked``: the intra-chunk
    masked-decay product, the chunk states, the inter-chunk state scan
    and the carried-state term, in fp32. Differentiable."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk_rows(s, chunk)
    nc = s // q
    dt = dt.float()
    x_dt = x.float() * dt[..., None]                       # absorb dt into x
    cum = torch.cumsum((dt * A.float()[None, None, :]).reshape(b, nc, q, h),
                       dim=2)                              # (b,nc,q,h)
    xc = x_dt.reshape(b, nc, q, h, p)
    bc = B.float().reshape(b, nc, q, n)
    cc = C.float().reshape(b, nc, q, n)
    # intra-chunk: att[b,c,i,j,h] = (C_i . B_j) exp(cum_i - cum_j), i >= j
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,i,j,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    dec = dec.masked_fill(~mask[None, None, :, :, None], float("-inf"))
    att = scores[..., None] * torch.exp(dec)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)
    # chunk states: S_c[h,p,n] = sum_j exp(cum_last - cum_j) B_j x_j
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)           # (b,nc,q,h)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bc, dec_end, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (b,nc,h)
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)
        hstate = chunk_decay[:, c, :, None, None] * hstate + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                    # (b,nc,h,p,n)
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc, hprevs)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), hstate


def scratch_words(b: int, s: int, h: int, p: int, n: int, q: int) -> int:
    """fp32 words of scratch the kernel needs at (b, s, h, p, n, q), at
    least 1: the C entry's ``scratch_layout`` (``csrc/ssd_scan.cu``), C·Bᵀ
    (b, nc, q, q), the cumulative decay (b, s, h) and the chunk states (b,
    nc, h, p, n). :func:`c_scratch_words` asks the built library; the
    card's tests hold the two equal."""
    nc = s // q
    return max(b * nc * q * q + b * s * h + b * nc * h * p * n, 1)


def c_scratch_words(lib, *shape) -> int:
    """:func:`scratch_words` as the C entry ``ssd_scan_scratch`` gives it."""
    size = (ctypes.c_longlong * 1)()
    lib.ssd_scan_scratch(*shape, size)
    return max(size[0], 1)


def cost(b: int, s: int, h: int, p: int, n: int, *, chunk: int = 128,
         esize: int = 2):
    """(flops, bytes) of one scan: x and y, B and C (``esize`` bytes an
    element), dt, A and the final state (fp32) each read or written once;
    C·Bᵀ once a chunk, and per head the intra-chunk y over the causal
    (i, j) pairs of a chunk, the inter-chunk y and the chunk state."""
    q = chunk_rows(s, chunk)
    nc = s // q
    pairs = q * (q + 1) // 2
    nbytes = (esize * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h + b * h * p * n))
    flops = 2.0 * b * nc * (pairs * n + h * (pairs * p + 2 * q * n * p))
    return flops, nbytes


def launch_entry(x, dt, A, B, C, y, h_last, *, q: int) -> int:
    """Call the C entry of x's dtype on these tensors (with the scratch
    made here) and return its code: 0, or the CUDA error it refused with
    (nothing launched then). No check on this side: the wrapper checks
    ``kernel_limits`` first, and the card's tests call this past them to
    hold the table to the C entry."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    lib = build.load("ssd_scan")
    # C·Bᵀ, the cumulative decay and the chunk states (csrc/ssd_scan.cu)
    scratch = torch.empty(scratch_words(b, s, h, p, n, q),
                          dtype=torch.float32, device=x.device)
    fn = lib.ssd_scan_bf16 if x.dtype == torch.bfloat16 else lib.ssd_scan_f32
    return fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), y.data_ptr(), h_last.data_ptr(),
              scratch.data_ptr(), b, s, h, p, n,
              q, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
              B.stride(0), B.stride(1), C.stride(0), C.stride(1),
              torch.cuda.current_stream(x.device).cuda_stream)


def ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 128):
    """Launch the CUDA kernel on PyTorch's current stream. x, B and C are
    read in place through their strides (x may be a view of the conv
    output); y and the final state are new contiguous tensors."""
    if needs_grad(x, dt, A, B, C):
        raise RuntimeError(
            "ssd_scan kernel has no backward: with a gradient required, "
            "use ssd_scan_plain (repro_torch.models.ssm.ssd_chunked takes "
            "it by itself), or call under torch.no_grad()")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) \
            or C.shape != (b, s, n):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            B.dtype != x.dtype or C.dtype != x.dtype or \
            dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(
            f"ssd_scan kernel takes float32 or bfloat16 x, B, C of one "
            f"dtype and float32 dt, A; got x {x.dtype}, B {B.dtype}, C "
            f"{C.dtype}, dt {dt.dtype}, A {A.dtype}")
    for a in (x, dt, A, B, C):
        if not dispatch.on_card(a):
            raise ValueError("ssd_scan kernel takes CUDA tensors")
    if x.stride(3) != 1 or x.stride(2) != p or dt.stride(2) != 1 or \
            B.stride(2) != 1 or C.stride(2) != 1 or not A.is_contiguous():
        raise ValueError(
            "ssd_scan kernel reads x with channel stride 1 and head stride "
            "p, and dt, B, C with unit stride along their last axis")
    q = chunk_rows(s, chunk)
    why = kernel_limits(x.dtype, h, p, n, q)
    if why:
        raise ValueError(f"ssd_scan kernel {why}")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    words = scratch_words(b, s, h, p, n, q)
    if x.is_meta:                     # launch_entry's allocation only
        torch.empty(words, dtype=torch.float32, device=x.device)
    else:
        # the C entry checks the same limits, and its grids' sizes
        # (csrc/ssd_scan.cu)
        build.check(launch_entry(x, dt, A, B, C, y, h_last, q=q),
                    f"ssd_scan at h={h} p={p} n={n} q={q}")
        ssd_scan.launches += 1
    dispatch.charge("ssd_scan", cost(b, s, h, p, n, chunk=q,
                                     esize=x.element_size()), 4 * words)
    return y, h_last


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (which raises when a gradient is required).
    ``ssd_scan.launches`` counts calls that launched the kernel. A meta
    tensor takes the branch of the device it stands in for."""
    if not dispatch.on_card(x):
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)


ssd_scan.launches = 0
