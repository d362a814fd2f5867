"""Mamba2 block — the port of ``repro/models/ssm.py``: SSD (state-space
duality) with the chunked algorithm for a whole sequence, plus the O(1)
recurrent step for decode.

Layout: H SSD heads of P channels (din = H*P), one B/C group, state size N
per head; ``in_proj`` splits as ``[z, x, B, C, dt]``. The sharding hints
of the reference have no counterpart on one card and are gone.

``ssd_chunked`` is where the Pallas TPU kernel's function runs on the
card: a CUDA tensor goes to the hand-written SSD kernel (``kernels/
ssd_scan.py``) when no gradient is required (serving's prefill); with a
gradient required it is the plain chunked version, as the reference trains
through plain jnp; a CPU tensor takes the plain version. The reference's
numerics are kept: softplus is ``logaddexp(x, 0)`` (``jax.nn.softplus``),
the causal conv sums its W shifted products in order before adding the
bias, and the gated rmsnorm casts ``silu(z)`` to y's dtype first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_mlp import needs_grad
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.layers import rmsnorm


def _din(cfg) -> int:
    return cfg.ssm_heads * cfg.ssm_head_dim


def conv_channels(cfg) -> int:
    return _din(cfg) + 2 * cfg.ssm_state


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _split_in(p, x, cfg):
    """in_proj + split. x:(B,S,d) -> z, xbc:(B,S,din+2N), dt:(B,S,H)."""
    din, n = _din(cfg), cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * n]
    dt_raw = zxbcdt[..., 2 * din + 2 * n:].float()
    return z, xbc, softplus(dt_raw + p["dt_bias"])


def _causal_conv(xbc, conv_w, conv_b, *, init_state=None):
    """Depthwise causal conv (width W) over (B,S,C). Returns y, final
    tail (B,W-1,C), both in xbc's dtype."""
    w = conv_w.shape[0]
    s = xbc.shape[1]
    x32 = xbc.float()
    if init_state is None:
        pad = torch.zeros((x32.shape[0], w - 1, x32.shape[2]),
                          dtype=torch.float32, device=xbc.device)
    else:
        pad = init_state.float()
    xp = torch.cat([pad, x32], dim=1)
    y = xp[:, 0:s] * conv_w[0]
    for i in range(1, w):
        y = y + xp[:, i:i + s] * conv_w[i]
    y = y + conv_b
    tail = xp[:, xp.shape[1] - (w - 1):] if w > 1 else xp[:, :0]
    return F.silu(y).to(xbc.dtype), tail.to(xbc.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, *, chunk: int):
    """Chunked SSD. xh:(B,S,H,P) dt:(B,S,H) A:(H,) Bm,Cm:(B,S,N).
    Returns y:(B,S,H,P) in xh's dtype and the final state (B,H,P,N) fp32.
    Raises ``ValueError`` unless ``S % min(chunk, S) == 0``."""
    if needs_grad(xh, dt, A, Bm, Cm):
        return ssd_scan_plain(xh, dt, A, Bm, Cm, chunk=chunk)
    return ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)


def _gate_norm(p, y, z, cfg):
    """rmsnorm(y * silu(z)), silu(z) cast to y's dtype first."""
    gate = F.silu(z.float()).to(y.dtype)
    return rmsnorm(y * gate, p["gn_scale"], cfg.norm_eps)


def mamba_forward(p, x, cfg, *, return_state: bool = False):
    """Full-sequence Mamba2 block. x:(B,S,d) -> (B,S,d) [, cache]."""
    din, n, h = _din(cfg), cfg.ssm_state, cfg.ssm_heads
    b, s = x.shape[:2]
    z, xbc, dt = _split_in(p, x, cfg)
    xbc, conv_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    # views into the conv output: the kernel reads them through strides
    xh = xbc[..., :din].reshape(b, s, h, cfg.ssm_head_dim)
    Bm = xbc[..., din:din + n]
    Cm = xbc[..., din + n:]
    A = -torch.exp(p["A_log"])
    y, hlast = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype)
    out = _gate_norm(p, y, z, cfg) @ p["out_proj"]
    if return_state:
        return out, {"state": hlast, "conv": conv_tail}
    return out


def mamba_step(p, cache, x_t, cfg):
    """One decode token. x_t:(B,1,d), cache {state:(B,H,P,N),
    conv:(B,W-1,C)}. Returns (out (B,1,d), new cache) — new tensors; the
    caller decides where they live."""
    din, n, h = _din(cfg), cfg.ssm_state, cfg.ssm_heads
    z, xbc, dt = _split_in(p, x_t, cfg)                   # (B,1,*)
    hist = torch.cat([cache["conv"].float(), xbc.float()], dim=1)  # (B,W,C)
    y = (hist * p["conv_w"][None]).sum(1, keepdim=True) + p["conv_b"]
    xbc_c = F.silu(y).to(xbc.dtype)
    new_conv = hist[:, 1:].to(xbc.dtype)

    xh = xbc_c[..., :din].reshape(-1, h, cfg.ssm_head_dim)       # (B,H,P)
    Bm = xbc_c[:, 0, din:din + n]                                # (B,N)
    Cm = xbc_c[:, 0, din + n:]
    A = -torch.exp(p["A_log"])
    dt0 = dt[:, 0]                                               # (B,H)
    a = torch.exp(dt0 * A[None])
    upd = torch.einsum("bh,bn,bhp->bhpn", dt0, Bm.float(), xh.float())
    state = a[:, :, None, None] * cache["state"] + upd
    y_t = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    y_t = y_t + xh.float() * p["D"][None, :, None]
    y_t = y_t.reshape(x_t.shape[0], 1, din).to(x_t.dtype)
    out = _gate_norm(p, y_t, z, cfg) @ p["out_proj"]
    return out, {"state": state, "conv": new_conv}


def init_mamba_cache(cfg, batch: int, dtype, device=None) -> dict:
    h, p_, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, p_, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             conv_channels(cfg)), dtype=dtype,
                            device=device),
    }
