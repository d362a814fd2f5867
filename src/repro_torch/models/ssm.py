"""Mamba2 block — the port of ``repro/models/ssm.py``: SSD (state-space
duality) with the chunked algorithm for a whole sequence, plus the O(1)
recurrent step for decode.

Layout: H SSD heads of P channels (din = H*P), one B/C group, state size N
per head; ``in_proj`` splits as ``[z, x, B, C, dt]``. The sharding hints
of the reference have no counterpart on one card and are gone.

Under a tensor-parallel rank (``core/tp.py``) a block holds ``H / tp``
whole heads: its ``in_proj`` block is ``[z_r | x_r | B | C | dt_r]``, its
conv ``[x_r | B | C]``, its ``A_log``/``D``/``dt_bias``/``gn_scale`` and
``out_proj`` rows the rank's, so the conv and the scan are local and the
head count is read off the block (``A_log``). Two sums a block: the
gated RMSNorm's sum of squares over "model" (``"ssm_norm"``) and the
row-parallel ``out_proj`` partial (``"ssm_out"``). In training the
replicated ``B``/``C`` columns of ``in_proj`` and of the conv get their
gradient summed over "model" (``tp.enter_part``), the norm's sum its
gradient summed too (``tp.norm_sum``); ``mamba_forward(sp=True)`` takes
the rank's sequence slice, gathers the sequence before ``in_proj``
(``tp.region_in``) and reduce-scatters after ``out_proj``. With no rank,
or at tp 1, the arithmetic is the unsharded one.

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

from repro_torch.core import tp
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


def _heads(p) -> int:
    """The block's SSD heads: H, or a rank's H / tp."""
    return p["A_log"].shape[-1]


def _split_in(p, x, cfg):
    """in_proj + split. x:(B,S,d) -> z, xbc:(B,S,din+2N), dt:(B,S,H) of
    the block's heads."""
    din, n = _heads(p) * cfg.ssm_head_dim, cfg.ssm_state
    w = tp.enter_part(p["in_proj"], 2 * din, 2 * n, "ssm_bc")
    zxbcdt = x @ w
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


def _conv_weights(p, din: int, n: int):
    """``conv_w``, ``conv_b``, their ``B``/``C`` channels under
    ``tp.enter_part``."""
    return (tp.enter_part(p["conv_w"], din, 2 * n, "ssm_bc"),
            tp.enter_part(p["conv_b"], din, 2 * n, "ssm_bc"))


def _gate_norm(p, y, z, cfg):
    """rmsnorm(y * silu(z)), silu(z) cast to y's dtype first. On a
    rank's heads the mean of squares is over all ``din`` channels: the
    rank's sum of squares summed over "model" (``"ssm_norm"``)."""
    gate = F.silu(z.float()).to(y.dtype)
    x = y * gate
    if y.shape[-1] == _din(cfg):
        return rmsnorm(x, p["gn_scale"], cfg.norm_eps)
    x32 = x.float()
    ss = tp.norm_sum(torch.sum(x32 * x32, dim=-1, keepdim=True),
                     "ssm_norm")
    inv = torch.rsqrt(ss / _din(cfg) + cfg.norm_eps)
    return (x32 * inv * p["gn_scale"]).to(x.dtype)


def mamba_forward(p, x, cfg, *, return_state: bool = False,
                  sp: bool = False):
    """Full-sequence Mamba2 block. x:(B,S,d) -> (B,S,d) [, cache]. Under
    a rank ``x`` is replicated (``sp``: the rank's sequence slice, and so
    is the output) and the cache the rank's heads."""
    h = _heads(p)
    din, n = h * cfg.ssm_head_dim, cfg.ssm_state
    x = tp.region_in(x, "ssm", seq=sp)
    b, s = x.shape[:2]
    z, xbc, dt = _split_in(p, x, cfg)
    xbc, conv_tail = _causal_conv(xbc, *_conv_weights(p, din, n))
    # views into the conv output: the kernel reads them through strides
    xh = xbc[..., :din].reshape(b, s, h, cfg.ssm_head_dim)
    Bm = xbc[..., din:din + n]
    Cm = xbc[..., din + n:]
    A = -torch.exp(p["A_log"])
    y, hlast = ssd_chunked(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype)
    out = tp.reduce_out(_gate_norm(p, y, z, cfg) @ p["out_proj"], "ssm_out",
                        seq=sp)
    if return_state:
        return out, {"state": hlast, "conv": conv_tail}
    return out


def mamba_step(p, cache, x_t, cfg):
    """One decode token. x_t:(B,1,d), cache {state:(B,H,P,N),
    conv:(B,W-1,C)} of the block's heads. Returns (out (B,1,d), new
    cache) — new tensors; the caller decides where they live."""
    h = _heads(p)
    din, n = h * cfg.ssm_head_dim, cfg.ssm_state
    z, xbc, dt = _split_in(p, x_t, cfg)                   # (B,1,*)
    hist = torch.cat([cache["conv"].float(), xbc.float()], dim=1)  # (B,W,C)
    conv_w, conv_b = _conv_weights(p, din, n)
    y = (hist * conv_w[None]).sum(1, keepdim=True) + conv_b
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
    out = tp.all_reduce(_gate_norm(p, y_t, z, cfg) @ p["out_proj"],
                        "ssm_out")
    return out, {"state": state, "conv": new_conv}


def init_mamba_cache(cfg, batch: int, dtype, device=None) -> dict:
    """Zero state (B, H, P, N) fp32 and conv tail (B, W-1, din + 2N); under
    a live rank of its ``H / tp`` heads: (B, H/tp, P, N) and (B, W-1,
    din/tp + 2N), as the reference's ``cache_pspecs`` splits them by
    head."""
    h, p_, n = tp.ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, p_, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             h * p_ + 2 * n), dtype=dtype,
                            device=device),
    }
