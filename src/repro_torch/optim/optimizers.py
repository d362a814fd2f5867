"""Optimizers by hand on tensors — the port of
``repro/optim/optimizers.py`` (not ``torch.optim``, so the update rule is
the reference's term for term).

* AdamW with fp32 master weights and fp32 m/v (b2 = 0.95, bias
  correction), Megatron-style mixed precision.
* Adafactor: factored second moments over the last two dims, no momentum,
  no master copy.
* global-norm clipping, and a cosine schedule with linear warmup.

The reference is pure (tree in, tree out). Here the state, the params and
the gradients are updated IN PLACE and the same trees are returned: at
Qwen3-14B width with 4 layers a second copy of params and state would be
~52 GB. AdamW walks each leaf in chunks of ``CHUNK`` elements so its fp32
temporaries stay ~1 GB instead of several copies of the 778 M-element
embedding.
"""
from __future__ import annotations

import math

import torch

from repro_torch.tree import flatten, tree_map

CHUNK = 1 << 26           # elements per in-place AdamW slice (256 MB fp32)


def cosine_lr(step, *, base_lr: float, warmup: int, total: int,
              min_ratio: float = 0.1):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm``; returns (grads, norm before clipping)."""
    leaves = list(flatten(grads).values())
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, gn


# ------------------------------------------------------------------- AdamW

def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(flatten(params).values()))
                                .device)}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    step = state["step"] + 1
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    flat_m, flat_v = flatten(state["m"]), flatten(state["v"])
    flat_w, flat_p = flatten(state["master"]), flatten(params)
    for key, g in flatten(grads).items():
        parts = [a.reshape(-1).split(CHUNK)
                 for a in (g, flat_m[key], flat_v[key], flat_w[key],
                           flat_p[key])]
        for g_, m, v, w, p in zip(*parts):
            g32 = g_.float()
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            w.sub_(upd.add_(w, alpha=weight_decay).mul_(lr))
            p.copy_(w)
    return params, {"m": state["m"], "v": state["v"],
                    "master": state["master"], "step": step}


# --------------------------------------------------------------- Adafactor

def _factored_dims(shape):
    """Last two non-trivial dims, if the tensor is big enough to factor."""
    if len(shape) < 2 or shape[-1] < 2 or shape[-2] < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def adafactor_init(params):
    """Parallel vr/vc trees (full-rank v lives in vr with a dummy vc) so
    every tree in the update has the same keys as ``params``."""
    def vr(p):
        shape = p.shape if _factored_dims(p.shape) is None else p.shape[:-1]
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc(p):
        shape = () if _factored_dims(p.shape) is None \
            else p.shape[:-2] + p.shape[-1:]
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(flatten(params).values()))
                                .device)}


@torch.no_grad()
def adafactor_update(grads, state, params, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0):
    step = state["step"] + 1
    t = step.float()
    beta = 1.0 - t ** (-decay)
    flat_r, flat_c = flatten(state["vr"]), flatten(state["vc"])
    flat_p = flatten(params)
    for key, g in flatten(grads).items():
        vr, vc, p = flat_r[key], flat_c[key], flat_p[key]
        g = g.float()
        g2 = g * g + eps
        if _factored_dims(p.shape) is not None:
            vr.copy_(beta * vr + (1 - beta) * g2.mean(-1))
            vc.copy_(beta * vc + (1 - beta) * g2.mean(-2))
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
            u = g * torch.rsqrt(denom + eps)
        else:
            vr.copy_(beta * vr + (1 - beta) * g2)
            u = g * torch.rsqrt(vr + eps)
        rms_u = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        p32 = p.float()
        p.copy_(p32 - lr * u - lr * weight_decay * p32)
    return params, {"vr": state["vr"], "vc": state["vc"], "step": step}


def get_optimizer(name: str):
    return {"adamw": (adamw_init, adamw_update),
            "adafactor": (adafactor_init, adafactor_update)}[name]
