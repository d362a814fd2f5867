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

On a training rank (``rank``: a ``core/tp.py::Rank`` with its
``leaves``) every function works on the rank's blocks and computes what
the reference computes on the global arrays:

* the gradients handed in are each leaf's UPDATE block
  (``LeafBlocks.update``: under ZeRO-1 the param's block sliced over
  "data", ``core/sharding.py::zero1_spec``), and so is the state — AdamW's
  ``m``/``v``/``master``, Adafactor's ``vr``/``vc`` laid out as
  ``opt_state_pspecs`` lays them out;
* ``clip_by_global_norm`` takes the norm of the global gradient: each
  block's sum of squares summed over the axes that split it (a leaf
  replicated on an axis counted once, and so are the ``B``/``C`` columns
  a Mamba2 block keeps whole on every rank: ``tp.once``);
* each rank updates its block; where the param is not itself split over
  "data", the new param is assembled over "data" by a zero-filled sum
  (``"zero_params"``);
* Adafactor's means cross split dims: the factored row and column
  statistics, the row statistic's mean and the update's RMS are sums
  over the rank's block, summed over the axes that split the dims they
  reduce, over the global count; the stored ``vr``/``vc`` blocks are
  taken from the statistics of the update block (``"adafactor_state"``
  where the two lie differently over "data").
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import tp
from repro_torch.core.pspec import P
from repro_torch.core.sharding import _state_leaf_spec
from repro_torch.tree import flatten, tree_map, unflatten

CHUNK = 1 << 26           # elements per in-place AdamW slice (256 MB fp32)


def cosine_lr(step, *, base_lr: float, warmup: int, total: int,
              min_ratio: float = 0.1):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def _split_axes(spec, rank, dims=None) -> tuple:
    """The mesh axes (of size > 1) that split ``dims`` (default: every
    dim) of a block under ``spec``."""
    entries = tuple(spec)
    dims = range(len(entries)) if dims is None else dims
    out = []
    for d in dims:
        ax = entries[d]
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and rank.axes.get(a, 1) > 1 and a not in out:
                out.append(a)
    return tuple(sorted(out))


def _global_sum(x, spec, rank, dims, what):
    """``x`` (a sum over ``dims`` of a block under ``spec``) summed over
    the axes that split those dims, in place."""
    for a in _split_axes(spec, rank, dims):
        tp.axis_sum(x, a, what, rank)
    return x


def _blocks(rank):
    return rank if rank is not None and rank.leaves else None


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, rank=None):
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm``; returns (grads, norm before clipping). On a training
    ``rank`` the grads are update blocks and the norm the global one:
    one sum a mesh axis over the blocks' squares (``"grad_norm"``)."""
    flat = flatten(grads)
    leaves = list(flat.values())
    if _blocks(rank) is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in leaves))
    else:
        by_axes = {}
        for key, g in flat.items():
            spec = rank.leaves[key].update
            by_axes.setdefault(_split_axes(spec, rank), []).append(
                torch.sum(torch.square(tp.once(g.float(), spec, rank))))
        groups = sorted(by_axes)
        sums = torch.stack([sum(by_axes[a]) for a in groups])
        for axis in ("model", "data"):
            pick = [i for i, a in enumerate(groups) if axis in a]
            if pick:
                part = sums[pick].contiguous()
                tp.axis_sum(part, axis, "grad_norm", rank)
                sums[pick] = part
        gn = torch.sqrt(sums.sum())
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, gn


# ------------------------------------------------------------------- AdamW

def _update_blocks(params, rank):
    """Each param's update block (ZeRO-1) on a training ``rank``."""
    if _blocks(rank) is None:
        return params
    return unflatten({k: tp.zero_block(p.detach(), rank.leaves[k], rank)
                      for k, p in flatten(params).items()})


def _assemble_param(p, new, lb, rank):
    """Write the update block ``new`` into the param block ``p``; where
    the block is a ZeRO-1 slice, the whole param block by a zero-filled
    sum over "data"."""
    if lb is None or lb.zero_dim is None:
        p.copy_(new)
        return
    n = p.shape[lb.zero_dim] // rank.dp
    tp.fill_sum(new, p.shape, tp.slice_at(lb.zero_dim, rank.data_rank, n),
                rank, "data", "zero_params", out=p)


def adamw_init(params, rank=None):
    """m, v (zeros) and the fp32 master of ``params`` — of each leaf's
    update block on a training ``rank``."""
    blocks = _update_blocks(params, rank)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, blocks), "v": tree_map(zeros, blocks),
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), blocks),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(flatten(params).values()))
                                .device)}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, rank=None):
    step = state["step"] + 1
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    flat_m, flat_v = flatten(state["m"]), flatten(state["v"])
    flat_w, flat_p = flatten(state["master"]), flatten(params)
    for key, g in flatten(grads).items():
        lb = None if _blocks(rank) is None else rank.leaves[key]
        zero = lb is not None and lb.zero_dim is not None
        parts = [a.reshape(-1).split(CHUNK)
                 for a in (g, flat_m[key], flat_v[key], flat_w[key])
                 + (() if zero else (flat_p[key],))]
        for g_, m, v, w, *p in zip(*parts):
            g32 = g_.float()
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            w.sub_(upd.add_(w, alpha=weight_decay).mul_(lr))
            if p:
                p[0].copy_(w)
        if zero:
            _assemble_param(flat_p[key], flat_w[key], lb, rank)
    return params, {"m": state["m"], "v": state["v"],
                    "master": state["master"], "step": step}


# --------------------------------------------------------------- Adafactor

def _factored_dims(shape):
    """Last two non-trivial dims, if the tensor is big enough to factor."""
    if len(shape) < 2 or shape[-1] < 2 or shape[-2] < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def _state_specs(lb, rank):
    """(vr spec, vc spec) of a leaf's Adafactor state blocks
    (``core/sharding.py::_state_leaf_spec`` from the rank's param spec,
    ZeRO-1 over "data" when the rank's strategy asks for it)."""
    shape = lb.shape
    if _factored_dims(shape) is None:
        return lb.update, P()
    return tuple(_state_leaf_spec(tp.Shape(sshape), tp.Shape(shape), lb.spec,
                                  rank.axes, rank.zero1)
                 for sshape in (shape[:-1], shape[:-2] + shape[-1:]))


def adafactor_init(params, rank=None):
    """Parallel vr/vc trees (full-rank v lives in vr with a dummy vc) so
    every tree in the update has the same keys as ``params`` — on a
    training ``rank`` each the block its spec gives this rank."""
    if _blocks(rank) is not None:
        dev = next(iter(flatten(params).values())).device
        vr, vc = {}, {}
        for key in flatten(params):
            lb = rank.leaves[key]
            rs, cs = _state_specs(lb, rank)
            shape = lb.shape
            if _factored_dims(shape) is None:
                vr[key] = torch.zeros(tp.local_shape(shape, rs, rank.axes),
                                      dtype=torch.float32, device=dev)
                vc[key] = torch.zeros((), dtype=torch.float32, device=dev)
                continue
            for out, sshape, spec in ((vr, shape[:-1], rs),
                                      (vc, shape[:-2] + shape[-1:], cs)):
                out[key] = torch.zeros(tp.local_shape(sshape, spec, rank.axes),
                                       dtype=torch.float32, device=dev)
        return {"vr": unflatten(vr), "vc": unflatten(vc),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

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


def _reblock(x, have, want, rank):
    """A block of one tensor under spec ``have`` as its block under
    ``want``: each axis that splits a dim in ``have`` but not in ``want``
    assembled by a zero-filled sum, then each that splits a dim in
    ``want`` only sliced (``"adafactor_state"``)."""
    have, want = tuple(have), tuple(want)
    if have == want:
        return x
    gather = P(*(a if a is not None and a != w else None
                 for a, w in zip(have, want)))
    x = tp.assemble(x, gather, "adafactor_state", rank)
    for dim, (a, w) in enumerate(zip(have, want)):
        if w is not None and w != a:
            n = x.shape[dim] // rank.axes.get(w, 1)
            x = x.narrow(dim, tp.axis_index(rank, w) * n, n)
    return x


@torch.no_grad()
def _adafactor_blocks(grads, state, params, rank, *, lr, beta, eps,
                      clip_threshold, weight_decay):
    """Adafactor on a training rank's update blocks (module docstring)."""
    flat_r, flat_c = flatten(state["vr"]), flatten(state["vc"])
    flat_p = flatten(params)
    for key, g in flatten(grads).items():
        lb = rank.leaves[key]
        shape, u_spec = lb.shape, tuple(lb.update)
        vr, vc, p = flat_r[key], flat_c[key], flat_p[key]
        rs, cs = _state_specs(lb, rank)
        g = g.float()
        g2 = g * g + eps
        nd = len(shape)
        if _factored_dims(shape) is not None:
            rows_spec, cols_spec = u_spec[:-1], u_spec[:-2] + u_spec[-1:]
            row = _global_sum(tp.once(g2, u_spec, rank).sum(-1), u_spec,
                              rank, [nd - 1], "adafactor_stats") / shape[-1]
            col = _global_sum(g2.sum(-2), u_spec, rank, [nd - 2],
                              "adafactor_stats") / shape[-2]
            vr_new = beta * _reblock(vr, rs, rows_spec, rank) \
                + (1 - beta) * row
            vc_new = beta * _reblock(vc, cs, cols_spec, rank) \
                + (1 - beta) * col
            mean = _global_sum(vr_new.sum(-1), u_spec, rank, [nd - 2],
                               "adafactor_stats") / shape[-2]
            denom = (vr_new[..., None] * vc_new[..., None, :]
                     / torch.clamp(mean[..., None, None], min=eps))
            u = g * torch.rsqrt(denom + eps)
            vr.copy_(_reblock(vr_new, rows_spec, rs, rank))
            vc.copy_(_reblock(vc_new, cols_spec, cs, rank))
        else:
            vr.copy_(beta * vr + (1 - beta) * g2)
            u = g * torch.rsqrt(vr + eps)
        ss = _global_sum(torch.sum(tp.once(u * u, u_spec, rank)).reshape(1),
                         u_spec, rank, None, "adafactor_stats")[0]
        rms_u = torch.sqrt(ss / math.prod(shape) + eps)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        p32 = tp.zero_block(p, lb, rank).float()
        _assemble_param(p, p32 - lr * u - lr * weight_decay * p32, lb,
                        rank)


@torch.no_grad()
def adafactor_update(grads, state, params, *, lr, decay=0.8, eps=1e-30,
                     clip_threshold=1.0, weight_decay=0.0, rank=None):
    step = state["step"] + 1
    t = step.float()
    beta = 1.0 - t ** (-decay)
    if _blocks(rank) is not None:
        _adafactor_blocks(grads, state, params, rank, lr=lr, beta=beta,
                          eps=eps, clip_threshold=clip_threshold,
                          weight_decay=weight_decay)
        return params, {"vr": state["vr"], "vc": state["vc"], "step": step}
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
