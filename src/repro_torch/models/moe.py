"""Mixture-of-Experts FFN: top-k router + capacity-based dispatch — the
port of ``repro/models/moe.py``.

Dispatch is GShard-style "dropping": each expert has a static capacity
``C = ceil(T * k / E * capacity_factor)`` rounded up to 8 (at least 8);
entries past an expert's capacity are dropped (the residual passes them
through). Routing is the reference's exactly:

* the router runs in fp32 — ``x.float() @ router_w`` with TF32 off on
  the card (:func:`_fp32_matmul`), then an fp32 softmax;
* top-k is a stable descending sort, so among equal probabilities the
  lower expert index comes first, as ``jax.lax.top_k`` puts it;
* each entry's slot within its expert is a running count over the
  token-major flattening of ``(T, k)``, so the earlier token keeps its
  slot when an expert overflows (:func:`dispatch` takes the count by a
  stable sort on the expert id: the same integers as the reference's
  ``cumsum`` over a one-hot, without its (T k, E) scan).

The expert products are plain batched matmuls over the expert axis, as
the reference's einsums are: no Pallas kernel runs here on the TPU, so
no hand kernel runs here on the card (and the fused MLP never does).
The sharding hints (``constrain``) have no counterpart on one card.

``moe_ffn``'s parts run under ``torch.profiler.record_function`` ranges
named by :data:`PARTS` (routing and dispatch, the expert products, the
combine), so a profiled run splits the FFN's device time by them.
"""
from __future__ import annotations

import threading
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

PARTS = ("moe_route", "moe_experts", "moe_combine")

_TF32_LOCK = threading.Lock()


def capacity(num_tokens: int, cfg) -> int:
    """Slots per expert for ``num_tokens`` tokens: the reference's
    expression in the same order, so Python rounds the float alike."""
    c = int(np.ceil(num_tokens * cfg.experts_per_token / cfg.num_experts
                    * cfg.moe_capacity_factor))
    return max(8, -(-c // 8) * 8)


def _fp32_matmul(a, b):
    """``a @ b`` in true fp32: on the card TF32 would round the router's
    inputs to 10 mantissa bits, and near-equal probabilities would pick
    other experts than the reference's."""
    if not a.is_cuda:
        return a @ b
    with _TF32_LOCK:
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was


def router_topk(router_w, x, cfg) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """x: (T, d) -> gates (T, k) fp32, expert ids (T, k) int64, and the
    Shazeer load-balance loss ``E * sum_e mean_prob_e * frac_e``."""
    probs = torch.softmax(_fp32_matmul(x.float(), router_w), dim=-1)
    k, e = cfg.experts_per_token, cfg.num_experts
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], order[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)                                   # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.full((idx.numel(),), 1.0 / idx.numel(),
                                       dtype=torch.float32,
                                       device=x.device))
    aux = e * torch.sum(me * ce)
    return gates, idx, aux


def dispatch(idx, cfg, cap: int):
    """Each (token, choice) entry's row in the ``(E * cap, d)`` dispatch
    buffer, flattened token-major, and whether it fits its expert's
    capacity. A dropped entry points at row 0 (its source is zeroed).
    An entry's slot is the number of entries before it, in token-major
    order, that chose the same expert: its rank within a stable sort by
    expert id, less the entries of the experts before."""
    e = cfg.num_experts
    flat_e = idx.reshape(-1)                              # (T*k,)
    order = torch.sort(flat_e, stable=True).indices
    # a scatter-add, not ``bincount``: that reads the largest id back to
    # the host, a sync in every layer of a serving step
    counts = torch.zeros((e,), dtype=flat_e.dtype, device=flat_e.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(counts, dim=0) - counts          # (E,)
    rank = torch.arange(flat_e.numel(), device=flat_e.device) \
        - first[flat_e[order]]
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos, torch.zeros_like(pos))
    return dest, keep


def moe_ffn(p, x, cfg):
    """x: (B, S, d) -> (B, S, d), aux loss (fp32 scalar). Capacity is that
    of the B * S tokens together: rows share every expert's budget."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = capacity(t, cfg)
    with record_function("moe_route"):
        gates, idx, aux = router_topk(p["router"], xt, cfg)
        dest, keep = dispatch(idx, cfg, cap)
        src = xt.repeat_interleave(k, dim=0)              # (T*k, d)
        src = torch.where(keep[:, None], src, torch.zeros_like(src))
        # kept rows are unique and dropped ones add +0 to row 0: the sums
        # are the reference's scatter-add values exactly
        buf = torch.zeros((e * cap, d), dtype=xt.dtype, device=x.device
                          ).index_add(0, dest, src).view(e, cap, d)
    with record_function("moe_experts"):
        h = torch.bmm(buf, p["w_up"])
        g = torch.bmm(buf, p["w_gate"])
        h = F.silu(g) * h
        y = torch.bmm(h, p["w_down"]).reshape(e * cap, d)
    with record_function("moe_combine"):
        flat_gate = torch.where(keep, gates.reshape(-1),
                                torch.zeros_like(gates.reshape(-1)))
        gathered = torch.where(keep[:, None], y.index_select(0, dest),
                               torch.zeros_like(src))
        out = (gathered * flat_gate[:, None].to(gathered.dtype)
               ).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux
