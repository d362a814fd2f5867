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

Under a tensor-parallel mesh (``core/tp.py``) the MoE splits over the
"model" axis in one of the table's two ways (reference ``moe.py:8-12``,
``core/strategy.py:56-57``), which ``moe_ffn`` tells apart by the shape
of the rank's expert stack (``_layout``):

* experts over "model" (``Strategy(expert_parallel=True)``, the
  default): a rank holds ``E / tp`` whole experts of ``w_gate`` /
  ``w_up`` / ``w_down`` and the whole router. The activations are the
  same on every rank, so every rank routes every token as above; it
  fills only its own experts' ``(E / tp, C, d)`` buffer (the same
  capacity ``C``), runs the three products on it, gathers the kept slots
  whose expert is its own (zeros elsewhere) and one all-reduce
  (``"moe_out"``) sums the ``(T k, d)`` slots before the gate-weighted
  sum over k. Each kept slot has exactly one rank that writes it, so the
  sum adds only zeros: the output is the unsharded one bit for bit, and
  the k-sum runs in the unsharded order. The reference's all-to-all has
  no counterpart: gloo has none on CUDA tensors, and every rank already
  holds every token.
* TP inside each expert (``expert_parallel=False``: ``d_ff_moe`` over
  "model"): a rank holds every expert, ``d_ff / tp`` columns of each
  expert's ``w_gate`` / ``w_up`` and the same rows of its ``w_down``
  (Megatron's MLP split, expert by expert). Every rank routes every
  token and fills the whole ``(E, C, d)`` buffer; its products give a
  partial of each slot's output over f, and one sum of the
  gate-weighted ``(T, d)`` output after the k-sum (``"moe_out"``: an
  all-reduce, or under sequence parallelism the reduce-scatter to the
  rank's slice) completes it: k times fewer bytes than the slots' sum,
  equal to the unsharded output up to the order of the f sum. The
  reference constrains the expert activation to ``("experts",
  "moe_cap", None)`` (``moe.py:92``), so GSPMD regathers it over f
  before ``w_down``; the port runs the Megatron form instead.

A rank holding all ``E`` experts at the full ``d_ff`` (the table keeps
them whole where ``E`` does not divide tp) computes the unsharded FFN
and reduces nothing.

In training the rank's share takes its input through ``tp.enter``
(``"moe_in"``: the gradient of the replicated tokens summed over
"model"; the router, which every rank runs on every token, takes it as
it is), and the ``moe_out`` sum's backward is the identity. Split inside
each expert, a rank's output is ``sum_k gate_k * y_k`` over its partial
``y_k``, so each gate's gradient on a rank is a partial too: the gates
enter through ``tp.enter`` (``"moe_gate"``, one (T k,) sum a layer),
while the aux loss's path to the router (the probabilities), complete on
every rank, is not summed. Experts over "model" need no gate sum: there
the gates multiply the summed slots. So a layer's labels are
``moe_out`` (and ``moe_seq``, the gather before routing, under SP)
forward, and ``moe_in.grad`` backward, with ``moe_gate.grad`` inside
each expert and, under SP, the gather of the output's gradient
(``moe_out.grad`` inside each expert, ``moe_seq.grad`` with experts over
"model").
On rows split over "data" every data rank routes its tokens as part of
the global batch the reference routes: the capacity of all of its
tokens, each slot offset by the entries of the earlier data ranks, and
the aux loss from the global means (``_global_route``). The reference
lays the ``(E, C, d)`` buffer out as ``("experts", "moe_cap", None)``
with ``moe_cap`` over the data-parallel axis, so each data rank computes
the expert products of its ``C / batch_dp`` slots only (the capacity
padded to a multiple of ``batch_dp``, as GSPMD pads). The port does the
same with two exchanges of fixed shape over "pod" x "data": the
dispatch buffer, where each data rank filled only its own entries'
slots, reduce-scattered along C (``"moe_cap"``: one writer a slot, so
the sum adds zeros only), and the products' ``(n, C / batch_dp, d)``
slices gathered back by a zero-filled sum (``"moe_cap_out"``) before
each rank takes its entries' slots. Every sum adds zeros only, so the
output and the k-sum's order are those of the whole buffer; backward,
the gather's gradient is summed and sliced, the scatter's gathered.

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

from repro_torch.core import tp

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


def _route(router_w, x, cfg):
    """x: (T, d) -> gates (T, k) fp32, expert ids (T, k) int64 and the
    router's probabilities (T, E) fp32."""
    probs = torch.softmax(_fp32_matmul(x.float(), router_w), dim=-1)
    k = cfg.experts_per_token
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], order[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def router_topk(router_w, x, cfg) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """x: (T, d) -> gates (T, k) fp32, expert ids (T, k) int64, and the
    Shazeer load-balance loss ``E * sum_e mean_prob_e * frac_e``."""
    gates, idx, probs = _route(router_w, x, cfg)
    e = cfg.num_experts
    me = probs.mean(0)                                   # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.full((idx.numel(),), 1.0 / idx.numel(),
                                       dtype=torch.float32,
                                       device=x.device))
    aux = e * torch.sum(me * ce)
    return gates, idx, aux


def expert_counts(idx, cfg):
    """(E,) entries of ``idx`` that chose each expert (a scatter-add, not
    ``bincount``: that reads the largest id back to the host, a sync in
    every layer of a serving step)."""
    flat_e = idx.reshape(-1)
    return torch.zeros((cfg.num_experts,), dtype=flat_e.dtype,
                       device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def dispatch(idx, cfg, cap: int, offset=None):
    """Each (token, choice) entry's row in the ``(E * cap, d)`` dispatch
    buffer, flattened token-major, and whether it fits its expert's
    capacity. A dropped entry points at row 0 (its source is zeroed).
    An entry's slot is the number of entries before it, in token-major
    order, that chose the same expert: its rank within a stable sort by
    expert id, less the entries of the experts before; ``offset`` (E,)
    adds the entries that came before these tokens (the earlier data
    ranks' rows of a batch routed together)."""
    flat_e = idx.reshape(-1)                              # (T*k,)
    order = torch.sort(flat_e, stable=True).indices
    counts = expert_counts(idx, cfg)
    first = torch.cumsum(counts, dim=0) - counts          # (E,)
    rank = torch.arange(flat_e.numel(), device=flat_e.device) \
        - first[flat_e[order]]
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    if offset is not None:
        pos = pos + offset[flat_e]
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos, torch.zeros_like(pos))
    return dest, keep


def _global_route(router_w, x, cfg, r, t_all: int, cap: int):
    """Routing of this data rank's tokens as part of the batch all data
    ranks route together (the reference routes the global batch): each
    entry's slot offset by the entries the earlier data ranks sent to its
    expert, and this rank's share of the aux loss — the global
    ``E * sum_e me_e * ce_e`` with ``me`` summed over this rank's tokens
    only, so the data ranks' shares sum to it once. One zero-filled (dp,
    E) sum of the expert counts over the data-parallel axis, "pod" x
    "data" (``"moe_counts"``)."""
    gates, idx, probs = _route(router_w, x, cfg)
    counts = tp.data_assemble(expert_counts(idx, cfg), "moe_counts")
    offset = counts[:r.batch_rank].sum(0)
    dest, keep = dispatch(idx, cfg, cap, offset=offset)
    me = probs.sum(0) / t_all
    ce = counts.sum(0).float() / (t_all * cfg.experts_per_token)
    aux = cfg.num_experts * torch.sum(me * ce)
    return gates, idx, aux, dest, keep


def _layout(p, cfg) -> Tuple[int, int, bool]:
    """(first expert, experts, f split) of the expert stack this rank
    holds of ``p``, read from its shape: ``E`` experts at the full
    ``d_ff`` (unsharded, or where the table keeps the stack whole);
    ``E / tp`` of them (experts over "model"); or all ``E`` at ``d_ff /
    tp`` (TP inside each expert). Under FSDP the leaves reach here
    already gathered over "data", so the block is the "model" one."""
    n, f = p["w_up"].shape[-3], p["w_up"].shape[-1]
    e = cfg.num_experts
    if n == e and f == cfg.d_ff:
        return 0, n, False
    r = tp.current()
    if r is not None and n * r.tp == e and f == cfg.d_ff:
        return r.rank * n, n, False
    if r is not None and n == e and f * r.tp == cfg.d_ff:
        return 0, n, True
    raise ValueError(f"{cfg.name}: an expert stack of {n} of {e} experts "
                     f"at d_ff {f} of {cfg.d_ff} needs the rank that holds "
                     "it current (core/tp.py::active)")


def moe_ffn(p, x, cfg, *, sp: bool = False):
    """x: (B, S, d) -> (B, S, d), aux loss (fp32 scalar). Capacity is that
    of the B * S tokens together: rows share every expert's budget. Under a
    mesh, a rank's slice of the experts or of each expert's d_ff (see the
    module docstring); in training on rows split over "data", the
    capacity and the slots of the batch all data ranks hold
    (``_global_route``), of which the rank computes its ``C / batch_dp``
    slots of each expert; ``sp``: ``x`` is the rank's sequence slice,
    gathered before routing, and so is the output."""
    if sp:
        x = tp.seq_gather(x, "moe_seq")
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    k = cfg.experts_per_token
    first, n_local, f_split = _layout(p, cfg)
    split = n_local < cfg.num_experts
    rows = tp.data_rows()
    t_all = t * rows.batch_dp if rows is not None else t
    cap = capacity(t_all, cfg)
    with record_function("moe_route"):
        if rows is None:
            gates, idx, aux = router_topk(p["router"], xt, cfg)
            dest, keep = dispatch(idx, cfg, cap)
        else:
            gates, idx, aux, dest, keep = _global_route(
                p["router"], xt, cfg, rows, t_all, cap)
        mine = keep
        if split:
            # this rank's slots: their rows in its (E / tp * C, d) buffer
            mine = keep & (idx.reshape(-1) >= first) \
                & (idx.reshape(-1) < first + n_local)
            dest = torch.where(mine, dest - first * cap,
                               torch.zeros_like(dest))
        if split or f_split:
            xt = tp.enter(xt, "moe_in")
        src = xt.repeat_interleave(k, dim=0)              # (T*k, d)
        src = torch.where(mine[:, None], src, torch.zeros_like(src))
        # kept rows are unique and dropped ones add +0 to row 0: the sums
        # are the reference's scatter-add values exactly
        buf = torch.zeros((n_local * cap, d), dtype=xt.dtype,
                          device=x.device
                          ).index_add(0, dest, src).view(n_local, cap, d)
        if rows is not None:
            # the rank's C / batch_dp slots of each expert (the
            # reference's "moe_cap" layout), the capacity padded to a
            # multiple of batch_dp as GSPMD pads: one writer a slot, so
            # the reduce-scatter adds zeros only
            pad = -cap % rows.batch_dp
            if pad:
                buf = F.pad(buf, (0, 0, 0, pad))
            buf = tp.data_scatter(buf, "moe_cap")
    with record_function("moe_experts"):
        h = torch.bmm(buf, p["w_up"])
        g = torch.bmm(buf, p["w_gate"])
        h = F.silu(g) * h
        y = torch.bmm(h, p["w_down"])
        if rows is not None:
            y = tp.data_gather(y, "moe_cap_out")[:, :cap]
        y = y.reshape(n_local * cap, d)
    with record_function("moe_combine"):
        flat_gate = torch.where(keep, gates.reshape(-1),
                                torch.zeros_like(gates.reshape(-1)))
        if f_split:
            # each slot's y is a partial over f: so is each gate's gradient
            flat_gate = tp.enter(flat_gate, "moe_gate")
        gathered = torch.where(mine[:, None], y.index_select(0, dest),
                               torch.zeros_like(src))
        if split:
            # one writer a kept slot: the sum adds zeros only
            gathered = tp.all_reduce(gathered, "moe_out")
        out = (gathered * flat_gate[:, None].to(gathered.dtype)
               ).reshape(t, k, d).sum(dim=1)
    out = out.reshape(b, s, d)
    if f_split:
        # the partials over f summed once, after the gates
        out = tp.reduce_out(out, "moe_out", seq=sp)
    elif sp:
        out = tp.seq_split(out, "moe_seq")
    return out, aux
