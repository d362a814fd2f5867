"""Tensor, sequence and data parallelism on explicit local shards — one
process a rank.

The reference runs one GSPMD program over the mesh: every parameter is a
global array laid out by ``core/sharding.py``'s specs, and XLA inserts
the collectives. The port follows PyTorch's idiom instead (``torchrun``,
one process a rank): each rank holds only its shard of every leaf, as a
plain contiguous local tensor (``shard_params``), runs the same model
code on it, and calls the collective where GSPMD would have put one
(Megatron §5.1):

* ``all_reduce(x, "attn_out")`` after ``wo`` (row-parallel attention
  out) and ``all_reduce(x, "mlp_out")`` after ``w_down`` (row-parallel
  MLP), one each a layer; in an MoE layer one ``"moe_out"`` instead of
  ``mlp_out``: the ``(T k, d)`` expert slots with the experts split over
  "model", the gate-weighted ``(T, d)`` output with each expert's d_ff
  split (``models/moe.py``);
* ``vocab_embed``: the vocab-parallel lookup, a masked local lookup and
  one sum;
* ``vocab_logits``: the vocab-parallel head's logits assembled to the full
  vocabulary by one sum into a zero-filled buffer where each rank writes
  its slice (exact: only zeros are added);
* ``broadcast_from_root`` for what one rank decides for all (the serving
  engine's sampled tokens and clock);
* ``all_reduce(x, what, op=MAX)`` and the zero-filled sums of
  ``gather_heads`` for the context-parallel decode
  (``models/cp_attention.py``);
* in a Mamba2 block (``models/ssm.py``) ``all_reduce(y, "ssm_out")``
  after ``out_proj`` (row-parallel) and ``norm_sum(ss, "ssm_norm")``, the
  gated RMSNorm's sum of squares over the block's heads: one each a
  layer.

Training differentiates through them (Megatron's conjugate pair, as
``torch.autograd.Function`` classes). Every rank computes the same replicated
loss, and the gradient taken is that of ONE copy of it:

* **g** — the sums above on a tensor that requires grad: a sum forward,
  the gradient as it is backward (``all_reduce``, ``vocab_embed``,
  ``vocab_logits``; serving keeps the in-place, no-grad sum);
* **f** — ``enter``: identity forward, the gradient summed over "model"
  backward, where a replicated tensor is used inside the rank's share of
  the work: the normed ``h`` before ``wq``/``wk``/``wv``, ``w_gate``/
  ``w_up``, the MoE dispatch (and, with each expert's d_ff split, the
  MoE gates), the vocab-parallel head and the enc-dec
  family's cross K/V (``enc_out`` in every decoder layer), and the
  replicated leaves used there (Qwen3's ``q_norm``/``k_norm``, ``wk``/
  ``wv`` kept whole where Hkv does not divide tp; under sequence
  parallelism the norm scales and the VLM's cross-layer gates, used on
  the rank's sequence slice);
* sequence parallelism (Korthikanti): the residual stream between blocks
  is the rank's slice of the sequence. ``seq_gather`` assembles the
  sequence by a zero-filled sum (exact) and hands back the rank's slice
  of the gradient; with ``enter`` after it the pair's backward is the
  reduce-scatter. ``seq_scatter`` is the reduce-scatter — a sum, then the
  rank's slice — whose backward is the zero-filled gather, and
  ``seq_split`` takes the slice of a replicated tensor (its backward the
  same gather);
* the "data" axis (``axis_sum``): ZeRO-1's parameter assembly and
  FSDP's gathers (``fsdp_full``, ``layer_sources``: a layer's leaves
  gathered when it is applied, inside the remat checkpoint, the gradient
  summed and sliced back to the rank's block);
* the data-parallel axis :data:`BATCH`, ("pod", "data") as the
  reference's rules put the batch (``core/strategy.py``), "data" alone
  on a mesh without "pod": the batch rows a rank holds
  (``data/pipeline.py::shard_batch``), the loss normaliser, the MoE
  routing of the global batch and the split of each expert's capacity
  (``data_scatter`` / ``data_gather``: each data rank computes its
  ``C / batch_dp`` slots, as the reference's ``moe_cap`` rule puts them)
  and the gradient sums (an FSDP leaf's
  over "data" in its gather's backward, then over "pod"). ZeRO-1's and
  FSDP's blocks stay over "data" alone, as the reference's
  ``zero1_spec(..., axis="data")``: each pod holds the whole state.

Every collective is tallied in ``Rank.counts`` and ``Rank.bytes`` by its
label, and ``Rank.axis_of`` names the axis it ran over; one run in
backward carries the label of its forward with ``.grad`` appended.

Only ``all_reduce`` and ``broadcast`` are used: gloo supports just these
two on CUDA tensors, so the same code runs with gloo on CPU tensors (the
tests), with gloo on CUDA tensors (ranks sharing one card: NCCL refuses
two ranks on one device) and with NCCL (one card a rank). The backend is
the process group's, chosen by the caller; nothing here switches it.

A rank's view (:class:`Rank`) is made from the mesh and the model config
by the caller (the serving engine, the trainer) and made current for a
thread by ``active``; without a current rank, or at tp 1, every "model"
collective here is a no-op and the model code runs unsharded (at dp 1
every "data" one). Attention is split by whole heads only. Where Hq does
not divide by tp (Qwen3-14B's 40 heads over 16), every rank runs ALL the
heads (``Rank.whole_heads``): ``wq``/``wk``/``wv``/``wo`` are whole on
every rank (the table's replicated fallback), the attention regions take
no ``enter`` and their output no sum (``region_in``, ``heads_out``;
under sequence parallelism the rank's slice of the whole output), and
the K/V cache holds every head of whole rows — redundant work on each
rank of "model", never a split head. Where Hkv does not divide by tp (GQA
with fewer KV heads than ranks), every rank keeps all Hkv heads of K/V
(the table's replicated fallback) and attends its query heads against
the one KV head they read (``kv_read``); the table itself would split
``wk``/``wv`` inside a head there (``_divisible`` tests the flattened
``Hkv * D``), which the port never does (``rank_pspecs``).

A Mamba2 block is split by whole SSD heads too (H must divide by tp). Its
``in_proj`` columns are the concatenation ``[z | x | B | C | dt]`` and
its conv channels ``[x | B | C]``; the reference's table splits that flat
axis contiguously (rank 0 would take all of ``z`` and part of ``x``) and
leaves GSPMD to regather. On a rank the dim is laid out by heads instead
(:class:`Segmented`, ``rank_pspecs``): ``din / tp`` columns of ``z`` and
of ``x``, ``H / tp`` of ``dt``, and all of ``B`` and ``C`` (one group,
read by every head), so the rank's block is the ``in_proj`` and conv of a
Mamba2 block with ``H / tp`` heads. The replicated ``B``/``C`` columns
feed each rank's own heads: their gradient is summed over "model"
(``enter_part``), and a sum of squares over the dim counts them once
(``once``).

A dense K/V cache follows the reference's ``cache_pspecs``
(``cache_rows``): the rank's K/V heads where Hkv divides tp, otherwise
the rank's SEQUENCE slice of every row with all Hkv heads where the
cache's positions divide tp (replicated where neither does); under
``cfg.cp_decode`` a lockstep cache that is no ring is sequence-sharded
whatever the heads, as the reference's ``shard_map`` reshards it. A
sliced cache carries its :class:`SeqSlice` under ``"kv_slice"`` (the
enc-dec family's and the VLM's cross K/V under ``"xkv_slice"``), and
``decode_step`` then takes the context-parallel branch.
"""
from __future__ import annotations

import math
import threading
from collections import Counter
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.pspec import P
from repro_torch.core.sharding import (_divisible, param_logical,
                                      param_pspecs, tree_map_with_path,
                                      zero1_spec)
from repro_torch.core.strategy import mesh_axes
from repro_torch.tree import flatten, unbind_leaves, unflatten

_state = threading.local()


@dataclass(frozen=True)
class LeafBlocks:
    """How one parameter leaf lies on a training rank: its full
    ``shape``; ``spec``, the block the rank holds (``rank_pspecs``);
    ``update``, the block it updates and keeps optimizer state for
    (ZeRO-1: ``spec`` sliced over "data" on one more dim,
    ``core/sharding.py::zero1_spec``); ``fsdp_dim``, the dim of
    ``spec`` split over "data" (FSDP), and ``zero_dim``, the dim of
    ``update`` split over "data" that ``spec`` is not (None where
    there is none, or at dp 1)."""
    shape: tuple
    spec: P
    update: P
    fsdp_dim: Optional[int]
    zero_dim: Optional[int]


@dataclass
class Rank:
    """One rank's place on the mesh and what it holds of the model: on
    the "model" axis (``tp`` ranks, this one ``rank``) its ``heads``
    query heads, ``kv_heads`` K/V heads in its cache (Hkv / tp, or all
    Hkv where they do not divide), of which its query heads read
    ``kv_read`` (a slice of the cache's head axis; None: all of them); on
    the "data" axis (``dp`` ranks, this one ``data_rank``) its ZeRO-1
    and FSDP blocks; on "pod" (``pods``, this one ``pod_rank``) nothing
    of its own; on the data-parallel axis :data:`BATCH` ("pod" x "data":
    ``batch_dp`` ranks, this one ``batch_rank``) its rows of the batch.
    ``group_ranks`` holds the global ranks of each axis's group that
    holds this rank. A training rank (``of(..., strategy=, shapes=)``) also
    carries ``leaves``, each parameter's :class:`LeafBlocks`,
    ``seq_parallel`` and ``zero1``; ``split_rows`` says whether the step
    in flight runs on this rank's rows of the batch (True) or on the
    whole batch (the batch does not split over "data"), set only for the
    step's span by ``step_rows``. ``counts``
    tallies the collectives issued, by what they carry, and ``bytes`` the
    bytes each put in (``numel * element_size`` of the tensor reduced or
    broadcast), ``axis_of`` the axis each label ran over."""
    tp: int
    rank: int
    group: object
    root: int
    heads: int
    kv_heads: int
    kv_read: Optional[slice]
    counts: Counter = field(default_factory=Counter)
    bytes: Counter = field(default_factory=Counter)
    dp: int = 1
    data_rank: int = 0
    data_group: object = None
    pods: int = 1
    pod_rank: int = 0
    pod_group: object = None
    batch_group: object = None
    axes: Dict[str, int] = field(default_factory=dict)
    group_ranks: Dict[str, tuple] = field(default_factory=dict)
    axis_of: Dict[str, str] = field(default_factory=dict)
    seq_parallel: bool = False
    zero1: bool = False
    leaves: Dict[str, LeafBlocks] = field(default_factory=dict)
    split_rows: bool = False
    whole_heads: bool = False

    @classmethod
    def of(cls, mesh, cfg, strategy=None, shapes=None) -> "Rank":
        """The calling process's view of ``mesh`` ("model", and "data"
        where the mesh has it) for ``cfg``'s attention; with
        ``strategy`` and ``shapes`` (each flat parameter key's full
        shape) a training rank's. Where Hq does not divide tp the rank
        runs every head (``whole_heads``). Raises ``ValueError`` for
        other shapes that cannot be split by whole heads."""
        axes = mesh_axes(mesh)
        tp = axes.get("model", 1)
        sub = mesh["model"]
        group = mesh.get_group("model")
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        whole = bool(hq % tp)
        if hkv % tp and tp % hkv and not whole:
            raise ValueError(
                f"{cfg.name}: {hkv} KV heads over tp={tp}: neither divides "
                "the other, so a rank's query heads would read parts of "
                "two KV heads")
        if cfg.d_ff % tp:
            raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} does not split "
                             f"over tp={tp}")
        check_ssm_heads(cfg, tp)
        r = int(sub.get_local_rank())
        if whole:
            kv_heads, kv_read = hkv, None
        elif hkv % tp == 0:
            kv_heads, kv_read = hkv // tp, None
        else:
            i = r // (tp // hkv)
            kv_heads, kv_read = hkv, slice(i, i + 1)
        dp = axes.get("data", 1)
        out = cls(tp=tp, rank=r, group=group,
                  root=dist.get_global_rank(group, 0),
                  heads=hq if whole else hq // tp, kv_heads=kv_heads,
                  kv_read=kv_read, whole_heads=whole,
                  dp=dp, axes=axes,
                  data_rank=int(mesh["data"].get_local_rank())
                  if "data" in axes else 0,
                  data_group=mesh.get_group("data") if "data" in axes
                  else None)
        if "pod" in axes:
            out.pods = axes["pod"]
            out.pod_rank = int(mesh["pod"].get_local_rank())
            out.pod_group = mesh.get_group("pod")
        out.batch_group = _batch_group(mesh) if "pod" in axes \
            else out.data_group
        for axis in ("model", "data", "pod", BATCH):
            g = _group(out, axis)
            if g is not None:
                out.group_ranks[axis] = tuple(
                    dist.get_process_group_ranks(g))
        if strategy is not None:
            out.seq_parallel = bool(strategy.seq_parallel) and tp > 1
            out.zero1 = bool(strategy.zero1)
            if shapes is not None:
                out.leaves = leaf_blocks(shapes, strategy, axes, cfg)
        return out

    @property
    def kv_sharded(self) -> bool:
        return self.kv_read is None

    @property
    def batch_dp(self) -> int:
        """Ranks of the data-parallel axis :data:`BATCH`."""
        return self.pods * self.dp

    @property
    def batch_rank(self) -> int:
        """This rank's index on :data:`BATCH` (pod major)."""
        return self.pod_rank * self.dp + self.data_rank

    def tally(self, what: str, x: torch.Tensor, axis: str = "model"):
        self.counts[what] += 1
        self.bytes[what] += x.numel() * x.element_size()
        self.axis_of[what] = axis


#: the data-parallel axis: ("pod", "data"), or "data" on a mesh without
#: "pod" (the reference's ``rules["batch"]``)
BATCH = "batch"


def _batch_group(mesh):
    """The group over ("pod", "data") that holds the calling rank: every
    rank creates one group a coordinate of the other axes, in one order
    (``new_group`` is collective), kept on the mesh for later calls."""
    cached = getattr(mesh, "_repro_batch_group", None)
    if cached is not None:
        return cached
    names = list(mesh.mesh_dim_names)
    lead = [names.index("pod"), names.index("data")]
    rest = [i for i in range(len(names)) if i not in lead]
    grid = mesh.mesh.permute(lead + rest)
    grid = grid.reshape(grid.shape[0] * grid.shape[1], -1)
    me, mine = dist.get_rank(), None
    for col in range(grid.shape[1]):
        ranks = [int(x) for x in grid[:, col]]
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    try:
        mesh._repro_batch_group = mine
    except AttributeError:
        pass
    return mine


@dataclass(frozen=True)
class SeqSlice:
    """A rank's rows of a dense K/V cache of ``total`` positions
    sequence-sharded over "model": positions ``[start, start +
    length)`` (ring slots on a ring), with every K/V head."""
    start: int
    length: int
    total: int


def cache_rows(cfg, length: int, *, ring: bool, cp: bool):
    """(K/V heads, :class:`SeqSlice` or None) the current rank holds of
    a dense K/V cache of ``length`` positions, by the reference's
    ``cache_pspecs`` (core/sharding.py:231-240): the sequence slice with
    all Hkv heads where ``length`` divides tp and either Hkv does not, or
    ``cp`` asks for it on a cache that is no ring (the context-parallel
    decode's reshard); else Hkv / tp heads where they divide, all of them
    otherwise. Without a live rank, or where the rank runs every head
    (``Rank.whole_heads``): all heads, whole rows."""
    r = _live()
    hkv = cfg.num_kv_heads
    if r is None or r.whole_heads:
        return hkv, None
    if length % r.tp == 0 and (hkv % r.tp or (cp and not ring)):
        n = length // r.tp
        return hkv, SeqSlice(r.rank * n, n, length)
    return r.kv_heads, None


def current() -> Optional[Rank]:
    """The rank made current for this thread by ``active``, or None."""
    return getattr(_state, "rank", None)


@contextmanager
def active(rank: Optional[Rank]):
    """Make ``rank`` (None: no sharding) current for this thread."""
    old = current()
    _state.rank = rank
    try:
        yield rank
    finally:
        _state.rank = old


def _live() -> Optional[Rank]:
    r = current()
    return r if r is not None and r.tp > 1 else None


def _sum_(x: torch.Tensor, axis: str, r: Rank, what: str,
          op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or ``op``) over ``axis``'s group in place, tallied."""
    r.tally(what, x, axis)
    dist.all_reduce(x, op=op, group=_group(r, axis))
    return x


def _grad_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Sum(torch.autograd.Function):
    """g: the sum over "model" forward, the gradient as it is backward
    (every rank's loss is the same function of the sum)."""

    @staticmethod
    def forward(ctx, x, r, what):
        return _sum_(x.clone(memory_format=torch.contiguous_format),
                     "model", r, what)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """f: identity forward, the gradient summed over "model" backward."""

    @staticmethod
    def forward(ctx, x, r, what):
        ctx.r, ctx.what = r, what
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.clone(memory_format=torch.contiguous_format),
                     "model", ctx.r, ctx.what + ".grad"), None, None


def _group(r: Rank, axis: str):
    return {"model": r.group, "data": r.data_group, "pod": r.pod_group,
            BATCH: r.batch_group}[axis]


def axis_index(r: Rank, axis: str) -> int:
    return {"model": r.rank, "data": r.data_rank, "pod": r.pod_rank,
            BATCH: r.batch_rank}[axis]


def axis_size(r: Rank, axis: str) -> int:
    return r.batch_dp if axis == BATCH else r.axes.get(axis, 1)


def fill_sum(part: torch.Tensor, shape, where, r: Rank, axis: str,
             what: str, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``part`` assembled over ``axis``: each writes its
    part at ``where`` (an index; None: nothing) of a zero buffer of
    ``shape`` (``out``, zeroed, where given) and one sum joins them —
    exact, only zeros are added. No gradient."""
    full = part.new_zeros(shape) if out is None else out.zero_()
    if where is not None:
        full[where] = part
    return _sum_(full, axis, r, what)


class _Assemble(torch.autograd.Function):
    """Each rank writes ``part`` at ``where`` (a tuple of slices; None:
    nothing) of a zero buffer of ``shape``, and one sum over ``axis``
    assembles it — exact, only zeros are added. Backward: the gradient's
    ``where`` slice, summed over ``axis`` first when ``summed`` (the
    assembled tensor feeds each rank's own work, so each rank's gradient
    is a partial)."""

    @staticmethod
    def forward(ctx, part, r, axis, shape, where, what, summed):
        ctx.r, ctx.axis, ctx.where = r, axis, where
        ctx.what, ctx.summed = what, summed
        return fill_sum(part, shape, where, r, axis, what)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:              # every rank takes part, writer or not
            g = _sum_(g.clone(memory_format=torch.contiguous_format),
                      ctx.axis, ctx.r, ctx.what + ".grad")
        if ctx.where is None:
            return (None,) * 7
        return (g[ctx.where].contiguous(),) + (None,) * 6


def slice_at(dim: int, index: int, n: int) -> tuple:
    return (slice(None),) * dim + (slice(index * n, (index + 1) * n),)


class _Scatter(torch.autograd.Function):
    """The reduce-scatter over ``axis`` along ``dim``: a sum, then the
    rank's slice (``summed=False``: the slice of a replicated tensor).
    Backward: the slices' gradients assembled by a zero-filled sum."""

    @staticmethod
    def forward(ctx, x, r, dim, what, summed, axis):
        ctx.r, ctx.dim, ctx.what, ctx.axis = r, dim, what, axis
        ctx.shape = x.shape
        if summed:
            x = _sum_(x.clone(memory_format=torch.contiguous_format),
                      axis, r, what)
        n = x.shape[dim] // axis_size(r, axis)
        return x[slice_at(dim, axis_index(r, axis), n)].contiguous()

    @staticmethod
    def backward(ctx, g):
        r, axis = ctx.r, ctx.axis
        return (fill_sum(g, ctx.shape,
                         slice_at(ctx.dim, axis_index(r, axis),
                                  g.shape[ctx.dim]), r, axis,
                         ctx.what + ".grad"),) + (None,) * 5


def all_reduce(x: torch.Tensor, what: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``: MAX) ``x`` over the current rank's group, in
    place (``x`` must be contiguous); a no-op without one or at tp 1. On
    a tensor that requires grad (training) the sum is out of place and
    differentiable, its backward the identity (g)."""
    r = _live()
    if r is None:
        return x
    if _grad_on(x):
        if op != dist.ReduceOp.SUM:
            raise ValueError(f"{what}: only a sum trains")
        return _Sum.apply(x, r, what)
    return _sum_(x, "model", r, what, op)


def enter(x: torch.Tensor, what: str) -> torch.Tensor:
    """f: ``x`` as it is, its gradient summed over "model" — for a
    replicated tensor used inside the rank's share of the work. A no-op
    without a live rank or a gradient."""
    r = _live()
    if r is None or not _grad_on(x):
        return x
    return _Enter.apply(x, r, what)


def seq_parallel(seq_len: int) -> bool:
    """Whether a forward over ``seq_len`` positions runs sequence
    parallel: the current rank asks for it and the sequence splits over
    "model" (a sequence that does not runs replicated, as the table
    drops a sharding that does not divide)."""
    r = _live()
    return r is not None and r.seq_parallel and seq_len % r.tp == 0


def seq_rows(total: int) -> slice:
    """The positions of the current rank's slice of a sequence of
    ``total`` split over "model" (all of them without a live rank)."""
    r = _live()
    if r is None:
        return slice(0, total)
    n = total // r.tp
    return slice(r.rank * n, (r.rank + 1) * n)


def seq_gather(x: torch.Tensor, what: str) -> torch.Tensor:
    """(B, S / tp, ...) slices -> (B, S, ...): every rank's slice
    assembled by a zero-filled sum; backward, the rank's slice of the
    gradient (``enter`` after it sums the gradient first)."""
    r = _live()
    if r is None:
        return x
    n = x.shape[1]
    shape = (x.shape[0], n * r.tp) + tuple(x.shape[2:])
    return _Assemble.apply(x, r, "model", shape, slice_at(1, r.rank, n),
                           what, False)


def seq_scatter(x: torch.Tensor, what: str) -> torch.Tensor:
    """The reduce-scatter: (B, S, ...) partials summed over "model",
    then the rank's (B, S / tp, ...) slice; backward, the zero-filled
    gather of the slices' gradients."""
    r = _live()
    if r is None:
        return x
    return _Scatter.apply(x, r, 1, what, True, "model")


def seq_split(x: torch.Tensor, what: str) -> torch.Tensor:
    """The rank's (B, S / tp, ...) slice of a replicated (B, S, ...)
    tensor; backward, the zero-filled gather of the slices' gradients."""
    r = _live()
    if r is None:
        return x
    return _Scatter.apply(x, r, 1, what, False, "model")


def reduce_out(x: torch.Tensor, what: str, *, seq: bool = False):
    """The row-parallel output ``x`` (this rank's partial) summed over
    "model": ``all_reduce``, or under sequence parallelism (``seq``) the
    reduce-scatter to the rank's slice."""
    return seq_scatter(x, what) if seq else all_reduce(x, what)


#: the regions that run on every head where the rank holds them all
HEAD_REGIONS = ("attn", "xattn", "cross")


def whole_heads() -> bool:
    """Whether the current rank runs every attention head
    (``Rank.whole_heads``: Hq does not divide tp)."""
    r = _live()
    return r is not None and r.whole_heads


def region_in(h: torch.Tensor, what: str, *, seq: bool = False):
    """The input of a split region (column-parallel projections): under
    sequence parallelism the sequence gathered, then ``enter``. An
    attention region (:data:`HEAD_REGIONS`) on a rank that runs every
    head is no split region: its gradient is whole already, so no
    ``enter``."""
    if seq:
        h = seq_gather(h, what + "_seq")
    if what in HEAD_REGIONS and whole_heads():
        return h
    return enter(h, what + "_in")


def heads_out(x: torch.Tensor, what: str, *, seq: bool = False):
    """An attention region's output projection: the row-parallel partial
    summed (``reduce_out``), or on a rank that runs every head the whole
    output as it is (``seq``: the rank's slice of it)."""
    if whole_heads():
        return seq_split(x, what) if seq else x
    return reduce_out(x, what, seq=seq)


def data_rows() -> Optional[Rank]:
    """The current rank where the step in flight runs on its rows of a
    batch split over :data:`BATCH` (more than one rank there), else
    None."""
    r = current()
    return r if r is not None and r.batch_dp > 1 and r.split_rows else None


@contextmanager
def step_rows(r: Rank, split: bool):
    """For the step in flight, mark ``r`` as running on its rows of a
    batch split over "data" (``split``) or on the whole batch; restored
    when the step ends, so no later forward on ``r`` reads it. The mark
    lives on the rank, not the thread: the autograd engine may run the
    remat recompute on another thread."""
    old = r.split_rows
    r.split_rows = split
    try:
        yield r
    finally:
        r.split_rows = old


def axis_sum(x: torch.Tensor, axis: str, what: str,
             r: Optional[Rank] = None) -> torch.Tensor:
    """``x`` summed over ``axis`` ("model", "data", "pod" or
    :data:`BATCH`) of rank ``r`` (default: the current one) in place, no
    gradient; a no-op where the axis has one rank."""
    r = r if r is not None else current()
    if r is None or axis_size(r, axis) == 1:
        return x
    return _sum_(x, axis, r, what)


def data_assemble(part: torch.Tensor, what: str) -> torch.Tensor:
    """(batch_dp, *part.shape): every data-parallel rank's ``part``
    stacked, by one zero-filled sum over :data:`BATCH` (no gradient)."""
    r = current()
    return fill_sum(part, (r.batch_dp,) + tuple(part.shape), r.batch_rank,
                    r, BATCH, what)


def data_scatter(x: torch.Tensor, what: str) -> torch.Tensor:
    """The reduce-scatter over :data:`BATCH` along dim 1: (n, C, ...)
    partials summed over the data-parallel ranks, then the rank's (n, C /
    batch_dp, ...) slice; backward, the zero-filled gather of the slices'
    gradients. Where each element has one writer (the MoE's dispatch
    buffer: each data rank fills its own entries' slots) the sum adds
    zeros only."""
    return _Scatter.apply(x, current(), 1, what, True, BATCH)


def data_gather(x: torch.Tensor, what: str) -> torch.Tensor:
    """(n, C / batch_dp, ...) slices -> (n, C, ...): every data-parallel
    rank's slice assembled by a zero-filled sum over :data:`BATCH`;
    backward, the gradient summed over :data:`BATCH` first (each rank
    reads the assembled tensor in its own work), then the rank's
    slice."""
    r = current()
    n = x.shape[1]
    shape = (x.shape[0], n * r.batch_dp) + tuple(x.shape[2:])
    return _Assemble.apply(x, r, BATCH, shape, slice_at(1, r.batch_rank, n),
                           what, True)


def broadcast_from_root(x: torch.Tensor, what: str) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of the current group, in place."""
    r = _live()
    if r is None:
        return x
    r.tally(what, x, "model")
    dist.broadcast(x, src=r.root, group=r.group)
    return x


def same_on_all(value: int, what: str, device) -> bool:
    """Whether every rank of the current group passed the same ``value``
    (a 63-bit int): one all-reduce with MAX of ``(value, -value)`` gives
    the largest and the smallest."""
    r = _live()
    if r is None:
        return True
    t = torch.tensor([value, -value], dtype=torch.int64, device=device)
    r.tally(what, t)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=r.group)
    return int(t[0]) == -int(t[1])


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                vocab_size: int, *, seq: bool = False) -> torch.Tensor:
    """``table[tokens]`` for a vocab-parallel ``table`` (this rank's
    ``V / tp`` rows): rows of tokens outside the rank's range are zero,
    and one sum gives every rank the full lookup. A whole table is looked
    up as it is. ``seq``: the rank's sequence slice of the lookup (the
    sum is the reduce-scatter)."""
    tokens = tokens.long()
    r = _live()
    if r is None:
        return table[tokens]
    if table.shape[0] == vocab_size:
        out = table[tokens]
        return seq_split(out, "embed") if seq else out
    n = table.shape[0]
    local = tokens - r.rank * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    out = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return reduce_out(out, "embed", seq=seq)


def vocab_logits(local: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Full-vocabulary logits from this rank's ``(..., V / tp)`` slice:
    each rank writes its slice into a zero-filled ``(..., V)`` buffer and
    one sum assembles it (in training its backward is the gradient's
    slice). Logits already over the whole vocabulary are returned as they
    are."""
    r = _live()
    n = local.shape[-1]
    if r is None or n == vocab_size:
        return local
    shape = local.shape[:-1] + (vocab_size,)
    where = slice_at(local.ndim - 1, r.rank, n)
    if _grad_on(local):
        return _Assemble.apply(local, r, "model", shape, where, "logits",
                               False)
    return fill_sum(local, shape, where, r, "model", "logits")


def gather_heads(parts, heads, what: str):
    """Every rank's heads of the tensors in ``parts``, each ``(..., h,
    D)`` of this rank's ``h`` consecutive heads of ``heads[i]``,
    assembled by ONE sum: each rank writes its heads into a zero-filled
    buffer of all of them (exact: only zeros are added). A tensor that
    already has all its heads is returned as it is and not sent."""
    r = _live()
    out = list(parts)
    todo = [i for i, x in enumerate(parts) if x.shape[-2] != heads[i]]
    if r is None or not todo:
        return out
    shapes = [parts[i].shape[:-2] + (heads[i], parts[i].shape[-1])
              for i in todo]
    buf = parts[todo[0]].new_zeros(sum(math.prod(sh) for sh in shapes))
    at = 0
    for i, sh in zip(todo, shapes):
        full = buf[at:at + math.prod(sh)].view(sh)
        at += full.numel()
        h = parts[i].shape[-2]
        full[..., r.rank * h:(r.rank + 1) * h, :] = parts[i]
        out[i] = full
    all_reduce(buf, what)
    return out


def kv_split() -> bool:
    """Whether the current rank holds its own K/V heads (Hkv / tp) —
    True without a live rank."""
    r = _live()
    return r is None or r.kv_read is None


def kv_read(x: torch.Tensor) -> torch.Tensor:
    """The KV heads the current rank's query heads read, of a K or V
    tensor whose second-to-last axis is the cache's heads."""
    r = _live()
    if r is None or r.kv_read is None:
        return x
    return x[..., r.kv_read, :]


# ------------------------------------------------ Mamba2 blocks by head

def check_ssm_heads(cfg, tp: int):
    """Raise ``ValueError`` where ``cfg``'s SSD heads do not split over
    ``tp`` ranks (a Mamba2 block is split by whole heads)."""
    if cfg.ssm_heads % tp:
        raise ValueError(
            f"{cfg.name}: {cfg.ssm_heads} SSD heads do not split over "
            f"tp={tp} (a Mamba2 block is split by whole heads)")


def ssm_heads(cfg) -> int:
    """The SSD heads the current rank holds of a Mamba2 block: H / tp,
    all H without a live rank."""
    r = _live()
    return cfg.ssm_heads if r is None else cfg.ssm_heads // r.tp


class Segmented(str):
    """A spec entry for a dim that is a concatenation of segments: equal
    to (and hashed as) the name of the mesh axis that splits it, so the
    tables read it as that axis, and carrying ``segments``, a tuple of
    ``(length, split)``: a split segment's block is its ``length / n``
    slice at the rank's index, a segment that is not split is whole on
    every rank."""

    def __new__(cls, axis: str, segments):
        out = super().__new__(cls, axis)
        out.segments = tuple((int(n), bool(s)) for n, s in segments)
        return out

    def __repr__(self) -> str:
        return f"Segmented({str(self)!r}, {self.segments})"

    def runs(self, n: int, index: int):
        """``(start, length, split)`` in the full dim of block ``index`` of
        ``n``, segment by segment."""
        out, at = [], 0
        for length, split in self.segments:
            if split:
                k = length // n
                out.append((at + index * k, k, True))
            else:
                out.append((at, length, False))
            at += length
        return out


#: Mamba2 leaves laid out by head on a rank (``ssm_segments``)
SEGMENTED_LEAVES = ("in_proj", "conv_w", "conv_b")


def ssm_segments(cfg, name: str) -> tuple:
    """The segments of the last dim of Mamba2 leaf ``name``: ``in_proj``'s
    ``[z | x | B | C | dt]`` columns, the conv's ``[x | B | C]`` channels
    (``B`` and ``C`` not split)."""
    din, n = cfg.ssm_heads * cfg.ssm_head_dim, cfg.ssm_state
    if name == "in_proj":
        return ((din, True), (din, True), (n, False), (n, False),
                (cfg.ssm_heads, True))
    return ((din, True), (n, False), (n, False))


def enter_part(x: torch.Tensor, start: int, length: int,
               what: str) -> torch.Tensor:
    """``x`` with its last dim's ``[start, start + length)`` under
    ``enter`` (the gradient of those entries summed over "model"): the
    replicated ``B``/``C`` columns of a rank's Mamba2 weights. ``x``
    itself without a live rank or a gradient."""
    r = _live()
    if r is None or not _grad_on(x):
        return x
    head, part, tail = x.split(
        [start, length, x.shape[-1] - start - length], dim=-1)
    return torch.cat([head, _Enter.apply(part, r, what), tail], dim=-1)


def norm_sum(x: torch.Tensor, what: str) -> torch.Tensor:
    """A sum over "model" whose total each rank uses on its own share of
    the work (a norm's sum of squares over the rank's heads): the sum
    forward and, in training, the gradient summed backward (g, then
    f)."""
    return enter(all_reduce(x, what), what)


def once(x: torch.Tensor, spec, r: Rank) -> torch.Tensor:
    """``x`` (a block under ``spec``) with the segments that are not split
    zeroed on every rank of their axis but the first: summed over the
    dim and then over the axis, they count once."""
    for dim, ax in enumerate(tuple(spec)):
        if not isinstance(ax, Segmented) or r.axes.get(ax, 1) == 1 \
                or axis_index(r, ax) == 0:
            continue
        x = x.clone()
        at = 0
        for _, length, split in ax.runs(r.axes[ax], 0):
            if not split:
                x.narrow(dim, at, length).zero_()
            at += length
    return x


# ------------------------------------------------------------- FSDP gathers

def _data_block(leaf: torch.Tensor, dim: int, r: Rank, what: str):
    """The whole of ``leaf`` (this rank's block along ``dim`` over
    "data") by a zero-filled sum; backward, the gradient summed over
    "data" where the step runs on split rows, then sliced back."""
    n = leaf.shape[dim]
    shape = leaf.shape[:dim] + (n * r.dp,) + leaf.shape[dim + 1:]
    return _Assemble.apply(leaf, r, "data", shape,
                           slice_at(dim, r.data_rank, n), what,
                           r.split_rows)


def fsdp_full(leaf: torch.Tensor, key: str) -> torch.Tensor:
    """Parameter ``key`` whole over "data" where FSDP splits it (a
    gather, ``"fsdp_gather"``); as it is otherwise."""
    r = current()
    lb = None if r is None else r.leaves.get(key)
    if lb is None or lb.fsdp_dim is None:
        return leaf
    return _data_block(leaf, lb.fsdp_dim, r, "fsdp_gather")


def layer_sources(tree, n: int, prefix: str):
    """``n`` callables, the i-th returning layer i's leaves of the
    stacked subtree ``tree`` (flat keys under ``prefix``): views of the
    one ``unbind`` a leaf (``tree.unbind_leaves``), and where FSDP splits a leaf over "data", the layer's whole leaf
    gathered when it is called — inside a remat checkpoint the
    recompute gathers it again, so no more than the layers being applied
    are ever whole. A leaf split on its layer axis is gathered from the
    data rank that owns the layer (a zero-filled sum, the others
    writing nothing)."""
    r = current()
    parts = unbind_leaves(tree)
    dims = {}
    for k in parts:
        lb = None if r is None else r.leaves.get(f"{prefix}/{k}")
        if lb is not None and lb.fsdp_dim is not None:
            dims[k] = lb.fsdp_dim

    def layer(i: int):
        out = {}
        for k, p in parts.items():
            dim = dims.get(k)
            if dim is None:
                out[k] = p[i]
            elif dim > 0:
                out[k] = _data_block(p[i], dim - 1, r, "fsdp_gather")
            else:
                per = len(p)                       # layers a data rank owns
                own = i // per == r.data_rank
                out[k] = _Assemble.apply(
                    p[i % per if own else 0], r, "data", p[0].shape,
                    (slice(None),) if own else None, "fsdp_gather",
                    r.split_rows)
        return unflatten(out)

    return [(lambda i=i: layer(i)) for i in range(n)]


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` with
    the current rank made current again for the recompute, which the
    autograd engine may run on another thread."""
    from torch.utils.checkpoint import checkpoint as _checkpoint
    r = current()
    return _checkpoint(fn, *args, use_reentrant=False,
                       context_fn=lambda: (nullcontext(), active(r)))


def zero_block(x: torch.Tensor, lb: LeafBlocks,
               r: Optional[Rank] = None) -> torch.Tensor:
    """Rank ``r``'s (default: the current one's) ZeRO-1 block of ``x`` (a
    tensor of the rank's param block shape), contiguous; ``x`` itself
    where the leaf has none."""
    if lb.zero_dim is None:
        return x
    r = r if r is not None else current()
    n = x.shape[lb.zero_dim] // r.dp
    return x.narrow(lb.zero_dim, r.data_rank * n, n).contiguous()


def assemble(block: torch.Tensor, spec, what: str,
             r: Optional[Rank] = None) -> torch.Tensor:
    """The whole leaf from rank ``r``'s (default: the current one's)
    ``block`` under ``spec``: one zero-filled sum over each mesh axis that
    splits it (no gradient)."""
    r = r if r is not None else current()
    out = block
    for dim, ax in enumerate(tuple(spec)):
        if ax is None or r is None or r.axes.get(ax, 1) == 1:
            continue
        if isinstance(ax, tuple):
            raise ValueError(f"{what}: a dim split over {ax}")
        if isinstance(ax, Segmented):
            out = _assemble_segments(out, dim, ax, r, what)
            continue
        n = out.shape[dim]
        shape = out.shape[:dim] + (n * r.axes[ax],) + out.shape[dim + 1:]
        out = fill_sum(out, shape, slice_at(dim, axis_index(r, ax), n), r,
                       ax, what)
    return out


def _assemble_segments(block, dim: int, ax: Segmented, r: Rank,
                       what: str) -> torch.Tensor:
    """The whole of ``dim`` laid out as ``ax``'s segments: each rank
    writes its slices of the split segments, the first rank the segments
    that are not split, into a zero buffer; one sum joins them."""
    shape = list(block.shape)
    shape[dim] = sum(n for n, _ in ax.segments)
    full = block.new_zeros(shape)
    first = axis_index(r, ax) == 0
    at = 0
    for start, length, split in ax.runs(r.axes[ax], axis_index(r, ax)):
        if split or first:
            full.narrow(dim, start, length).copy_(
                block.narrow(dim, at, length))
        at += length
    return _sum_(full, ax, r, what)


# ------------------------------------------------------- sharding leaves

def rank_pspecs(params, strategy, mesh, cfg):
    """``core/sharding.param_pspecs`` with every head kept whole: a
    query, key or value projection (and ``wo``) whose head count does not
    divide the "model" axis stays replicated where the table would split
    its flattened ``heads * head_dim`` dimension, and a Mamba2 block's
    ``in_proj`` / ``conv_w`` / ``conv_b`` split over "model" by head
    (:class:`Segmented` by ``ssm_segments``) where the table splits the
    flat dim contiguously."""
    model = mesh_axes(mesh).get("model", 1)
    counts = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}
    if model > 1 and cfg.ssm_heads:
        check_ssm_heads(cfg, model)

    def whole(path, leaf, spec):
        logical = param_logical(path, leaf)
        out = [None if ax is not None and logical[i] in counts
               and counts[logical[i]] % model else ax
               for i, ax in enumerate(spec)]
        if model > 1 and cfg.ssm_heads and path[-1] in SEGMENTED_LEAVES:
            out[-1] = Segmented("model", ssm_segments(cfg, path[-1]))
        return P(*out)

    return tree_map_with_path(whole, params,
                              param_pspecs(params, strategy, mesh))


def coordinate(mesh) -> Dict[str, int]:
    """The calling rank's coordinate on each axis of ``mesh``."""
    return {n: int(mesh[n].get_local_rank()) for n in mesh.mesh_dim_names}


def block_of(ax, axes: Dict[str, int], coord: Dict[str, int]):
    """(number of blocks, this rank's block) of a dim sharded over
    ``ax`` (an axis name or a tuple of them, major first)."""
    size, index = 1, 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size, index = size * axes[a], index * axes[a] + coord.get(a, 0)
    return size, index


def local_shape(shape, spec, axes: Dict[str, int]) -> tuple:
    """The block shape of a leaf of ``shape`` under ``spec``."""
    def one(n, ax):
        if ax is None:
            return n
        size = block_of(ax, axes, {})[0]
        if isinstance(ax, Segmented):
            return sum(k for _, k, _ in ax.runs(size, 0))
        return n // size
    return tuple(one(n, ax) for n, ax in zip(shape, spec))


def shard_leaf(leaf: torch.Tensor, spec, axes: Dict[str, int],
               coord: Dict[str, int]) -> torch.Tensor:
    """The block of ``leaf`` at mesh coordinate ``coord`` under ``spec``
    (``axes``: the mesh's sizes), as a contiguous tensor."""
    out = leaf
    for dim, ax in enumerate(spec):
        if ax is not None:
            size, index = block_of(ax, axes, coord)
            if isinstance(ax, Segmented):
                out = torch.cat([out.narrow(dim, start, length) for
                                 start, length, _ in ax.runs(size, index)],
                                dim=dim)
                continue
            if leaf.shape[dim] % size:
                raise ValueError(f"dim {dim} of a {tuple(leaf.shape)} leaf "
                                 f"does not split into {size} blocks")
            n = leaf.shape[dim] // size
            out = out.narrow(dim, index * n, n)
    return out.contiguous()


class Shape:
    """A leaf stand-in: what the tables read of a parameter."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def leaf_specs(shapes: Dict[str, tuple], strategy, mesh, cfg):
    """``{key: spec}`` (``rank_pspecs``) for flat ``{key: full shape}``
    parameter shapes."""
    tree = unflatten({k: Shape(s) for k, s in shapes.items()})
    return flatten(rank_pspecs(tree, strategy, mesh, cfg))


def leaf_blocks(shapes: Dict[str, tuple], strategy, mesh, cfg
                ) -> Dict[str, LeafBlocks]:
    """``{key: LeafBlocks}`` for flat ``{key: full shape}`` parameter
    shapes: the rank's block (``rank_pspecs``, "data" on a dim where
    FSDP splits it) and the block it updates (``zero1_spec`` over it when
    ``strategy.zero1``, as ``opt_state_pspecs`` lays out the state)."""
    axes = mesh_axes(mesh)
    dp = axes.get("data", 1)
    specs = leaf_specs(shapes, strategy, axes, cfg)
    out = {}
    for key, shape in shapes.items():
        shape = tuple(shape)
        spec = P(*(tuple(specs[key]) + (None,) * (len(shape)
                                                   - len(specs[key]))))
        update = _divisible(shape, zero1_spec(spec, shape, axes), axes) \
            if strategy.zero1 else spec
        update = P(*(a if isinstance(a, Segmented) else u
                     for a, u in zip(spec, update)))
        fsdp = [i for i, ax in enumerate(spec) if ax == "data"]
        zero = [i for i, ax in enumerate(update) if ax == "data"]
        fsdp_dim = fsdp[0] if fsdp and dp > 1 else None
        zero_dim = zero[0] if zero and dp > 1 and fsdp_dim is None \
            else None
        out[key] = LeafBlocks(shape, spec, update, fsdp_dim, zero_dim)
    return out


def shard_params(params, shapes: Dict[str, tuple], strategy, mesh, cfg):
    """This rank's block of every leaf of ``params`` (``shapes``: each
    flat key's full shape). A leaf already of its block's shape — made by
    ``params.init_params(shard=)`` or ``from_numpy(shard=)`` — is kept;
    any other shape raises."""
    specs = leaf_specs(shapes, strategy, mesh, cfg)
    axes, coord = mesh_axes(mesh), coordinate(mesh)
    out = {}
    for key, leaf in flatten(params).items():
        full, spec = tuple(shapes[key]), specs[key]
        mine = local_shape(full, spec, axes)
        if tuple(leaf.shape) == full:
            out[key] = shard_leaf(leaf, spec, axes, coord)
        elif tuple(leaf.shape) == mine:
            out[key] = leaf
        else:
            raise ValueError(f"{key}: shape {tuple(leaf.shape)} is neither "
                             f"the full {full} nor this rank's {mine}")
    return unflatten(out)
