"""Inter-operator (pipeline) parallelism — the port of
``repro/core/pipeline.py`` (survey §3.2/§4, Fig. 5).

One process a rank, as in ``core/tp.py``: a rank is one stage of the
mesh's "pipe" axis (``launch/mesh.py::make_pipeline_mesh``) and runs the
reference's GPipe schedule on its own: T = M + P - 1 ticks of a Python
loop where the reference scans, every stage computing every tick (the
first P - 1 and last P - 1 ticks are the bubble, computed on whatever the
stage holds and thrown away: GPipe's bubble as wasted FLOPs, Fig. 5c/5d).

The reference moves stage outputs with a ring ``ppermute``. Here the move
is ``_Ring``: each stage's output is copied to host memory, sent to the
next stage with ``isend`` while the previous stage's is taken with
``irecv`` (both non-blocking, so the ring of P sends cannot deadlock),
and copied back to the stage's device: gloo's ``send``/``recv`` take
host tensors only (PyTorch's table of backends), so the same code runs
with gloo on CPU tensors (the tests) and on CUDA tensors (ranks sharing
one card). The move is exact. Its backward is the inverse ring: a
gradient goes from stage i to i - 1.

At the end the last stage's outputs are copied to every pipe member by
one sum over "pipe" of the last stage's outputs and every other stage's
zeros (``_Copy``, exact). Every rank then computes the same loss from the
same replicated output, and the gradient taken is that of ONE copy of
it: ``_Copy``'s backward is the identity, and the mask in front of it
gives the last stage that gradient and every other stage zero.

Every rank issues the same collectives in the same order, forward and
backward: the stage index selects with ``torch.where``, never with a
Python ``if``, so each rank's autograd graph has the same shape. The
moves are tallied in the :class:`Stage` by label (``pipe_send``,
``pipe_send.grad``, ``pipe_out``), as ``tp.Rank.tally`` does.

``simulate_schedule`` is the reference's tick-level simulator of GPipe
and 1F1B, copied as it is.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import tp
from repro_torch.core.sharding import tree_map_with_path
from repro_torch.core.strategy import mesh_axes


@dataclass
class Stage:
    """One rank's place on the pipe axis: stage ``index`` of ``size``,
    the axis's process ``group``, and the global ranks of the stages
    before (``prev``) and after (``next``) it on the ring. ``counts``
    tallies the moves issued, by label, and ``bytes`` the bytes each
    put in (``numel * element_size`` of the tensor sent or summed)."""
    index: int
    size: int
    group: object
    prev: int
    next: int
    counts: Counter = field(default_factory=Counter)
    bytes: Counter = field(default_factory=Counter)

    @classmethod
    def of(cls, mesh, axis: str = "pipe") -> "Stage":
        """The calling process's stage on ``mesh``'s ``axis``."""
        p = mesh_axes(mesh)[axis]
        i = int(mesh[axis].get_local_rank())
        group = mesh.get_group(axis)
        return cls(index=i, size=p, group=group,
                   prev=dist.get_global_rank(group, (i - 1) % p),
                   next=dist.get_global_rank(group, (i + 1) % p))

    def tally(self, what: str, x: torch.Tensor):
        self.counts[what] += 1
        self.bytes[what] += x.numel() * x.element_size()


def _shift(x: torch.Tensor, stage: Stage, what: str,
           forward: bool) -> torch.Tensor:
    """``x`` sent one stage along the ring (``forward``: to the next
    stage, else to the previous one), and what the stage on the other
    side sent here, on ``x``'s device: staged through host memory."""
    stage.tally(what, x)
    if stage.size == 1:
        return x.detach().clone()
    dst, src = (stage.next, stage.prev) if forward else \
        (stage.prev, stage.next)
    host = x.detach().to("cpu").contiguous()
    got = torch.empty_like(host)
    for req in (dist.isend(host, dst, group=stage.group),
                dist.irecv(got, src, group=stage.group)):
        req.wait()
    return got.to(x.device)


class _Ring(torch.autograd.Function):
    """The ring ``ppermute`` stage i -> i + 1 (the last stage's send
    lands on stage 0, which ignores it); backward, the inverse ring."""

    @staticmethod
    def forward(ctx, y, stage):
        ctx.stage = stage
        return _shift(y, stage, "pipe_send", True)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.stage, "pipe_send.grad", False), None


class _Copy(torch.autograd.Function):
    """The sum over "pipe" forward, the gradient as it is backward (every
    rank's loss is the same function of the sum)."""

    @staticmethod
    def forward(ctx, x, stage):
        out = x.clone(memory_format=torch.contiguous_format)
        stage.tally("pipe_out", out)
        dist.all_reduce(out, group=stage.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gpipe_spmd(stage_fn: Callable, microbatches: torch.Tensor, *, mesh,
               axis: str = "pipe", stage: Optional[Stage] = None):
    """Run on every rank of ``mesh``'s ``axis``. ``stage_fn(x) -> y``
    applies THIS rank's stage (``y.shape == x.shape``); ``microbatches``:
    (M, mb, ...), the same on every pipe member. The rank finds its stage
    index and the pipe group from ``mesh`` (``stage``: the caller's
    :class:`Stage` of this rank there, to read its tallies after).

    Returns (M, mb, ...) final-stage outputs, the same on every pipe
    member. Every stage computes every tick; ticks where a stage holds no
    valid micro-batch are the pipeline bubble (wasted FLOPs, exactly
    GPipe). The input's gradient lands on the first stage only."""
    stage = stage if stage is not None else Stage.of(mesh, axis)
    p, idx, m = stage.size, stage.index, microbatches.shape[0]
    dev = microbatches.device
    first = torch.tensor(idx == 0, device=dev)
    buf = torch.zeros_like(microbatches[0])
    outs = [torch.zeros_like(microbatches[0]) for _ in range(m)]
    for t in range(m + p - 1):
        x = torch.where(first, microbatches[min(t, m - 1)], buf)
        y = stage_fn(x)
        out_i = min(max(t - (p - 1), 0), m - 1)
        write = torch.tensor(idx == p - 1 and t >= p - 1, device=dev)
        outs[out_i] = torch.where(write, y, outs[out_i])
        buf = _Ring.apply(y, stage)
    outs = torch.stack(outs)
    # the last stage's outputs to every stage member
    last = torch.where(torch.tensor(idx == p - 1, device=dev), outs,
                       torch.zeros_like(outs))
    return _Copy.apply(last, stage)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, num_microbatches: int, axis: str = "pipe",
                   stage: Optional[Stage] = None):
    """The high-level entry: ``stage_params`` leaves have leading dim P
    (one slice a stage; this rank reads only its own); ``x``: (B, ...)
    the global batch, the same on every rank. ``stage_fn(params_slice,
    x_mb) -> y_mb`` with ``y_mb.shape == x_mb.shape``. Returns (B, ...)
    on every rank.

    ``stage_fn`` runs with no tensor-parallel rank active, whatever the
    caller holds: the reference replicates the params over "data" and
    "model", so every member of those axes computes the same stage."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} does not split into "
                         f"{num_microbatches} microbatches")
    micro = x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])
    stage = stage if stage is not None else Stage.of(mesh, axis)
    local = tree_map_with_path(lambda _, a: a[stage.index], stage_params)

    def run(xx):
        with tp.active(None):
            return stage_fn(local, xx)

    out = gpipe_spmd(run, micro, mesh=mesh, axis=axis, stage=stage)
    return out.reshape(b, *x.shape[1:])


# ------------------------------------------------------- schedule simulator

def simulate_schedule(num_stages: int, num_micro: int, *,
                      schedule: str = "gpipe",
                      fwd_time: float = 1.0,
                      bwd_time: float = 2.0) -> dict:
    """Tick-level simulation of GPipe vs 1F1B (Fig. 5c/5d + PipeDream [20]).

    Returns total time, ideal time, bubble fraction, and peak in-flight
    micro-batches per stage (the activation-memory driver [14]).
    """
    p, m = num_stages, num_micro
    if schedule == "gpipe":
        total = (m + p - 1) * fwd_time + (m + p - 1) * bwd_time
        ideal = m * (fwd_time + bwd_time)
        in_flight = m  # GPipe stores all micro-batch activations
    elif schedule == "1f1b":
        # warmup p-1 fwd, steady 1F1B, drain p-1 bwd
        total = (p - 1) * fwd_time + m * (fwd_time + bwd_time) \
            + (p - 1) * bwd_time
        ideal = m * (fwd_time + bwd_time)
        in_flight = min(m, p)
    else:
        raise ValueError(schedule)
    bubble = 1.0 - ideal / total
    # closed-form check from the paper: (p-1)/(m+p-1) for equal fwd/bwd split
    closed_form = (p - 1) / (m + p - 1)
    return {"schedule": schedule, "stages": p, "microbatches": m,
            "total_time": total, "ideal_time": ideal,
            "bubble_fraction": bubble, "closed_form_gpipe": closed_form,
            "peak_inflight_microbatches": in_flight}
