"""Training-step builder: forward + backward + optimizer under a Strategy
— the port of ``repro/train/step.py``.

``make_train_step(cfg, strategy)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
for the family ``get_model(cfg)`` names (dense, MoE, SSM, hybrid,
enc-dec audio, VLM); an
MoE decoder's loss adds ``cfg.router_aux_coef`` times the router aux
loss, and each microbatch routes under its own capacity, as in the
reference.
Where the reference is a pure function under ``jax.jit``, this one runs
eagerly and trains ``params`` and ``opt_state`` in place (the optimizers
say why); every leaf of ``params`` is made to require grad. Gradient
accumulation over ``strategy.microbatches`` sums ``g / n_micro`` in
``strategy.grad_accum_dtype``, as the reference's scan does.

Under a training rank (``core/tp.py``: ``tp.active(Rank.of(mesh, cfg,
strategy, shapes))``, params and state the rank's blocks, as the Trainer
makes them) the step computes what the reference's unsharded step
computes on the same global batch, which it takes whole on every rank:

* ``data/pipeline.py::shard_batch`` gives the rank its rows — its
  contiguous share of every global microbatch — where the batch splits
  over the data-parallel axis, "pod" x "data" (``tp.BATCH``,
  ``rows_split``), else the whole batch;
* the forward runs the rank's shards (Megatron TP, experts over
  "model", sequence parallelism, FSDP's layer gathers); the loss is the
  rank's share of the global batch's mean, and the MoE routes the global
  batch;
* after the backward every gradient is summed over that axis
  (``"dp_grads"``; where FSDP's gather already summed it over "data",
  over "pod" only; not at all where the batch is whole on every data
  rank) and cut to the leaf's update block (ZeRO-1, over "data");
* the norm, the optimizer and the metrics (``loss``, ``aux_loss``,
  ``grad_norm``, summed over the data-parallel axis: ``"metrics"``) are
  the global
  ones, equal on every rank.

``train_step.grads(params, batch)`` is the step up to there: (the
rank's update blocks of the gradient before clipping, the metrics).
The enc-dec family's batches carry ``frames`` beside ``tokens``, the
VLM's ``image_embeds``: ``shard_batch`` and the microbatch split cut
every key of the batch by its rows, so a data rank's frames or images
are those of its token rows (whole on every "model" rank).

The step's parts run under ``torch.profiler.record_function`` ranges named
by :data:`PARTS`, so a profiled step splits its time by them (a range costs
a few microseconds when no profiler runs).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.core import tp
from repro_torch.core.strategy import Strategy
from repro_torch.data.pipeline import rows_split, shard_batch
from repro_torch.models import get_model
from repro_torch.optim import clip_by_global_norm, get_optimizer
from repro_torch.train.losses import cross_entropy
from repro_torch.tree import flatten, tree_map, unflatten

PARTS = ("forward_loss", "backward", "dp_grads", "clip", "optimizer")


def make_loss_fn(cfg, strategy: Strategy) -> Callable:
    model = get_model(cfg)          # raises for the unported families

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, cfg,
                                    remat=strategy.remat,
                                    attn_impl=strategy.attn_impl)
        labels = batch.get("labels")
        if labels is None:           # next token, -1 (ignored) at the end
            tokens = batch["tokens"]
            labels = torch.cat([tokens[:, 1:],
                                torch.full_like(tokens[:, :1], -1)], dim=1)
        loss = cross_entropy(logits, labels)
        total = loss + cfg.router_aux_coef * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def _training_rank():
    """The current rank where it is a training one (with its leaves)."""
    r = tp.current()
    return r if r is not None and r.leaves else None


def init_opt_state(params, strategy: Strategy, rank=None):
    """The optimizer's state of ``params`` — on a training ``rank`` (or
    the current one) its blocks."""
    init, _ = get_optimizer(strategy.optimizer)
    rank = rank if rank is not None else _training_rank()
    return init(params) if rank is None else init(params, rank=rank)


@torch.no_grad()
def reduce_grads(grads, rank, split: bool):
    """The rank's gradients summed over the data-parallel axis
    (``tp.BATCH``) where the rows were split (a leaf FSDP gathers is
    summed over "data" already, so over "pod" only) and cut to each
    leaf's update block."""
    out = {}
    for key, g in flatten(grads).items():
        lb = rank.leaves[key]
        if split:
            axis = tp.BATCH if lb.fsdp_dim is None else "pod"
            g = tp.axis_sum(g.contiguous(), axis, "dp_grads", rank)
        out[key] = tp.zero_block(g, lb, rank)
    return unflatten(out)


def make_train_step(cfg, strategy: Strategy, *, lr: float = 3e-4,
                    max_grad_norm: float = 1.0) -> Callable:
    loss_fn = make_loss_fn(cfg, strategy)
    _, opt_update = get_optimizer(strategy.optimizer)
    n_micro = strategy.microbatches

    def grads_of(params, batch):
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        with record_function("forward_loss"):
            total, metrics = loss_fn(params, batch)
        with record_function("backward"):
            # a leaf the loss does not reach (the hybrid's and the VLM's one
            # unused trailing layer when every layer is in a group) gets
            # zeros, as jax.grad gives
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        materialize_grads=True)
        return unflatten(dict(zip(leaves, grads))), \
            {k: v.detach() for k, v in metrics.items()}

    def accumulate(params, batch):
        if n_micro > 1:
            acc_dt = getattr(torch, strategy.grad_accum_dtype)
            b = batch["tokens"].shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} does not split into "
                                 f"{n_micro} microbatches")
            mb = b // n_micro
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dt, device=p.device), params)
            metrics = None
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, m = grads_of(params, micro)
                for a, gi in zip(flatten(grads).values(),
                                 flatten(g).values()):
                    a.add_((gi.float() / n_micro).to(acc_dt))
                del g
                m = {k: v / n_micro for k, v in m.items()}
                metrics = m if metrics is None else \
                    {k: metrics[k] + m[k] for k in m}
        else:
            grads, metrics = grads_of(params, batch)
        return grads, metrics

    def grads(params, batch):
        r = _training_rank()
        if r is None:
            return accumulate(params, batch)
        rows = len(batch["tokens"])
        split = rows_split(rows, r.batch_dp, n_micro)
        with tp.step_rows(r, split):
            grads, metrics = accumulate(params, shard_batch(
                batch, r.batch_dp, r.batch_rank, microbatches=n_micro))
        with record_function("dp_grads"):
            grads = reduce_grads(grads, r, split)
            if split:
                vec = torch.stack([metrics["loss"].float(),
                                   metrics["aux_loss"].float()])
                tp.axis_sum(vec, tp.BATCH, "metrics", r)
                metrics = {"loss": vec[0], "aux_loss": vec[1]}
        return grads, metrics

    def train_step(params, opt_state, batch):
        g, metrics = grads(params, batch)
        r = _training_rank()
        kw = {} if r is None else {"rank": r}
        with record_function("clip"):
            g, gnorm = clip_by_global_norm(g, max_grad_norm, **kw)
        with record_function("optimizer"):
            params, opt_state = opt_update(g, opt_state, params, lr=lr,
                                           **kw)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    train_step.grads = grads
    return train_step
