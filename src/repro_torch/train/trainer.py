"""Trainer: the end-to-end driver tying data, strategy, the train step,
metrics and checkpointing together — the port of
``repro/train/trainer.py``, on one explicit device or, with ``mesh=``, as
one rank of a ("data", "model") mesh.

Preferred entry point: ``repro_torch.api.Session.train(...)``. The
trainer trains the param tree it is given IN PLACE (no private copy, as
the reference's donation needs: at Qwen3-14B width with 4 layers a copy
is 5.8 GB of bf16), so a Session's params are the trained ones after
``run``.

With ``mesh=`` (a ``DeviceMesh`` over the ranks of an initialised
process group, one process a rank) the trainer builds the rank
(``core/tp.py::Rank.of``), keeps only the rank's block of every param
(drawn from the seed, or cut from the full tree it is given) and of the
optimizer state (ZeRO-1 by ``Strategy.zero1``), and runs the step under
the rank: each step's batch is the global one, of which the step takes
the rank's rows (``data/pipeline.py::shard_batch``). Every family trains
so: dense and MoE decoders, the SSM family, the hybrid (a Mamba2 block
by whole heads, ``core/tp.py``), the enc-dec family (its frames cut with
their token rows) and the VLM (its images likewise); an MoE with its
experts over "model" or, with ``Strategy(expert_parallel=False)``, each
expert's d_ff (``models/moe.py``). A checkpoint holds the full tree,
assembled from the blocks and written by the first rank, the same file
an unsharded trainer writes; ``maybe_restore`` cuts a full checkpoint to
the rank's blocks. On one device ``seq_parallel`` and ``fsdp``, like
``zero1``, are accepted and change nothing.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core import tp
from repro_torch.core.strategy import Strategy
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.kernels import flash_attention
from repro_torch.params import full_shapes, init_params
from repro_torch.train.step import init_opt_state, make_train_step
from repro_torch.tree import flatten, unflatten


@dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    log_every: int = 10
    checkpoint_every: int = 0            # 0 = disabled
    checkpoint_dir: str = "checkpoints"
    seed: int = 0


def check_kernel_limits(cfg, strategy: Strategy, device, rank=None) -> None:
    """On a CUDA device every attention over the sequence runs the flash
    kernel (``attn_impl`` ``auto`` or ``pallas``): each layer of a dense
    or MoE decoder, each application of the hybrid's shared block, each
    encoder and decoder self-attention of the enc-dec family, each self
    layer of the VLM (its cross-attention is plain).
    Refuse, before any parameter is made, heads it cannot take, rather
    than fail at the first step. The SSM family runs no attention, and
    trains through the plain SSD scan (the kernel has no backward):
    nothing to check. On a ``rank`` the kernel takes the rank's heads:
    Hq / tp, and Hkv / tp where they divide (else the one K/V head its
    query heads read)."""
    if torch.device(device).type != "cuda" or \
            strategy.attn_impl not in ("auto", "pallas") or \
            cfg.arch_type not in ("dense", "moe", "hybrid", "audio", "vlm"):
        return
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if rank is not None and rank.tp > 1:
        hq, hkv = rank.heads, (rank.kv_heads if rank.kv_sharded else 1)
    why = flash_attention.kernel_limits(cfg.dtype, hq, hkv, cfg.head_dim)
    if why:
        raise ValueError(
            f"{cfg.name}: training on {device} with attn_impl="
            f"{strategy.attn_impl!r} runs the flash-attention kernel, "
            f"which {why}")


class Trainer:
    def __init__(self, cfg, strategy: Strategy, device,
                 train_cfg: TrainConfig, data: Optional[TokenDataset] = None,
                 global_batch: int = 8, seq_len: int = 256, params=None,
                 mesh=None):
        self.cfg, self.strategy = cfg, strategy
        self.device = torch.device(device)
        self.mesh = mesh
        self.rank = None
        if mesh is not None:
            self.rank = tp.Rank.of(mesh, cfg, strategy, full_shapes(cfg))
        check_kernel_limits(cfg, strategy, self.device, self.rank)
        self.tc = train_cfg
        self.data = data or TokenDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=train_cfg.seed))
        shard = None if mesh is None else (strategy, mesh)
        if params is None:
            params = init_params(cfg, device=self.device,
                                 seed=train_cfg.seed, shard=shard)
        elif mesh is not None:
            params = tp.shard_params(params, full_shapes(cfg), strategy,
                                     mesh, cfg)
        self.params = params
        self.opt_state = init_opt_state(params, strategy, self.rank)
        self._step_fn = make_train_step(cfg, strategy, lr=train_cfg.lr)
        self.step = 0
        self.history: list = []

    def _lead(self) -> bool:
        """Whether this process writes (the first rank; the only one
        unsharded)."""
        return self.rank is None or dist.get_rank() == 0

    def save(self, step: Optional[int] = None):
        """Write checkpoint ``step`` (default: the current one) of the
        full tree. Under a mesh every rank must call this: each leaf is
        assembled from the ranks' blocks in turn (no rank holds more than
        one whole leaf on the device) and the first rank writes."""
        step = self.step if step is None else step
        tree = self.params
        if self.rank is not None:
            lead, flat = self._lead(), {}
            with tp.active(self.rank), torch.no_grad():
                for key, block in flatten(self.params).items():
                    full = tp.assemble(block.detach(),
                                       self.rank.leaves[key].spec,
                                       "checkpoint")
                    if lead:
                        flat[key] = full.cpu()
            tree = unflatten(flat)
        if self._lead():
            save_checkpoint(self.tc.checkpoint_dir, step, tree)
        if self.rank is not None:
            dist.barrier()

    def maybe_restore(self):
        last = latest_step(self.tc.checkpoint_dir)
        if last is not None:
            self.opt_state = None
            loaded = flatten(load_checkpoint(
                self.tc.checkpoint_dir, last, self.params,
                block=None if self.rank is None else self._block))
            # into the same tree, so whoever handed it in sees the restore
            with torch.no_grad():
                for key, p in flatten(self.params).items():
                    p.copy_(loaded[key])
            del loaded
            # rebuild optimizer state: adamw derives the next params from
            # its fp32 master, so a master still holding the random init
            # would silently revert the restore on the first step
            self.opt_state = init_opt_state(self.params, self.strategy,
                                            self.rank)
            self.step = last
        return self.step

    def _block(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full leaf ``key``."""
        return tp.shard_leaf(full, self.rank.leaves[key].spec,
                             tp.mesh_axes(self.mesh),
                             tp.coordinate(self.mesh))

    def run(self, steps: Optional[int] = None) -> Dict[str, list]:
        steps = steps or self.tc.steps
        t0 = time.time()
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(self.step).items()}
            with tp.active(self.rank) if self.rank is not None \
                    else nullcontext():
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch)
            self.step += 1
            if self.step % self.tc.log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=self.step, wall=round(time.time() - t0, 2))
                self.history.append(m)
                if self._lead():
                    print(f"step {self.step:5d}  loss {m['loss']:.4f}  "
                          f"grad_norm {m['grad_norm']:.3f}  "
                          f"wall {m['wall']}s", flush=True)
            if (self.tc.checkpoint_every and
                    self.step % self.tc.checkpoint_every == 0):
                self.save()
        return {"history": self.history}
