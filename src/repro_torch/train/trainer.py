"""Trainer: the end-to-end driver tying data, strategy, the train step,
metrics and checkpointing together — the port of
``repro/train/trainer.py`` on one explicit device (no mesh).

Preferred entry point: ``repro_torch.api.Session.train(...)``. The
trainer trains the param tree it is given IN PLACE (no private copy, as
the reference's donation needs: at Qwen3-14B width with 4 layers a copy
is 5.8 GB of bf16), so a Session's params are the trained ones after
``run``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core.strategy import Strategy, refuse_unported
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.kernels import flash_attention
from repro_torch.params import init_params
from repro_torch.train.step import init_opt_state, make_train_step
from repro_torch.tree import flatten


@dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    log_every: int = 10
    checkpoint_every: int = 0            # 0 = disabled
    checkpoint_dir: str = "checkpoints"
    seed: int = 0


def check_kernel_limits(cfg, strategy: Strategy, device) -> None:
    """On a CUDA device every attention over the sequence runs the flash
    kernel (``attn_impl`` ``auto`` or ``pallas``): each layer of a dense
    or MoE decoder, each application of the hybrid's shared block, each
    encoder and decoder self-attention of the enc-dec family, each self
    layer of the VLM (its cross-attention is plain).
    Refuse, before any parameter is made, heads it cannot take, rather
    than fail at the first step. The SSM family runs no attention, and
    trains through the plain SSD scan (the kernel has no backward):
    nothing to check."""
    if torch.device(device).type != "cuda" or \
            strategy.attn_impl not in ("auto", "pallas") or \
            cfg.arch_type not in ("dense", "moe", "hybrid", "audio", "vlm"):
        return
    why = flash_attention.kernel_limits(cfg.dtype, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim)
    if why:
        raise ValueError(
            f"{cfg.name}: training on {device} with attn_impl="
            f"{strategy.attn_impl!r} runs the flash-attention kernel, "
            f"which {why}")


class Trainer:
    def __init__(self, cfg, strategy: Strategy, device,
                 train_cfg: TrainConfig, data: Optional[TokenDataset] = None,
                 global_batch: int = 8, seq_len: int = 256, params=None):
        refuse_unported(strategy, "training")
        self.cfg, self.strategy = cfg, strategy
        self.device = torch.device(device)
        check_kernel_limits(cfg, strategy, self.device)
        self.tc = train_cfg
        self.data = data or TokenDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=train_cfg.seed))
        if params is None:
            params = init_params(cfg, device=self.device,
                                 seed=train_cfg.seed)
        self.params = params
        self.opt_state = init_opt_state(params, strategy)
        self._step_fn = make_train_step(cfg, strategy, lr=train_cfg.lr)
        self.step = 0
        self.history: list = []

    def maybe_restore(self):
        last = latest_step(self.tc.checkpoint_dir)
        if last is not None:
            self.opt_state = None
            loaded = load_checkpoint(self.tc.checkpoint_dir, last,
                                     self.params)
            # into the same tree, so whoever handed it in sees the restore
            loaded = flatten(loaded)
            with torch.no_grad():
                for key, p in flatten(self.params).items():
                    p.copy_(loaded[key])
            del loaded
            # rebuild optimizer state: adamw derives the next params from
            # its fp32 master, so a master still holding the random init
            # would silently revert the restore on the first step
            self.opt_state = init_opt_state(self.params, self.strategy)
            self.step = last
        return self.step

    def run(self, steps: Optional[int] = None) -> Dict[str, list]:
        steps = steps or self.tc.steps
        t0 = time.time()
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(self.step).items()}
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % self.tc.log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=self.step, wall=round(time.time() - t0, 2))
                self.history.append(m)
                print(f"step {self.step:5d}  loss {m['loss']:.4f}  "
                      f"grad_norm {m['grad_norm']:.3f}  "
                      f"wall {m['wall']}s", flush=True)
            if (self.tc.checkpoint_every and
                    self.step % self.tc.checkpoint_every == 0):
                save_checkpoint(self.tc.checkpoint_dir, self.step,
                                self.params)
        return {"history": self.history}
