"""Training launcher of the port: ``--arch`` through
``repro_torch.api.Session.train`` on one device — the counterpart of
``python -m repro.launch.train``.

    # on the card: full-width Qwen3-14B cut to 4 layers (random weights)
    PYTHONPATH=src python -m repro_torch.launch.train --full --layers 4 \\
        --steps 4 --global-batch 1 --seq 4096

    # on the card, full-width OLMoE-1B-7B cut to 4 layers
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --full --layers 4 --steps 4 --global-batch 1 --seq 4096

    # on the card, Zamba2-1.2B uncut (--arch mamba2-780m alike)
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --full --steps 4 --global-batch 1 --seq 4096

    # on the card, whisper-tiny uncut (tokens and seeded frames)
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --full --steps 4 --global-batch 8 --seq 448

    # on the card, full-width Llama-3.2-Vision-90B cut to one group (4
    # self + 1 cross layer; tokens and seeded images)
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama-3.2-vision-90b --full --layers 5 --optimizer adafactor \
        --steps 4 --global-batch 1 --seq 4096

    # sharded: dp 2 x tp 2 on four processes (torchrun; on one card the
    # ranks share it over gloo), ZeRO-1 by default, + FSDP / + SP
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --dp 2 --tp 2 --backend gloo --full --layers 2 --steps 3 \
        --global-batch 2 --seq 2048 --fsdp

    # whisper-tiny uncut at dp 2 x tp 2 (3 of 6 heads a rank), + SP
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch whisper-tiny --dp 2 --tp 2 --backend gloo --full --steps 3 \
        --global-batch 8 --seq 448 --seq-parallel

    # Llama-3.2-Vision-90B at full width, one group, dp 2 x tp 2 under
    # FSDP + SP + remat with Adafactor
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama-3.2-vision-90b --dp 2 --tp 2 --backend gloo --full \
        --layers 5 --optimizer adafactor --fsdp --seq-parallel --steps 3 \
        --global-batch 2 --seq 1024

    # the planner's production-mesh strategy (H100, 256 chips, the
    # "dp" search over train_4k), printed; nothing runs
    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b --plan

    # on the CPU, the reduced configs in float32
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --device cpu --dp 2 --tp 2 --steps 2 --global-batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch whisper-tiny --steps 2 --global-batch 2 --seq 32
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --device cpu --arch whisper-tiny --dp 2 --tp 2 --seq-parallel \
        --steps 2 --global-batch 4 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch llama-3.2-vision-90b --steps 2 --global-batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch mamba2-780m --steps 2 --global-batch 2 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch zamba2-1.2b --steps 2 --global-batch 2 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch kimi-k2-1t-a32b --steps 2 --global-batch 2 --seq 64

Without ``--full`` the arch's smoke config runs in float32 with remat off,
as the JAX launcher does; ``--full`` takes the arch's full ``CONFIG`` in
its own dtype (bfloat16) with the default Strategy (AdamW, remat on,
``attn_impl="auto"``: the flash kernel on the card where the family has
attention). ``--layers`` cuts the depth only. Dense and MoE decoders
(``--arch olmoe-1b-7b``: the loss adds ``router_aux_coef`` times the
router's load-balance loss), the SSM family (``--arch mamba2-780m``),
the hybrid (``--arch zamba2-1.2b``) and the enc-dec audio family
(``--arch whisper-tiny``: the token batches beside one batch of
``(global_batch, encoder_ctx, d_model)`` frames drawn from ``--seed``,
:class:`FramesData`) and the VLM (``--arch llama-3.2-vision-90b``: one
batch of ``(global_batch, num_image_tokens, d_model)`` image embeddings
beside the tokens, :class:`ImagesData`) train. ``--full`` needs more than
one card for Llama-3.2-Vision-90B uncut (~88.5 B parameters, ~177 GB in
bf16): on one H100 cut its depth with ``--layers`` (5 = one group: 4
self and 1 cross layer) and train it with ``--optimizer adafactor``
(AdamW's fp32 master, m and v would need >= 16 bytes a parameter).

``--tp N`` and ``--dp M`` train any family (``--arch whisper-tiny`` and
``--arch llama-3.2-vision-90b``: every rank draws the same
:class:`FramesData` / :class:`ImagesData` and takes its rows) on a
("data", "model") = (M, N) mesh under ``torchrun --nproc-per-node M*N``, one
process a rank (``Session.train(tp=, dp=)``): ZeRO-1 over "data" by
default, ``--fsdp`` (parameters over "data") and ``--seq-parallel``
(the reference's own flags); the process group's backend is
``--backend`` (default nccl on cuda, gloo on cpu; ranks sharing one
card need gloo). Rank 0 prints. ``--plan`` prints the planner's choice
for the arch's full config at ``SHAPES["train_4k"]`` on 256 H100s (the
"dp" search, ``core/planner.py``) and exits, as the reference's flag
does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import Session, plan
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, get_smoke
from repro_torch.core.strategy import Strategy
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.train.trainer import TrainConfig


class FramesData:
    """The synthetic token batches of ``TokenDataset`` beside one batch of
    standard-normal frame embeddings ``(global_batch, encoder_ctx,
    d_model)`` float32, drawn once from ``seed``: the enc-dec family's
    training data while its mel + conv frontend is stubbed."""

    #: the batch key of the embeddings, and the config field of their length
    KEY, LENGTH = "frames", "encoder_ctx"

    def __init__(self, cfg, *, global_batch: int, seq_len: int,
                 seed: int = 0):
        self.tokens = TokenDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=seed))
        self.embeds = np.random.default_rng(seed).standard_normal(
            (global_batch, getattr(cfg, self.LENGTH), cfg.d_model),
            dtype=np.float32)

    def batch(self, step: int):
        return {**self.tokens.batch(step), self.KEY: self.embeds}


class ImagesData(FramesData):
    """The twin of :class:`FramesData` for the VLM: token batches beside
    one batch of standard-normal image patch embeddings ``(global_batch,
    num_image_tokens, d_model)`` float32 from ``seed``, under
    ``image_embeds``, while the ViT tower and projector are stubbed."""

    KEY, LENGTH = "image_embeds", "num_image_tokens"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-14b")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full CONFIG in its own dtype "
                         "(default: the float32 smoke config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (width uncut)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"),
                    default="adamw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (under torchrun, "
                         "dp * tp processes)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree (under torchrun, dp * tp "
                         "processes)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="--tp / --dp: the process group's backend "
                         "(default nccl on cuda, gloo on cpu)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Korthikanti sequence parallelism over 'model'")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: parameters sharded over 'data'")
    ap.add_argument("--plan", action="store_true",
                    help="print the planner's production-mesh strategy and "
                         "exit")
    args = ap.parse_args(argv)
    if args.plan:
        p = plan(get_config(args.arch), SHAPES["train_4k"], 256,
                 method="dp")
        line = f"{args.arch}: {p.summary()}"
        print(line)
        return line
    sharded = args.tp * args.dp > 1
    if sharded:
        from repro_torch.launch.serve import _join_ranks
        _join_ranks(args)
    lead = not sharded or torch.distributed.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    knobs = dict(microbatches=args.microbatches, optimizer=args.optimizer,
                 seq_parallel=args.seq_parallel, fsdp=args.fsdp)

    if args.full:
        cfg = get_config(args.arch)
        strategy = Strategy(dtype=cfg.dtype, **knobs)
    else:
        cfg = get_smoke(args.arch).with_(dtype="float32")
        strategy = Strategy(remat=False, dtype="float32", **knobs)
    if args.layers:
        cfg = cfg.with_(num_layers=args.layers)
    session = Session(cfg, strategy=strategy, device=args.device,
                      seed=args.seed)
    tc = TrainConfig(steps=args.steps, lr=args.lr, log_every=10,
                     checkpoint_every=args.steps if args.checkpoint_dir
                     else 0,
                     checkpoint_dir=args.checkpoint_dir or "checkpoints",
                     seed=args.seed)
    data_cls = {"audio": FramesData, "vlm": ImagesData}.get(cfg.arch_type)
    data = data_cls(cfg, global_batch=args.global_batch, seq_len=args.seq,
                    seed=args.seed) if data_cls else None
    trainer = session.train(tc, data=data, global_batch=args.global_batch,
                            seq_len=args.seq, tp=args.tp, dp=args.dp)
    on_card = session.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(session.device)
    t0 = time.perf_counter()
    out = trainer.run()
    if on_card:
        torch.cuda.synchronize(session.device)
    dt = time.perf_counter() - t0
    tokens = args.steps * args.global_batch * args.seq
    peak = (f", peak memory "
            f"{torch.cuda.max_memory_allocated(session.device) / 1e9:.2f} GB"
            if on_card else "")
    par = "" if not sharded else (
        f", dp {args.dp} x tp {args.tp} over "
        f"{torch.distributed.get_backend()}"
        + "".join(f", {k}" for k in ("fsdp", "seq_parallel")
                  if getattr(strategy, k))
        + f"; a rank's collectives {dict(trainer.rank.counts)}")
    log(f"trained {cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}) for {args.steps} steps of "
        f"{args.global_batch}x{args.seq} tokens in {dt:.2f}s "
        f"({tokens / dt:.1f} tokens/s on {session.device}{peak}{par})")
    return out


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
