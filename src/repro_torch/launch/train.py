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

    # on the CPU, the reduced configs in float32
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch whisper-tiny --steps 2 --global-batch 2 --seq 32
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
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import Session
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
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
    args = ap.parse_args(argv)

    if args.full:
        cfg = get_config(args.arch)
        strategy = Strategy(microbatches=args.microbatches,
                            optimizer=args.optimizer, dtype=cfg.dtype)
    else:
        cfg = get_smoke(args.arch).with_(dtype="float32")
        strategy = Strategy(remat=False, microbatches=args.microbatches,
                            optimizer=args.optimizer, dtype="float32")
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
                            seq_len=args.seq)
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
    print(f"trained {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}) for {args.steps} steps of "
          f"{args.global_batch}x{args.seq} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tokens/s on {session.device}{peak})")
    return out


if __name__ == "__main__":
    main()
