"""Data pipeline: deterministic synthetic LM data + memmapped token files
— the port's numpy-only copy of ``repro/data/pipeline.py``. Batches are
the reference's, seed for seed and step for step.

Synthetic corpus: a mixture of (a) Zipf-distributed unigrams and (b) short
arithmetic-progression motifs, so a small model's loss drops visibly
within a few hundred steps, with no download.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None          # memmapped .bin (uint32) corpus
    kind: str = "synthetic"             # synthetic | file


class TokenDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.kind == "file":
            if cfg.path is None:
                raise ValueError("DataConfig(kind='file') needs path=")
            self.tokens = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        else:
            self.tokens = None
        # Zipf weights over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1)
        w = 1.0 / ranks**1.1
        self._zipf = w / w.sum()

    def _synthetic_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
        b, s = cfg.global_batch, cfg.seq_len
        base = rng.choice(cfg.vocab_size, size=(b, s), p=self._zipf)
        # motif: arithmetic runs the model can learn to continue
        starts = rng.integers(0, cfg.vocab_size // 2, size=(b,))
        strides = rng.integers(1, 7, size=(b,))
        runlen = min(s, 32)
        pos = rng.integers(0, s - runlen + 1, size=(b,))
        for i in range(b):
            run = (starts[i] + strides[i] * np.arange(runlen)) % cfg.vocab_size
            base[i, pos[i]:pos[i] + runlen] = run
        return base.astype(np.int32)

    def _file_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        n = len(self.tokens) - cfg.seq_len - 1
        rng = np.random.default_rng(cfg.seed * 7_000_003 + step)
        idx = rng.integers(0, n, size=(cfg.global_batch,))
        return np.stack([self.tokens[i:i + cfg.seq_len] for i in idx]
                        ).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = (self._file_batch(step) if self.cfg.kind == "file"
                else self._synthetic_batch(step))
        labels = np.concatenate(
            [toks[:, 1:], np.full_like(toks[:, :1], -1)], axis=1)
        return {"tokens": toks, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def shard_batch(batch, mesh, batch_sharding):
    raise NotImplementedError(
        "shard_batch places a batch over a mesh: the parallelism slice, "
        "ROADMAP.md Queue 1 item 11")
