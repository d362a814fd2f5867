"""Data pipeline: deterministic synthetic LM data + memmapped token files
— the port's numpy-only copy of ``repro/data/pipeline.py``. Batches are
the reference's, seed for seed and step for step.

Synthetic corpus: a mixture of (a) Zipf-distributed unigrams and (b) short
arithmetic-progression motifs, so a small model's loss drops visibly
within a few hundred steps, with no download.

``shard_batch`` gives a data rank its rows of a global batch (the
reference's ``batch_shardings`` and ``shard_batch``): its contiguous
share of every microbatch where the batch splits over "data"
(``rows_split``), else the whole batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch


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


def rows_split(global_batch: int, dp: int, microbatches: int = 1) -> bool:
    """Whether a batch of ``global_batch`` rows goes over "data" (the
    reference's ``batch_shardings``: the batch over "data" where it
    divides, else whole on every data rank). With ``microbatches`` each
    data rank holds its contiguous share of every microbatch
    (``shard_batch``), so each microbatch must divide too."""
    return dp > 1 and global_batch % microbatches == 0 and \
        (global_batch // microbatches) % dp == 0


def shard_batch(batch: Dict[str, np.ndarray], dp: int, index: int, *,
                microbatches: int = 1):
    """Data rank ``index`` of ``dp``'s rows of ``batch`` (numpy arrays or
    tensors, rows first): the whole batch where it does not split
    (:func:`rows_split`), else its contiguous share of every microbatch —
    the reference's microbatch ``i`` is the global rows ``[i * mb, (i +
    1) * mb)`` (``repro/train/step.py:67-71``), and this rank's rows of
    it ``[i * mb + index * mb / dp, ...)`` — in microbatch order, so the
    step's own split of the rank's rows into ``microbatches`` gives its
    share of each."""
    rows = len(next(iter(batch.values())))
    if not rows_split(rows, dp, microbatches):
        return dict(batch)
    mb = rows // microbatches
    per = mb // dp
    take = np.concatenate([np.arange(i * mb + index * per,
                                     i * mb + (index + 1) * per)
                           for i in range(microbatches)])
    out = {}
    for key, v in batch.items():
        if isinstance(v, np.ndarray):
            out[key] = v[take]
        else:
            # slices (one view a microbatch), the same ops on any device
            parts = [v[i * mb + index * per:i * mb + (index + 1) * per]
                     for i in range(microbatches)]
            out[key] = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out
