"""Speculative multi-token decode over the mixed step — the port of
``repro/serve/speculative.py``.

A cheap DRAFTER guesses each decoding slot's next ``k`` tokens; the
engine packs them as extra rows of the slot in the same mixed program
(consecutive positions, one dispatch), accepts the longest prefix that
matches the verifier's own argmax chain, plus one bonus token from the
verifier's logits. Every emitted token is an argmax of the verifier at
its position, so greedy output equals non-speculative decode token for
token; a bad draft costs budget rows, never tokens. Rejected draft KV is
invisible (attention masks by ``pos``) and the pages it took under lazy
growth go back through ``PageAllocator.rollback``.

Two self-speculative drafters, as the reference's:

  * :class:`NgramDrafter` (``drafter="ngram"``, the default) — prompt
    lookup: the continuation of the most recent earlier occurrence of the
    context's longest trailing n-gram. Host numpy, a copy of the
    reference's.
  * :class:`DraftModelDrafter` (``drafter="model"``) — a small greedy
    dense model of the port (``models.get_model(cfg).forward``) on the
    engine's device, over the context padded to a power-of-two bucket
    (``serve/step.py::prefill_bucket``), so it runs at most
    log2(max_len) shapes. On CUDA its forward goes through the flash and
    fused-MLP kernels (no plain fallback there); on the CPU through their
    plain versions. Omitted ``draft_params`` are drawn from a
    ``torch.Generator`` seeded with ``seed + draft_seed`` (the port's own
    draws, not ``jax.random``'s).

``SpecConfig`` is accepted by ``ServeEngine(spec=)`` /
``Session.serve(spec=)`` and needs the mixed step and ``temperature ==
0``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

DRAFTERS = ("ngram", "model")


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode knobs for ``ServeEngine(spec=...)``.

    ``k`` drafted tokens are verified per slot per step (the engine
    packs ``k + 1`` rows — draft rows plus the slot's base decode row —
    so ``chunk_tokens`` must cover ``slots * (k + 1)``). ``ngram_min`` /
    ``ngram_max`` bound the n-gram match length of the prompt-lookup
    drafter (longest first). ``draft_cfg``/``draft_params``/
    ``draft_seed`` configure the small-model drafter; ``draft_cfg=None``
    with ``drafter="model"`` derives a 1-layer dense config over the
    verifier's vocab, and ``draft_params=None`` initializes it fresh
    from ``draft_seed``.
    """
    k: int = 4
    drafter: str = "ngram"
    ngram_min: int = 1
    ngram_max: int = 4
    draft_cfg: Optional[object] = None       # ModelConfig for "model"
    draft_params: Optional[object] = None    # param tree for "model"
    draft_seed: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec.k must be >= 1, got {self.k}")
        if self.drafter not in DRAFTERS:
            raise ValueError(
                f"spec.drafter must be one of {'/'.join(DRAFTERS)}, "
                f"got {self.drafter!r}")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"{self.ngram_min}/{self.ngram_max}")


class NgramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the context's longest trailing n-gram.

    ``propose(ctx, k)`` takes the slot's full known token sequence
    (prompt + every generated token, the pending one included) and
    returns up to ``k`` drafted continuation tokens — possibly EMPTY
    (no n-gram of length >= ``ngram_min`` recurs), in which case the
    engine packs a plain one-row decode for the slot. Longest n-gram
    first (``ngram_max`` down to ``ngram_min``), most recent match
    wins: repetitive contexts draft their own loop body.
    """

    def __init__(self, *, ngram_min: int = 1, ngram_max: int = 4):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"{ngram_min}/{ngram_max}")
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max

    def propose(self, ctx: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(ctx).reshape(-1)
        n = len(ctx)
        for g in range(min(self.ngram_max, n - 1), self.ngram_min - 1, -1):
            tail = ctx[n - g:]
            # most recent earlier occurrence with at least one
            # continuation token to propose
            for i in range(n - g - 1, -1, -1):
                if np.array_equal(ctx[i:i + g], tail):
                    cont = ctx[i + g:i + g + k]
                    return np.asarray(cont, np.int64)
        return np.zeros((0,), np.int64)


class DraftModelDrafter:
    """Greedy small-model drafting: a separate (tiny, dense) model
    proposes the next ``k`` tokens by its own argmax.

    The draft forward runs over the context padded to a power-of-two
    bucket (``serve/step.prefill_bucket``), so it runs at most
    log2(max_len) shapes whatever the context length. Causal attention
    makes tail padding invisible to every real position, so one buffer
    serves all ``k`` proposal steps: token ``i``'s draft is the argmax at
    position ``len(ctx) - 1 + i`` after writing the previous drafts into
    the buffer. ``device`` is where the forward runs (the engine's).
    """

    def __init__(self, cfg, params=None, *, max_len: int = 256,
                 seed: int = 0, device="cpu"):
        from repro_torch.models import get_model
        from repro_torch.params import init_params

        if cfg.arch_type != "dense":
            raise ValueError(
                f"{cfg.name}: the draft model must be a dense decoder "
                f"(row-independent greedy argmax), not {cfg.arch_type}")
        self.cfg = cfg
        self.max_len = int(max_len)
        self.device = torch.device(device)
        self.model = get_model(cfg)
        self.params = params if params is not None else init_params(
            cfg, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(seed))

    def propose(self, ctx: np.ndarray, k: int) -> np.ndarray:
        from repro_torch.serve.step import prefill_bucket

        ctx = np.asarray(ctx).reshape(-1)
        n = len(ctx)
        k = min(int(k), self.max_len - n)
        if k <= 0:
            return np.zeros((0,), np.int64)
        b = prefill_bucket(n + k, cap=self.max_len)
        buf = np.zeros((1, b), np.int32)
        buf[0, :n] = ctx
        out = []
        with torch.no_grad():
            for i in range(k):
                tokens = torch.from_numpy(buf).to(self.device)
                logits = self.model.forward(self.params, {"tokens": tokens},
                                            self.cfg)[0]
                t = int(torch.argmax(logits[0, n - 1 + i]))
                out.append(t)
                if n + i < b:
                    buf[0, n + i] = t
        return np.asarray(out, np.int64)


def default_draft_cfg(cfg):
    """The reference's default draft model: one fp32 dense layer over the
    verifier's vocabulary."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=f"{cfg.name}-draft", arch_type="dense", num_layers=1,
        d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
        vocab_size=cfg.vocab_size, dtype="float32")


def make_drafter(spec: SpecConfig, cfg, *, max_len: int, seed: int = 0,
                 device="cpu"):
    """Build the drafter a :class:`SpecConfig` names. ``cfg`` is the
    VERIFIER's config — the "model" drafter derives its default tiny
    draft config from it (1 dense layer over the same vocab) when
    ``spec.draft_cfg`` is omitted."""
    if spec.drafter == "ngram":
        return NgramDrafter(ngram_min=spec.ngram_min,
                            ngram_max=spec.ngram_max)
    draft_cfg = spec.draft_cfg
    if draft_cfg is None:
        draft_cfg = default_draft_cfg(cfg)
    if draft_cfg.vocab_size < cfg.vocab_size:
        raise ValueError(
            f"draft model vocab {draft_cfg.vocab_size} < verifier vocab "
            f"{cfg.vocab_size}: the drafter could never propose every "
            "token")
    return DraftModelDrafter(draft_cfg, spec.draft_params,
                             max_len=max_len,
                             seed=seed + spec.draft_seed, device=device)
