"""Session — the port's execution facade (the serving half of
``repro/api/session.py``).

    from repro_torch.api import Session
    from repro_torch.configs import get_config

    session = Session(get_config("qwen3-14b"))          # on "cuda"
    engine = session.serve(slots=4, max_len=1024, chunk_tokens=256)
    engine.submit(0, prompt, max_new=16)
    results = engine.run()

One object owns the config, the device and the params (random from
``seed`` unless given — e.g. from the JAX package's checkpoint through
``repro_torch.params.load_npz``). ``serve`` takes the reference's keyword
names; the ones whose features are not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item. Training, generate,
the online stack and dry-runs come with later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine, _todo


class Session:
    """One (config, device, params) triple."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0, params=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.seed = seed
        self._params = params

    @property
    def params(self):
        """The param tree, random-initialised on first use from the
        session's seed."""
        if self._params is None:
            self._params = init_params(self.cfg, device=self.device,
                                       seed=self.seed)
        return self._params

    def serve(self, *, plan=None, tp: Optional[int] = None,
              dp: Optional[int] = None, slots: int = 4, max_len: int = 256,
              eos_id: Optional[int] = None, temperature: float = 0.0,
              seed: Optional[int] = None, paged: Optional[bool] = None,
              page_size: int = 16, kv_pages: Optional[int] = None,
              prefix_cache: bool = False, lazy: bool = False,
              scheduler=None, mixed: Optional[bool] = None,
              chunk_tokens: int = 256, attn_backend: Optional[str] = None,
              spec=None, trace_level: int = 1) -> ServeEngine:
        """Continuous-batching engine over this session's params on its
        device: the paged pool and ONE mixed token-slot program per step
        (see serve/engine.py). ``attn_backend`` exists for the
        reference's signature only: the device picks the kernel or the
        plain path."""
        if plan is not None or (tp or 1) > 1 or (dp or 1) > 1:
            raise _todo("plan=/tp=/dp= serving", "Queue 1 item 11")
        if attn_backend is not None:
            raise ValueError(
                "repro_torch picks the attention path by device (CUDA: "
                "the hand-written kernel, CPU: its plain version); drop "
                f"attn_backend={attn_backend!r}")
        return ServeEngine(
            self.cfg, self.params, slots=slots, max_len=max_len,
            eos_id=eos_id, temperature=temperature,
            seed=self.seed if seed is None else seed, paged=paged,
            page_size=page_size, kv_pages=kv_pages,
            prefix_cache=prefix_cache, lazy=lazy, scheduler=scheduler,
            mixed=mixed, chunk_tokens=chunk_tokens, spec=spec,
            trace_level=trace_level, device=self.device)
