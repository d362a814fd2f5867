"""Strategy — the port's copy of ``repro/core/strategy.py`` for one device.

It keeps the execution knobs the training step reads: the optimizer, the
gradient-accumulation dtype, remat (activation checkpointing per layer,
survey §3.1.3), the microbatch count (GPipe Fig. 5d) and the attention
path. The sharding half — ``seq_parallel``, ``fsdp`` and ``rules()``,
which map logical axes onto a mesh — waits for the parallelism slice
(ROADMAP.md Queue 1 item 11); ``zero1`` shards optimizer state over data
replicas, so on one device it is accepted and does nothing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

_ITEM_11 = "the parallelism slice, ROADMAP.md Queue 1 item 11"


@dataclass(frozen=True)
class Strategy:
    name: str = "megatron"
    seq_parallel: bool = False       # Korthikanti SP: item 11
    zero1: bool = True               # optimizer-state sharding: no-op here
    fsdp: bool = False               # ZeRO-3 param sharding: item 11
    optimizer: str = "adamw"         # adamw | adafactor
    grad_accum_dtype: str = "float32"  # bfloat16 halves the accumulator
    remat: bool = True               # full activation checkpointing per layer
    microbatches: int = 1            # grad-accumulation steps
    attn_impl: str = "auto"          # auto | pallas | full | masked | triangle
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.seq_parallel or self.fsdp:
            raise NotImplementedError(
                f"seq_parallel / fsdp shard over a mesh: {_ITEM_11}")

    def rules(self, mesh=None) -> dict:
        raise NotImplementedError(f"Strategy.rules(mesh): {_ITEM_11}")

    def with_(self, **kw) -> "Strategy":
        return dataclasses.replace(self, **kw)
