"""Parallelisation Strategy — the port of ``repro/core/strategy.py``.

A Strategy fixes, for a given mesh, how each parallelisable dimension
(survey §3.1.2) maps onto mesh axes — dp on "data" (x "pod"), tp and ep
on "model" (Megatron §5.1), sp (Korthikanti) on "model" — plus the
execution knobs the training step reads: the optimizer, the
gradient-accumulation dtype, remat (activation checkpointing per layer,
survey §3.1.3), the microbatch count (GPipe Fig. 5d) and the attention
path.

``rules(mesh)`` is the reference's logical-axis table. It reads only the
mesh's axis names and sizes, so it takes a plain ``{axis: size}`` mapping
as well as a ``torch.distributed`` ``DeviceMesh`` (``mesh_axes``): the
sharding tables (``core/sharding.py``) need no process group. What the
port runs on a mesh: serving tensor-parallel dense and MoE decoders (the
experts over "model" with ``expert_parallel``, each expert's d_ff over
it without), the enc-dec family, the
SSM family and the hybrid (``serve/engine.py``), data-parallel replicas
over "data" (``serve/parallel.py``), and training dense and MoE
decoders, the SSM family, the hybrid and the enc-dec family on a
("data", "model") mesh (``train/trainer.py``, ``train/step.py``):
gradient sums over "data", ``zero1`` (optimizer state over "data"),
``fsdp`` (parameters over "data", gathered a layer at a time),
Megatron TP and an MoE's experts (or each expert's d_ff) over "model",
and ``seq_parallel`` (the residual stream sequence-sharded over
"model"). On one device ``zero1``, ``fsdp`` and ``seq_parallel`` are
accepted and change nothing. An engine on a mesh takes both and serves
the Megatron layout under them (``serving``), as the reference's engine
does: no model code of the reference constrains the "seq" axis, and its
engines run on a replica mesh whose "data" axis has size 1.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Mapping


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its dim names and
    ``size(dim)``), or of a mapping given as it is."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names "
                         "(e.g. ('data', 'model'))")
    return {name: int(mesh.size(i)) for i, name in enumerate(names)}


@dataclass(frozen=True)
class Strategy:
    name: str = "megatron"
    # parallel degrees are implied by the mesh axes; these flags pick HOW
    # the logical dims map onto them.
    seq_parallel: bool = False       # Korthikanti SP (training on a mesh)
    expert_parallel: bool = True     # MoE experts on "model" (vs TP-in-expert)
    zero1: bool = True               # shard optimizer states over "data"
    fsdp: bool = False               # ZeRO-3 param sharding over "data"
    optimizer: str = "adamw"         # adamw | adafactor
    grad_accum_dtype: str = "float32"  # bfloat16 halves the accumulator
    remat: bool = True               # full activation checkpointing per layer
    microbatches: int = 1            # grad-accumulation steps
    attn_impl: str = "auto"          # auto | pallas | full | masked | triangle
    dtype: str = "bfloat16"

    def rules(self, mesh) -> dict:
        """Logical-axis -> mesh-axis table (the reference's, entry for
        entry) for a ``DeviceMesh`` or an ``{axis: size}`` mapping."""
        axes = tuple(mesh_axes(mesh))
        batch = tuple(a for a in ("pod", "data") if a in axes) or None
        if batch and len(batch) == 1:
            batch = batch[0]
        return {
            "batch": batch,
            "seq": "model" if self.seq_parallel else None,
            "heads": "model",
            "kv_heads": "model",
            "d_ff": "model",
            "vocab": "model",
            "ssm_inner": "model",
            "ssm_heads": "model",
            "experts": "model" if self.expert_parallel else None,
            "d_ff_moe": None if self.expert_parallel else "model",
            # the expert-capacity dim of the (E, C, d) dispatch buffer
            "moe_cap": batch,
            # the dispatch scatter / combine gather index dim 0 only
            "moe_dispatch_d": "model",
            "d_model": None,
        }

    def with_(self, **kw) -> "Strategy":
        return dataclasses.replace(self, **kw)


MEGATRON_BASELINE = Strategy(name="megatron", seq_parallel=False)
MEGATRON_SP = Strategy(name="megatron+sp", seq_parallel=True)


def serving(strategy: Strategy) -> Strategy:
    """The layout an engine on a mesh serves under ``strategy``: the
    same with ``seq_parallel`` and ``fsdp`` off. The reference's engine
    takes both and serves the Megatron layout: no ``constrain`` of its
    models names the "seq" axis, and every engine runs on a ``(1, tp)``
    replica mesh (``repro/api/session.py:258-274``), where FSDP's "data"
    has size 1. The port's engine on a (dp, tp) router's mesh shards
    over "model" only: an FSDP block over "data" would cut a leaf across
    replicas that step on their own."""
    return strategy.with_(seq_parallel=False, fsdp=False)
