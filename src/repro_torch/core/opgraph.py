"""Operator-graph IR — the paper's §3.1.2 formal framework, executable.
The port's copy of ``repro/core/opgraph.py``: the same nodes, the same
expressions in the same order, so the totals are the reference's bit for
bit.

O = (V, E): nodes are operators (with FLOPs, param bytes, activation bytes)
or tensors; edges carry tensors between operators. We build the graph
analytically from a ModelConfig — it is the substrate for:

  * the cost model (core/costmodel.py) — per-node compute/memory terms,
  * the planner's inter-operator (pipeline) partitioning — balanced
    stage cuts over node FLOPs (RaNNC/FTPipe-style, paper Table 3),
  * the parallelisable-dimension bookkeeping (paper §3.1: sample /
    attribute / parameter / operator — FlexFlow's SOAP dims).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass
class OpNode:
    name: str
    kind: str                      # matmul | attention | norm | embed | ...
    flops: float                   # forward FLOPs for the whole batch
    param_bytes: float
    act_bytes: float               # output activation bytes
    # SOAP-style parallelisable dims: logical-dim -> max degree
    parallel_dims: Dict[str, int] = field(default_factory=dict)
    layer: Optional[int] = None    # layer index (None = trunk-level)


@dataclass
class OpGraph:
    nodes: List[OpNode]
    edges: List[Tuple[str, str]]
    cfg: ModelConfig

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    def total_param_bytes(self) -> float:
        return sum(n.param_bytes for n in self.nodes)

    def layer_nodes(self) -> Dict[int, List[OpNode]]:
        out: Dict[int, List[OpNode]] = {}
        for n in self.nodes:
            if n.layer is not None:
                out.setdefault(n.layer, []).append(n)
        return out

    def balanced_stages(self, num_stages: int) -> List[List[int]]:
        """Greedy balanced partition of layers into pipeline stages by
        FLOPs (the inter-operator search sub-problem, paper §4)."""
        per_layer = {k: sum(n.flops for n in v)
                     for k, v in self.layer_nodes().items()}
        layers = sorted(per_layer)
        total = sum(per_layer.values())
        target = total / num_stages
        stages, cur, acc = [], [], 0.0
        for li in layers:
            cur.append(li)
            acc += per_layer[li]
            if acc >= target * (len(stages) + 1) and len(stages) < num_stages - 1:
                stages.append(cur)
                cur = []
        stages.append(cur)
        while len(stages) < num_stages:
            stages.append([])
        return stages


def _bytes(n: float, dtype_bytes: int = 2) -> float:
    return n * dtype_bytes


def build_opgraph(cfg: ModelConfig, batch: int, seq: int) -> OpGraph:
    """Analytical operator graph for one forward pass of ``batch x seq``."""
    b, s, d, f, v = batch, seq, cfg.d_model, cfg.d_ff, cfg.vocab_size
    t = b * s
    nodes: List[OpNode] = []
    edges: List[Tuple[str, str]] = []
    prev = "embed"
    nodes.append(OpNode("embed", "embed", 0.0, _bytes(v * d),
                        _bytes(t * d), {"sample": b, "vocab": v}))

    def attn_nodes(li: int, prefix: str, kv_len: int, heads: int,
                   kv_heads: int):
        hd = cfg.head_dim
        qkv_flops = 2 * t * d * (heads * hd + 2 * kv_heads * hd)
        if cfg.sliding_window:
            kv_eff = min(kv_len, cfg.sliding_window)
        else:
            kv_eff = kv_len
        att_flops = 2 * 2 * t * kv_eff * heads * hd  # QK^T + PV (causal ~ /2)
        out_flops = 2 * t * heads * hd * d
        ns = [
            OpNode(f"{prefix}{li}.qkv", "matmul", qkv_flops,
                   _bytes(d * (heads + 2 * kv_heads) * hd),
                   _bytes(t * (heads + 2 * kv_heads) * hd),
                   {"parameter": heads, "sample": b}, li),
            OpNode(f"{prefix}{li}.attn", "attention", att_flops, 0.0,
                   _bytes(t * heads * hd),
                   {"attribute": heads, "sample": b}, li),
            OpNode(f"{prefix}{li}.out", "matmul", out_flops,
                   _bytes(heads * hd * d), _bytes(t * d),
                   {"parameter": heads, "sample": b}, li),
        ]
        return ns

    def mlp_nodes(li: int, gated: bool = True):
        n_mats = 3 if gated else 2
        return [OpNode(f"mlp{li}", "matmul", 2 * t * d * f * n_mats,
                       _bytes(n_mats * d * f), _bytes(t * f),
                       {"parameter": f, "sample": b}, li)]

    def moe_nodes(li: int):
        k, e = cfg.experts_per_token, cfg.num_experts
        return [
            OpNode(f"router{li}", "matmul", 2 * t * d * e, _bytes(d * e, 4),
                   _bytes(t * e, 4), {"sample": b}, li),
            OpNode(f"experts{li}", "moe", 2 * t * k * d * cfg.d_ff * 3,
                   _bytes(e * 3 * d * cfg.d_ff), _bytes(t * k * cfg.d_ff),
                   {"parameter": e, "sample": b}, li),
        ]

    def ssm_nodes(li: int):
        h, p_, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        din = h * p_
        q = cfg.ssm_chunk
        proj = 2 * t * d * (2 * din + 2 * n + h)
        intra = 2 * t * q * (n + h * p_)          # C.B^T + att@x per chunk
        inter = 2 * t * n * h * p_                # state update + C.h
        outp = 2 * t * din * d
        return [
            OpNode(f"ssm{li}.proj", "matmul", proj,
                   _bytes(d * (2 * din + 2 * n + h)), _bytes(t * 2 * din),
                   {"parameter": h, "sample": b}, li),
            OpNode(f"ssm{li}.ssd", "ssd", intra + inter, 0.0,
                   _bytes(t * din), {"attribute": h, "sample": b}, li),
            OpNode(f"ssm{li}.out", "matmul", outp, _bytes(din * d),
                   _bytes(t * d), {"parameter": h, "sample": b}, li),
        ]

    li = 0
    if cfg.arch_type in ("dense", "moe", "vlm"):
        for li in range(cfg.num_layers):
            is_cross = (cfg.cross_attn_every > 0 and
                        (li + 1) % (cfg.cross_attn_every + 1) == 0)
            kv_len = cfg.num_image_tokens if is_cross else s
            ns = attn_nodes(li, "xattn" if is_cross else "attn", kv_len,
                            cfg.num_heads, cfg.num_kv_heads)
            ns += moe_nodes(li) if (cfg.is_moe and not is_cross) \
                else mlp_nodes(li)
            nodes += ns
    elif cfg.arch_type == "ssm":
        for li in range(cfg.num_layers):
            nodes += ssm_nodes(li)
    elif cfg.arch_type == "hybrid":
        g = cfg.num_layers // cfg.hybrid_attn_every
        for li in range(cfg.num_layers):
            nodes += ssm_nodes(li)
            if (li + 1) % cfg.hybrid_attn_every == 0:
                nodes += attn_nodes(li, "shared_attn", s, cfg.num_heads,
                                    cfg.num_kv_heads)
                nodes += mlp_nodes(li)
    elif cfg.arch_type == "audio":
        for li in range(cfg.encoder_layers):
            nodes += attn_nodes(li, "enc_attn", cfg.encoder_ctx,
                                cfg.num_heads, cfg.num_kv_heads)
            nodes += mlp_nodes(li, gated=False)
        for lj in range(cfg.num_layers):
            li = cfg.encoder_layers + lj
            nodes += attn_nodes(li, "dec_attn", s, cfg.num_heads,
                                cfg.num_kv_heads)
            nodes += attn_nodes(li, "dec_xattn", cfg.encoder_ctx,
                                cfg.num_heads, cfg.num_kv_heads)
            nodes += mlp_nodes(li, gated=False)

    nodes.append(OpNode("lm_head", "matmul", 2 * t * d * v, _bytes(d * v),
                        _bytes(t * v), {"parameter": v, "sample": b},
                        None))
    names = [n.name for n in nodes]
    edges = list(zip(names[:-1], names[1:]))
    return OpGraph(nodes, edges, cfg)
