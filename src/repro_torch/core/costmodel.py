"""Analytical cost model — the survey's §4 "strategy evaluation" problem.
The port's copy of ``repro/core/costmodel.py``, expression for
expression, with an H100 entry in the hardware table in place of the
reference's TPU entries.

Given (config, shape, parallel degrees, hardware), estimate the three
roofline terms + pipeline bubble + activation memory per device. This is the
evaluator the planner searches over (Alpa/TensorOpt use
profiling-calibrated models; ours is symbolic like Wang et al.'s double
recursive — paper Table 3 — but calibrated against the dry-run HLO).

Implements the survey's quantitative claims directly:
  * Megatron TP communication: 2 all-reduces per layer per microbatch fwd
    (one after attention out-proj, one after MLP row-matmul), 2 more in bwd
    [28, §5.1].
  * Korthikanti activation memory per layer:
        no SP :  s·b·h(10 + 24/t + 5·a·s/(h·t))
        SP    :  s·b·h/t · (34 + 5·a·s/h)            [14, §5.1]
  * GPipe bubble fraction: (p-1)/(m+p-1)             [11, Fig. 5]
  * DP gradient all-reduce: 2·(d-1)/d · P_local bytes [20/24-style]
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.opgraph import build_opgraph


@dataclass(frozen=True)
class Hardware:
    """One accelerator's rates and sizes, as the cost model reads them.
    The defaults are :data:`H100`'s."""
    peak_flops: float = 989e12        # dense bf16 a chip
    hbm_bw: float = 3.35e12
    ici_bw: float = 450e9             # per link, each way
    ici_links: int = 1
    dcn_bw: float = 50e9
    hbm_bytes: float = 80e9
    node_size: int = 8           # fast-interconnect island (0 = whole pod);
                                 # GPUs: NVLink node of 8


#: NVIDIA H100 SXM5, from its data sheet (constants, not measurements):
#: 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3, 80 GB, NVLink 4 at 900 GB/s
#: both ways (450 GB/s each way) within a node of 8, and 400 Gb/s NDR
#: InfiniBand a GPU between nodes (50 GB/s).
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, ici_links=1,
                dcn_bw=50e9, hbm_bytes=80e9, node_size=8)
A100 = Hardware(peak_flops=312e12, hbm_bw=2039e9, ici_bw=300e9, ici_links=1,
                dcn_bw=12.5e9, hbm_bytes=80e9, node_size=8)
V100 = Hardware(peak_flops=125e12, hbm_bw=900e9, ici_bw=150e9, ici_links=1,
                dcn_bw=12.5e9, hbm_bytes=32e9, node_size=8)


@dataclass(frozen=True)
class Degrees:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1        # expert parallel (shares the tp axis unless noted)
    microbatches: int = 1
    seq_parallel: bool = False
    remat: bool = True
    zero1: bool = True
    fsdp: bool = False

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.pp


def _allreduce_bytes(nbytes: float, n: int) -> float:
    """Ring all-reduce: 2 (n-1)/n per-device traffic."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * nbytes


def _allgather_bytes(nbytes: float, n: int) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) / n * nbytes


@dataclass
class CostBreakdown:
    t_compute: float
    t_memory: float
    t_collective: float
    bubble_fraction: float
    param_bytes_dev: float
    opt_bytes_dev: float
    act_bytes_dev: float
    fits: bool
    step_time: float
    mfu: float

    def row(self) -> dict:
        return dataclasses.asdict(self)


def activation_bytes_per_layer(cfg: ModelConfig, b_micro: int, seq: int,
                               tp: int, seq_parallel: bool) -> float:
    """Korthikanti et al. per-layer activation memory [14]."""
    s, b, h, a = seq, b_micro, cfg.d_model, max(cfg.num_heads, 1)
    if seq_parallel:
        return s * b * h * (34 + 5 * a * s / h) / tp
    return s * b * h * (10 + 24 / tp + 5 * a * s / (h * tp))


def estimate(cfg: ModelConfig, shape: ShapeConfig, deg: Degrees,
             hw: Hardware = H100, *, dcn_dp: int = 1) -> CostBreakdown:
    """Estimate one training (or prefill) step under ``deg``."""
    tokens = shape.global_batch * shape.seq_len
    graph = build_opgraph(cfg, shape.global_batch, shape.seq_len)
    fwd_flops = graph.total_flops()
    train = shape.kind == "train"
    mult = 3.0 if train else 1.0                  # bwd = 2x fwd
    if train and deg.remat:
        mult += 1.0                               # recompute fwd
    total_flops = fwd_flops * mult
    t_compute = total_flops / (deg.chips * hw.peak_flops)

    # ---- memory traffic: params read once per microbatch + activations
    param_bytes = graph.total_param_bytes()
    act_bytes = sum(n.act_bytes for n in graph.nodes) * (2 if train else 1)
    t_memory = (param_bytes * deg.microbatches / (deg.tp * deg.pp)
                + act_bytes / deg.chips) * mult / hw.hbm_bw

    # ---- collectives (per device)
    b_micro = shape.global_batch // (deg.dp * deg.microbatches) or 1
    sbh = shape.seq_len * b_micro * cfg.d_model * 2          # bf16 bytes
    n_layers = cfg.num_layers / deg.pp
    coll = 0.0
    tp_bw = hw.ici_bw * hw.ici_links
    if hw.node_size and deg.tp > hw.node_size:
        # intra-operator parallelism spilling past the fast-interconnect
        # island pays the slow link (the paper's takeaway #1 / §6)
        tp_bw = hw.dcn_bw
    coll_tp = 0.0
    if deg.tp > 1:
        per_layer_ar = 2 * (2 if train else 1)               # fwd(+bwd)
        vol = _allreduce_bytes(sbh, deg.tp)
        if deg.seq_parallel:
            # RS + AG replaces each AR at the same ring volume
            vol = _allreduce_bytes(sbh, deg.tp)
        coll_tp += n_layers * per_layer_ar * vol * deg.microbatches
    if cfg.is_moe and deg.ep > 1:
        # 2 all-to-alls fwd (+2 bwd): k/E of tokens leave the device
        a2a = sbh * cfg.experts_per_token / deg.ep
        coll += n_layers * (4 if train else 2) * a2a * deg.microbatches
    if train and deg.dp > 1:
        coll += _allreduce_bytes(param_bytes * 2 / (deg.tp * deg.pp), deg.dp)
    if deg.fsdp:
        coll += _allgather_bytes(param_bytes * 2 / (deg.tp * deg.pp),
                                 deg.dp) * deg.microbatches * mult / 3
    if deg.pp > 1:
        coll += 2 * sbh * deg.microbatches * (2 if train else 1)
    t_collective = coll / (hw.ici_bw * hw.ici_links) + coll_tp / tp_bw
    if dcn_dp > 1 and train:
        t_collective += _allreduce_bytes(
            param_bytes * 2 / (deg.tp * deg.pp), dcn_dp) / hw.dcn_bw

    # ---- pipeline bubble [11]
    m, p = deg.microbatches, deg.pp
    bubble = (p - 1) / (m + p - 1) if p > 1 else 0.0

    # ---- per-device memory
    param_dev = param_bytes * 2 / (deg.tp * deg.pp * (deg.dp if deg.fsdp
                                                      else 1))
    if not train:
        opt_dev = 0.0
    else:
        per_param = {"adamw": 16.0, "adafactor": 4.1}.get("adamw")
        opt_dev = (param_bytes * per_param / 2
                   / (deg.tp * deg.pp * (deg.dp if deg.zero1 else 1)))
    if train:
        if deg.remat:
            act_dev = (shape.seq_len * b_micro * cfg.d_model * 2
                       * n_layers / deg.tp)
        else:
            act_dev = (activation_bytes_per_layer(
                cfg, b_micro, shape.seq_len, deg.tp, deg.seq_parallel)
                * n_layers)
    else:
        act_dev = act_bytes / deg.chips
    fits = param_dev + opt_dev + act_dev < hw.hbm_bytes

    step = max(t_compute, t_memory, t_collective) / max(1e-9, (1 - bubble))
    model_flops = 6.0 * cfg.active_param_count() * tokens if train else \
        2.0 * cfg.active_param_count() * tokens
    mfu = model_flops / (deg.chips * hw.peak_flops * step) if step else 0.0
    return CostBreakdown(
        t_compute=t_compute, t_memory=t_memory, t_collective=t_collective,
        bubble_fraction=bubble, param_bytes_dev=param_dev,
        opt_bytes_dev=opt_dev, act_bytes_dev=act_dev, fits=fits,
        step_time=step, mfu=mfu)
