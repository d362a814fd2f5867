"""Model / run configuration system.

The port's own copy of the JAX package's config registry: every assigned
architecture gets one ``src/repro_torch/configs/<id>.py`` exposing
``CONFIG: ModelConfig`` (full size) and ``smoke() -> ModelConfig`` (reduced
variant for CPU smoke tests). The registry in ``__init__`` maps
``--arch <id>`` to these.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    arch_type: str                      # one of ARCH_TYPES
    source: str = ""                    # citation for the config numbers

    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4                  # 0 => attention-free (pure SSM)
    num_kv_heads: int = 4               # GQA KV heads
    head_dim: int = 0                   # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192
    tie_embeddings: bool = False

    # attention options
    qk_norm: bool = False               # qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10000.0
    sliding_window: int = 0             # 0 => full attention; >0 => SWA width

    # MoE
    num_experts: int = 0                # 0 => dense FFN
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01       # load-balance loss weight

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0                  # N (state size per head); 0 => no SSM
    ssm_heads: int = 0                  # number of SSD heads
    ssm_head_dim: int = 64              # P (channels per head)
    ssm_chunk: int = 128                # SSD chunk length
    ssm_conv_width: int = 4             # short causal conv width

    # hybrid (zamba2-style): a SHARED full-attention block applied every k
    # mamba layers (weights shared across applications, caches are not).
    hybrid_attn_every: int = 0          # 0 => not hybrid

    # encoder-decoder (whisper-style). Frontend (mel+conv) is stubbed:
    # input_specs() provides (B, enc_ctx, d_model) frame embeddings.
    encoder_layers: int = 0
    encoder_ctx: int = 0                # e.g. 1500 audio frames

    # VLM (llama-3.2-vision-style): a cross-attention layer every k self-attn
    # layers. Vision tower is stubbed: input_specs() provides patch embeddings.
    cross_attn_every: int = 0           # 0 => not VLM
    num_image_tokens: int = 0           # e.g. 1601 patches

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # deployment knobs (not architecture): context-parallel decode attention
    # (models/cp_attention.py) — shard-local cache writes + psum-softmax.
    cp_decode: bool = False

    def __post_init__(self):
        assert self.arch_type in ARCH_TYPES, self.arch_type
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities (used by the cost model and docs) -------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.arch_type == "hybrid"

    @property
    def has_encoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def num_cross_layers(self) -> int:
        if self.cross_attn_every <= 0:
            return 0
        return self.num_layers // (self.cross_attn_every + 1)

    @property
    def num_self_layers(self) -> int:
        return self.num_layers - self.num_cross_layers

    def param_count(self) -> int:
        """Analytical parameter count (matches the initializers in models/)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += v * d                                  # embedding
        if not self.tie_embeddings:
            n += v * d                              # lm head
        if self.arch_type in ("dense", "moe", "vlm"):
            per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.is_moe:
                per_ffn = self.num_experts * (3 * d * f) + d * self.num_experts
            else:
                per_ffn = 3 * d * f                 # gated (SwiGLU) MLP
            per_layer = per_attn + per_ffn + 2 * d  # + norms
            n += self.num_self_layers * per_layer
            if self.num_cross_layers:
                per_cross = (d * self.q_dim + 2 * d * self.kv_dim
                             + self.q_dim * d + 3 * d * f + 3 * d)
                n += self.num_cross_layers * per_cross
        elif self.arch_type == "audio":
            per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            per_ffn = 2 * d * f                     # whisper uses plain GeLU MLP
            n += self.encoder_layers * (per_attn + per_ffn + 2 * d)
            n += self.num_layers * (2 * per_attn + per_ffn + 3 * d)
        elif self.arch_type in ("ssm", "hybrid"):
            H, P, N = self.ssm_heads, self.ssm_head_dim, self.ssm_state
            din = H * P
            per_ssm = (d * (2 * din + 2 * N + H)               # in_proj [z,x,B,C,dt] (G=1)
                       + (self.ssm_conv_width + 1) * (din + 2 * N)  # conv w+b
                       + H + 2 * H                              # dt_bias, A_log, D
                       + din                                    # gated-norm scale
                       + din * d + d)                           # out_proj + norm
            n += self.num_layers * per_ssm
            if self.is_hybrid:
                per_attn = (d * self.q_dim + 2 * d * self.kv_dim
                            + self.q_dim * d + 3 * d * self.d_ff + 2 * d)
                n += per_attn                       # ONE shared block
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_experts = self.num_experts - self.experts_per_token
        return self.param_count() - self.num_self_layers * dense_experts * 3 * d * f

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
