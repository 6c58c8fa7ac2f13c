"""Configuration system for the repro framework (the port's own
copy of ``repro.core.config``, which is pure Python).

Every architecture / input-shape / mesh combination is described by plain,
hashable dataclasses so configs can be used as jit static arguments, diffed,
serialized into checkpoints, and printed into experiment logs.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    n_experts: int = 0            # routed experts (0 => dense MLP)
    top_k: int = 0
    n_shared: int = 0             # always-on shared experts (qwen2-moe style)
    d_ff_expert: int = 0          # hidden dim of each routed expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent block configuration (xLSTM, Mamba)."""
    kind: str = "none"            # "none" | "xlstm" | "mamba"
    d_state: int = 16             # mamba SSM state size
    d_conv: int = 4               # mamba local conv width
    expand: int = 2               # mamba inner expansion
    slstm_every: int = 0          # xlstm: a sLSTM block every N layers (0 => all mLSTM)
    chunk: int = 64               # chunkwise-parallel scan chunk length

    @property
    def enabled(self) -> bool:
        return self.kind != "none"


@dataclass(frozen=True)
class AttnConfig:
    """Per-architecture attention behaviour."""
    kind: str = "full"            # "full" | "sliding" | "none"
    window: int = 0               # sliding-window size (tokens), 0 => full
    chunk: int = 1024             # online-softmax KV chunk for long sequences
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    softcap: float = 0.0          # logit soft-capping (0 => off)

    @property
    def sub_quadratic(self) -> bool:
        return self.kind in ("sliding", "none")


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    act: str = "swiglu"           # swiglu | gelu | relu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    parallel_residual: bool = False   # command-r style parallel attn+mlp
    tie_embeddings: bool = False
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # encoder-decoder (whisper)
    n_enc_layers: int = 0         # 0 => decoder-only
    # multimodal stub frontend
    n_patches: int = 0            # vlm: patch embeddings prepended to the sequence
    # numerics
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (unpadded, matches the published size)."""
        d, hd = self.d_model, self.head_dim_
        nh, nkv = self.n_heads, self.n_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d  # q,k,v,o
        if self.attn.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        if self.moe.enabled:
            e = self.moe
            mlp = e.n_experts * 3 * d * e.d_ff_expert + d * e.n_experts  # experts + router
            mlp += e.n_shared * 3 * d * e.d_ff_expert
        elif self.d_ff > 0:
            n_mat = 3 if self.act == "swiglu" else 2
            mlp = n_mat * d * self.d_ff
        else:
            mlp = 0
        if self.ssm.enabled and self.ssm.kind == "xlstm":
            # mLSTM block: up/z proj + headwise qkv + gates + down proj
            inner = self.ssm.expand * d
            mlp = 0
            attn = (2 * d * inner                      # up, z
                    + 3 * inner * inner // self.n_heads  # headwise qkv
                    + inner * d                        # down
                    + 2 * inner * self.n_heads + 2 * self.n_heads)
        if self.ssm.enabled and self.ssm.kind == "mamba":
            inner = self.ssm.expand * d
            attn += 2 * d * inner + inner * self.ssm.d_state * 2 + inner * d
        per_layer = attn + mlp + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = self.n_layers * per_layer + emb + d
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn (already in n_layers count)
            enc = self.n_enc_layers * (attn + mlp + 2 * d)
            dec_cross = self.n_layers * (attn + d)
            total += enc + dec_cross
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active params (= total for dense; routed subset for MoE)."""
        if not self.moe.enabled:
            return self.param_count()
        active_cfg = dataclasses.replace(
            self, moe=dataclasses.replace(
                self.moe, n_experts=self.moe.top_k))
        return active_cfg.param_count()


# ---------------------------------------------------------------------------
# Input-shape config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in SHAPES]}")


# ---------------------------------------------------------------------------
# Run config (training/serving hyperparameters independent of the arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RunConfig:
    microbatches: int = 1         # gradient-accumulation steps
    remat: bool = True            # activation checkpointing inside the layer scan
    zero1: bool = True            # shard optimizer moments over data axis
    grad_compression: str = "none"  # "none" | "bf16" — cross-replica reduce dtype
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    seed: int = 0
    # serving
    decode_microbatch: int = 0    # 0 => whole batch at once
    # beyond-paper perf knobs (hillclimbed in EXPERIMENTS.md §Perf)
    fsdp: bool = False            # shard params over data axis too (ZeRO-3 style)
    seq_shard: bool = False       # sequence-parallel activations for norm/mlp


# ---------------------------------------------------------------------------
# Serialization helpers
# ---------------------------------------------------------------------------

def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
