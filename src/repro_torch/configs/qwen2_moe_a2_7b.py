"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (kv=16) expert ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts, QKV bias.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

60 experts pad to 64 for EP divisibility on TP=16 (router masks the pads).
Full attention => long_500k skipped.
"""
from ..core.config import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=151936,
    act="swiglu", norm="rmsnorm", tie_embeddings=True,
    attn=AttnConfig(kind="full", rope_theta=1000000.0, qkv_bias=True,
                    chunk=1024),
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408,
                  capacity_factor=1.25),
)

SMOKE = ArchConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512,
    act="swiglu", norm="rmsnorm", tie_embeddings=True,
    attn=AttnConfig(kind="full", qkv_bias=True, chunk=16),
    moe=MoEConfig(n_experts=6, top_k=2, n_shared=2, d_ff_expert=32),
)
