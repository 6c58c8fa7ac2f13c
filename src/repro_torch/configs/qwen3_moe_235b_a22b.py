"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4, head_dim=128)
expert ff=1536 vocab=151936, 128 experts top-8 (no shared).
[hf:Qwen/Qwen3-30B-A3B scaled family]

Expert weights are EP-sharded over "model" (8 experts/chip on TP=16) and
FSDP-sharded over the data axes (DESIGN.md SS5).  Full attention =>
long_500k skipped.
"""
from ..core.config import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab=151936,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="full", rope_theta=1000000.0, chunk=1024),
    moe=MoEConfig(n_experts=128, top_k=8, n_shared=0, d_ff_expert=1536,
                  capacity_factor=1.25),
)

SMOKE = ArchConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=0, vocab=512,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="full", chunk=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_ff_expert=32),
)
