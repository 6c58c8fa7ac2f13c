"""phi3-mini-3.8b [dense]: 32L d=3072 32H (kv=32, i.e. MHA) ff=8192
vocab=32064.  RoPE + SwiGLU.  [arXiv:2404.14219]

Full attention only => long_500k skipped.
"""
from ..core.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="full", rope_theta=10000.0, chunk=1024),
)

SMOKE = ArchConfig(
    name="phi3-mini-3.8b-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="full", chunk=16),
)
