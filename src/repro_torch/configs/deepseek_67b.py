"""deepseek-67b [dense]: 95L d=8192 64H (GQA kv=8) ff=22016 vocab=102400.
Llama architecture (RMSNorm, SwiGLU, RoPE, untied).  [arXiv:2401.02954]

Full attention only => long_500k skipped.
"""
from ..core.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="full", rope_theta=10000.0, chunk=1024),
)

SMOKE = ArchConfig(
    name="deepseek-67b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=172, vocab=512,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="full", chunk=16),
)
