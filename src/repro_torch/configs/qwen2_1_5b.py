"""qwen2-1.5b [dense]: 28L d=1536 12H (GQA kv=2) ff=8960 vocab=151936.
QKV bias, tied embeddings.  [arXiv:2407.10671]

12 heads do not divide TP=16: heads are padded to 16 (zero out-projection
rows keep it exact; see DESIGN.md).  Full attention => long_500k skipped.
"""
from ..core.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936,
    act="swiglu", norm="rmsnorm", tie_embeddings=True,
    attn=AttnConfig(kind="full", rope_theta=1000000.0, qkv_bias=True,
                    chunk=1024),
)

SMOKE = ArchConfig(
    name="qwen2-1.5b-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    d_ff=140, vocab=512,
    act="swiglu", norm="rmsnorm", tie_embeddings=True,
    attn=AttnConfig(kind="full", qkv_bias=True, chunk=16),
)
