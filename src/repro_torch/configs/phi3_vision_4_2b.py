"""phi-3-vision-4.2b [vlm]: phi3-mini backbone (32L d=3072 32H kv=32 ff=8192
vocab=32064) + CLIP frontend.  The vision tower is a STUB per the assignment:
input_specs() supplies precomputed patch embeddings (B, 256, d_model), which
a learned projection maps into the token stream.
[hf:microsoft/Phi-3-vision-128k-instruct]

Full attention => long_500k skipped.
"""
from ..core.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, n_patches=256,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="full", rope_theta=10000.0, chunk=1024),
)

SMOKE = ArchConfig(
    name="phi-3-vision-4.2b-smoke", family="vlm",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, n_patches=8,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="full", chunk=16),
)
