"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) ff=22528 vocab=256000.
Cohere arch: parallel attention+MLP residual, layernorm, no biases, tied
embeddings, RoPE.  [hf:CohereForAI/c4ai-command-r-v01]

Full attention only => long_500k is skipped (DESIGN.md SS-Arch-applicability).
"""
from ..core.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000,
    act="swiglu", norm="layernorm", parallel_residual=True,
    tie_embeddings=True,
    attn=AttnConfig(kind="full", rope_theta=10000.0, qkv_bias=False,
                    chunk=1024),
)

SMOKE = ArchConfig(
    name="command-r-35b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=176, vocab=512,
    act="swiglu", norm="layernorm", parallel_residual=True,
    tie_embeddings=True,
    attn=AttnConfig(kind="full", rope_theta=10000.0, chunk=16),
)
