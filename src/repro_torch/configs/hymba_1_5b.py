"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) ff=5504 vocab=32001,
ssm_state=16.  Parallel attention + Mamba heads fused per layer; sliding-
window attention (1024) on all but 3 global layers (first/middle/last).
[arXiv:2411.13676]

25 heads pad to 32 for TP=16 (exact; zero out-proj rows).  SWA + SSM =>
sub-quadratic => runs long_500k (global layers attend the full half-meg
context through the seq-sharded cache).
"""
from ..core.config import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="sliding", window=1024, rope_theta=10000.0,
                    chunk=1024),
    ssm=SSMConfig(kind="mamba", d_state=16, expand=2, chunk=64),
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=3, d_model=40, n_heads=5, n_kv_heads=5,
    d_ff=96, vocab=512,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="sliding", window=8, chunk=16),
    ssm=SSMConfig(kind="mamba", d_state=4, expand=2, chunk=8),
)
