"""whisper-medium [audio]: enc-dec, 24+24L d=1024 16H (kv=16) ff=4096
vocab=51865 (padded to a TP multiple).  LayerNorm + GELU + sinusoidal
positions; the conv audio frontend is a STUB: input_specs() supplies
precomputed frame embeddings.  [arXiv:2212.04356]

Shapes: seq_len splits as frames = seq//2 encoder, tokens = seq//2 decoder
(train/prefill); decode uses a 1500-frame encoder memory (whisper's fixed
30 s window) + a seq_len self-attention cache.  Full attention =>
long_500k skipped.
"""
from ..core.config import ArchConfig, AttnConfig

ENC_FRAMES_DECODE = 1500

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    act="gelu", norm="layernorm",
    attn=AttnConfig(kind="full", rope_theta=0.0, chunk=1024),
)

SMOKE = ArchConfig(
    name="whisper-medium-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512,
    act="gelu", norm="layernorm",
    attn=AttnConfig(kind="full", rope_theta=0.0, chunk=16),
)
