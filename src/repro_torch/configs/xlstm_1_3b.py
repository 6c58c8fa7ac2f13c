"""xlstm-1.3b [ssm]: 48L d=2048 4H vocab=50304, d_ff=0 (blocks carry their
own projections).  mLSTM blocks with an sLSTM block every 8th layer (the
paper's xLSTM[7:1] ratio).  [arXiv:2405.04517]

Sub-quadratic recurrence => runs long_500k.
"""
from ..core.config import ArchConfig, AttnConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    act="swiglu", norm="rmsnorm",
    attn=AttnConfig(kind="none"),
    ssm=SSMConfig(kind="xlstm", slstm_every=8, expand=2, chunk=64),
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    n_layers=4, d_model=32, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=512,
    attn=AttnConfig(kind="none"),
    ssm=SSMConfig(kind="xlstm", slstm_every=2, expand=2, chunk=8),
)
