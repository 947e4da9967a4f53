"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  24L d_model=768 d_ff=0 vocab=50280
ssm_state=128.
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, max_seq_len=1_048_576, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
)
