"""starcoder2-3b [dense] — GQA, RoPE, sliding window 4096.

[arXiv:2402.19173; hf]  30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, rope_theta=999_999.4,
    sliding_window=4096, max_seq_len=16_384,
)
