"""granite-moe-1b-a400m [moe] — 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) d_ff=512(per-expert) vocab=49155.
"""
from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, tie_embeddings=True, max_seq_len=4_096,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
)
