"""grok-1-314b [moe] — 8 experts top-2; the multi-pod-scale arch.

[hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (GQA kv=8) d_ff=32768(per-expert) vocab=131072.
"""
from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128, max_seq_len=8_192,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
)
