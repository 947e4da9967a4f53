"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000 ssm_state=64.  One *shared-weight* attention+MLP block is
applied every 6 mamba layers — the paper's one-definition/many-instances
pattern with literally shared weights.  (Zamba2's per-use LoRA adapters on
the shared block are omitted; noted in DESIGN.md.)
"""
from ..models.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64, max_seq_len=4_096,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
    hybrid=HybridConfig(attn_period=6),
)
