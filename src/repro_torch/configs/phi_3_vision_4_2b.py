"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]
32L d_model=3072 32H (GQA kv=32 == MHA) d_ff=8192 vocab=32064.
The CLIP frontend is a stub per the assignment: input_specs() provides
precomputed patch embeddings projected into the backbone.
"""
from ..models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, rope_theta=10_000.0,
    max_seq_len=131_072,
    vlm=VLMConfig(n_patches=576, d_patch=1024),
)
