"""whisper-small [audio] — enc-dec, conv frontend (stub).

[arXiv:2212.04356; unverified]  12L d_model=768 12H d_ff=3072 vocab=51865.
Decoder positions use RoPE in this adaptation (whisper uses learned
positions; noted in DESIGN.md — the backbone dims are what the assignment
fixes).  The conv frontend is a stub: input_specs() provides precomputed
frame embeddings [B, 1500, 768].
"""
from ..models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, max_seq_len=32_768,
    encdec=EncDecConfig(n_encoder_layers=12, n_audio_ctx=1500),
)
