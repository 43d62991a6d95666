"""Whisper-medium — enc-dec audio backbone, conv frontend stubbed
[arXiv:2212.04356; unverified].

24L (x2: encoder+decoder) d_model=1024 16H d_ff=4096 vocab=51865;
input_specs() provides precomputed (B, 1500, d) frame embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    n_enc_layers=24, enc_len=1500,
)
