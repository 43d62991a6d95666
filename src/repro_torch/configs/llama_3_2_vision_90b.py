"""Llama-3.2-Vision 90B — cross-attn image layers, patch frontend stubbed
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
cross-attends to (B, n_patches, d) stub patch embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    cross_stride=5, n_patches=1024,
)
