"""Phi-4-mini 3.8B — RoPE SwiGLU GQA [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 (largest vocab in
the pool — the embedding-gather demo arch).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064,
)
