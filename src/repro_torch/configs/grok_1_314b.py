"""Grok-1 — 314B MoE, 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.  8 experts < 16
model shards, so experts replicate across the model axis and the expert FFN
dim shards instead (EP folded into TP).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, moe_d_ff=32768,
    spec_dae_applicable=True,
    note="expert-ff sharded on model axis (E=8 < model=16)",
)
