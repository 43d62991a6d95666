"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2; unverified].

The flagship speculative-DAE cell: 384-way expert routing is the paper's
control-LoD store (DESIGN.md §3), dispatched speculatively with capacity
poison.  61L d_model=7168 64H (GQA kv=8) expert_ff=2048 vocab=163840.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    spec_dae_applicable=True,
    note="paper-table MoE; EP=16 on the model axis",
)
