"""Jamba-1.5-large 398B — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; groups of 8 layers
(7 Mamba + 1 attention); MoE on every second layer.  long_500k runs: Mamba
state is O(1) and the 9 attention layers' KV shards over the data axis.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_every=2,
    attn_stride=8, ssm_d_state=16,
    spec_dae_applicable=True,
)
