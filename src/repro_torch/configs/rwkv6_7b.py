"""RWKV-6 (Finch) 7B — attention-free, data-dependent decay
[arXiv:2404.05892; hf].

32L d_model=4096 d_ff=14336 vocab=65536.  Spec-DAE is inapplicable to the
core block (no data-dependent gather/scatter; the recurrence is a regular
stream) — DESIGN.md §6.  long_500k runs (O(1) state).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=65536, head_dim=64,
    note="attention-free; technique inapplicable to core block",
)
