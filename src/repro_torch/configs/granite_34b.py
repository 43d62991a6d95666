"""Granite 34B code model — llama-arch, MQA [arXiv:2405.04324; hf].

88L d_model=6144 48H (GQA kv=1 — MQA) d_ff=24576 vocab=49152.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    note="dense: spec-DAE applies to the paged-KV serve path only",
)
