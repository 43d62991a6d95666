"""Architecture config schema + the assigned-architecture registry.

A copy of the JAX package's ``configs/base.py``: every assigned arch has
a module ``repro_torch/configs/<id>.py`` exporting ``CONFIG``;
``get(name)`` resolves it, ``smoke(cfg)`` derives the reduced same-family
variant the CPU tests use.  Every field and derived value is the
reference's; only the dtype resolves to a ``torch.dtype``
(:attr:`ArchConfig.torch_dtype`) instead of a ``jax.numpy`` one.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None      # expert FFN width (kimi: 2048)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1                  # MoE layer stride (jamba: 2)

    # hybrid (jamba): one attention layer per `attn_stride` in each group
    attn_stride: int = 0                # 0 = not hybrid
    ssm_d_state: int = 16

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_len: int = 1500                 # stubbed frame embeddings

    # vlm: one cross-attn layer every `cross_stride`
    cross_stride: int = 0
    n_patches: int = 1024               # stubbed patch embeddings

    rope_theta: float = 1e4
    head_dim: Optional[int] = None
    dtype: str = "bfloat16"
    # technique applicability (DESIGN.md §6)
    spec_dae_applicable: bool = False
    note: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: small widths, few experts, tiny vocab."""
    return dataclasses.replace(
        cfg,
        n_layers=max(2, min(4, cfg.n_layers)) if not cfg.attn_stride
        else cfg.attn_stride,            # hybrid: one full group
        d_model=64,
        n_heads=4,
        n_kv_heads=min(2, cfg.n_kv_heads),
        d_ff=128,
        vocab=512,
        n_experts=min(4, cfg.n_experts) if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else None,
        n_shared_experts=min(1, cfg.n_shared_experts),
        n_enc_layers=min(2, cfg.n_enc_layers),
        enc_len=24 if cfg.n_enc_layers else cfg.enc_len,
        cross_stride=min(2, cfg.cross_stride) if cfg.cross_stride else 0,
        n_patches=16 if cfg.cross_stride else cfg.n_patches,
        head_dim=16,
        dtype="float32",
    )


ASSIGNED = (
    "kimi_k2_1t_a32b", "grok_1_314b", "granite_34b", "phi4_mini_3_8b",
    "mistral_nemo_12b", "stablelm_12b", "rwkv6_7b", "whisper_medium",
    "llama_3_2_vision_90b", "jamba_1_5_large_398b",
)

_ALIASES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "grok-1-314b": "grok_1_314b",
    "granite-34b": "granite_34b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "stablelm-12b": "stablelm_12b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def get(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def param_count(cfg: ArchConfig) -> Tuple[int, int]:
    """(total, active-per-token) parameter counts — for MODEL_FLOPS."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    dense_mlp = 3 * d * cfg.d_ff
    moe_ff = cfg.moe_d_ff or cfg.d_ff
    expert_mlp = 3 * d * moe_ff
    emb = 2 * cfg.vocab * d

    def layer_counts(is_moe: bool, is_attn: bool, is_ssm: bool):
        total = active = 0
        if is_attn:
            total += attn
            active += attn
        if is_ssm:
            ssm = d * 2 * d + 2 * d * d + 2 * d * cfg.ssm_d_state * 2
            total += ssm
            active += ssm
        if is_moe:
            total += cfg.n_experts * expert_mlp \
                + cfg.n_shared_experts * expert_mlp + d * cfg.n_experts
            active += cfg.top_k * expert_mlp \
                + cfg.n_shared_experts * expert_mlp
        else:
            total += dense_mlp
            active += dense_mlp
        return total, active

    total = active = emb
    for i in range(cfg.n_layers):
        is_moe = cfg.n_experts > 0 and (i % cfg.moe_every == 0)
        if cfg.attn_stride:
            is_attn = (i % cfg.attn_stride) == cfg.attn_stride - 1
            is_ssm = not is_attn
        elif cfg.family == "ssm":
            is_attn, is_ssm = False, True
        else:
            is_attn, is_ssm = True, False
        t, a = layer_counts(is_moe, is_attn, is_ssm)
        total += t
        active += a
    for _ in range(cfg.n_enc_layers):
        t, a = layer_counts(False, True, False)
        total += t
        active += a
    return total, active
