"""The yardstick's arithmetic against shapes worked by hand."""
import pytest

from bench import yardstick as Y
from bench.weights import group_pattern

KIMI = {"family": "moe", "n_layers": 1, "d_model": 7168, "n_heads": 64,
        "n_kv_heads": 8, "d_ff": 2048, "vocab": 163840, "n_experts": 384,
        "top_k": 8, "moe_d_ff": 2048, "n_shared_experts": 1}
def test_moe_work_by_hand():
    # 2 tokens, d 4, 3 experts, top 1, ff 5, no shared expert, 2 touched
    w = Y.moe_work(2, 2, d=4, n_experts=3, top_k=1, ff=5, shared_ff=0)
    assert w["flops"] == 2 * 2 * (4 * 3 + 1 * 3 * 4 * 5)
    assert w["bytes"] == 2 * (4 * 3 + 2 * 3 * 4 * 5 + 2 * 2 * 4)


def test_moe_bound_at_kimi_decode():
    # 96 tokens touching 332 experts: the experts' bytes bound it
    w = Y.moe_work(96, 332, d=7168, n_experts=384, top_k=8, ff=2048,
                   shared_ff=2048)
    assert w["bytes"] == pytest.approx(
        2 * (7168 * 384 + 333 * 3 * 7168 * 2048 + 2 * 96 * 7168))
    t = Y.bf16_bound_s(w["flops"], w["bytes"])
    assert t == pytest.approx(w["bytes"] / 3.35e12)
    assert 8.7e-3 < t < 8.8e-3


def test_scan_bound_by_hand():
    # 4 x 3460 x 8192 x 16 exps at 16 a clock on 132 SMs, 1.98 GHz
    t = Y.mamba_scan_bound_s(4, 3460, 8192, 16, 1.98e9)
    assert t == pytest.approx(4 * 3460 * 8192 * 16 / (16 * 132 * 1.98e9))
    # one decode step: bytes bound it
    nbytes = Y.mamba_scan_bytes(4, 1, 8192)
    assert nbytes == 2 * 4 * 8192 * 2 + 4 * 33 * 2 + 8192 * 16 * 4 \
        + 2 * 4 * 8192 * 16 * 4
    assert Y.mamba_scan_bound_s(4, 1, 8192, 16, 1.98e9) == pytest.approx(
        nbytes / 3.35e12)


def test_token_params_by_hand():
    attn = 7168 * 112 * (2 * 64 + 2 * 8)
    moe = 7168 * 384 + 3 * 7168 * 2048 * 9
    assert Y.token_matmul_params(KIMI, group_pattern(KIMI)) == attn + moe


def test_model_flops_by_hand():
    pattern = group_pattern(KIMI)
    per = 2 * Y.token_matmul_params(KIMI, pattern)
    f = Y.model_flops(KIMI, pattern, 1, tokens=3, live_keys=6, head_rows=1)
    assert f == 3 * per + 2 * 7168 * 163840 + 4 * 64 * 112 * 6
    assert Y.causal_pairs(3) == 6 and Y.causal_pairs(1) == 1

