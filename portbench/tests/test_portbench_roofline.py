"""The work counts behind mfu.* and attn_roofline.*, held to hand
counts, and the peaks."""

import json
from dataclasses import dataclass, field

import pytest

from portbench import roofline
from portbench.roofline import Shape

TINY = Shape(layers=2, hidden=8, intermediate=16, heads=2, kv_heads=1,
             head_dim=4, vocab=10)


@dataclass
class Req:
    prompt_len: int
    cached: int
    chunks: list = field(default_factory=list)
    sent_s: float = 0.0


def test_peaks():
    assert roofline.BF16_FLOPS == 989e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.POWER_LIMIT_W == 700.0


# the sizes of https://huggingface.co/Qwen/Qwen2-7B/blob/main/config.json
QWEN2_7B = {"hidden_size": 3584, "intermediate_size": 18944,
            "num_attention_heads": 28, "num_hidden_layers": 28,
            "num_key_value_heads": 4, "vocab_size": 152064}


def test_published_parameter_counts(checkout):
    for name, total in (("mistral-7b", 7_241_732_096),
                        ("qwen2-7b", 7_615_616_512)):
        hf = QWEN2_7B if name == "qwen2-7b" else json.loads(
            (checkout / "portbench" / "configs"
             / f"{name}.json").read_text())["hf_config"]
        s = Shape.from_hf(hf)
        norms = (2 * s.layers + 1) * s.hidden
        bias = (s.layers * (s.heads + 2 * s.kv_heads) * s.head_dim
                if name == "qwen2-7b" else 0)
        assert (s.layers * s.layer_matmul_params + 2 * s.vocab * s.hidden
                + norms + bias) == total


def test_layer_params_by_hand():
    # q 8x8, k and v 8x4 each, o 8x8, gate/up/down 8x16 each
    assert TINY.layer_matmul_params == 64 + 32 + 32 + 64 + 3 * 128


def test_causal_keys():
    assert roofline.causal_keys(0, 3) == 1 + 2 + 3
    assert roofline.causal_keys(2, 5) == 3 + 4 + 5


def test_attn_bound_is_chip_smokes():
    # chip_smoke.py's bound(): (2*kv*nkv*d*2 + 2*rows*nq*d*2) bytes at
    # 3.35 TB/s against 4*keys*nq*d operations at 989 TFLOP/s
    b = roofline.attn_bound_s(TINY, n_rows=3, visible_keys=12, kv_tokens=5)
    assert b == pytest.approx((2 * 5 * 1 * 4 * 2 + 2 * 3 * 2 * 4 * 2)
                              / 3.35e12)
    big = Shape(1, 4096, 1, 32, 8, 128, 1)
    ops_bound = roofline.attn_bound_s(big, 8000, 32_004_000, 8000)
    assert ops_bound == pytest.approx(4 * 32_004_000 * 32 * 128 / 989e12)


def test_prefill_by_hand():
    w = roofline.prefill_work(TINY, prompt_len=5, cached=2)
    # 3 rows x 576 weights x 2 layers x 2; keys 3+4+5 = 12, x 4 nq d L;
    # one row of logits
    assert w.flops == 2 * 576 * 2 * 3 + 4 * 12 * 2 * 4 * 2 + 2 * 8 * 10
    assert w.rows == 3
    assert w.attn_bound_s == pytest.approx(2 * 176 / 3.35e12)


def test_decode_by_hand():
    # the second token: the first one at position 5 sees 6 keys
    w = roofline.decode_work(TINY, prompt_len=5, token_index=2)
    assert w.flops == 2 * 576 * 2 + 4 * 6 * 2 * 4 * 2 + 2 * 8 * 10
    assert w.attn_bound_s == pytest.approx(
        2 * (2 * 6 * 4 * 2 + 2 * 2 * 4 * 2) / 3.35e12)


def test_served_work_by_window():
    # sent at 0.5, first token at 1.0, three more at 2.0
    r = Req(5, 2, [(1.0, 1), (2.0, 3)], sent_s=0.5)
    pre = roofline.prefill_work(TINY, 5, 2)
    dec = [roofline.decode_work(TINY, 5, j) for j in (2, 3, 4)]
    assert roofline.served_work(TINY, [r], 0.0, 1.0).flops == pre.flops
    got = roofline.served_work(TINY, [r], 1.0, 3.0)
    assert got.flops == sum(d.flops for d in dec)
    assert got.rows == 3
    both = roofline.served_work(TINY, [r, r], 0.0, 3.0)
    assert both.flops == 2 * (pre.flops + sum(d.flops for d in dec))
    # a window over half of each interval counts half of each
    half = roofline.served_work(TINY, [r], 0.75, 1.5)
    assert half.flops == pytest.approx(
        pre.flops / 2 + sum(d.flops for d in dec) / 2)
    assert half.attn_bound_s == pytest.approx(
        pre.attn_bound_s / 2 + sum(d.attn_bound_s for d in dec) / 2)


def test_overlap():
    assert roofline.overlap(1.0, 2.0, 0.0, 5.0) == 1.0
    assert roofline.overlap(1.0, 2.0, 1.5, 5.0) == 0.5
    assert roofline.overlap(1.0, 2.0, 2.5, 5.0) == 0.0
    assert roofline.overlap(2.0, 2.0, 1.0, 3.0) == 1.0  # an instant


def test_counts_ignore_how_work_is_launched():
    # the same request's tokens delivered in other batches: same work
    a = Req(40, 8, [(1.0, 1), (1.1, 8), (1.2, 8)])
    b = Req(40, 8, [(1.0, 3), (1.1, 2), (1.2, 12)])
    wa = roofline.served_work(TINY, [a], 0.0, 2.0)
    wb = roofline.served_work(TINY, [b], 0.0, 2.0)
    assert wa.flops == wb.flops and wa.attn_bound_s == wb.attn_bound_s
