"""The FLOP and byte counts against values worked by hand."""
import json
from pathlib import Path

import pytest

from h100bench.counts import flops, kernels
from h100bench.counts.peaks import step_peak

ROOT = Path(__file__).resolve().parents[2]


def model(name):
    return json.loads((ROOT / "h100bench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def traffic(name):
    return json.loads((ROOT / "h100bench" / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name, want", [("gpt2-medium", 454_116_352),
                                        ("mamba2-780m", 779_120_640)])
def test_matmul_params(name, want):
    # GPT-2 Medium: 24·(4·1024² + 3·1024·4096) + 1024·50257
    # Mamba2-780M: 48·(1536·(2·3072 + 2·128 + 48) + 3072·1536) + 1536·50280
    assert flops.matmul_params(model(name)) == want


def test_attention_and_ssd_flops():
    # 24 layers · 16 heads · 4·64 · 1024·1025/2 pairs
    assert flops.attention_flops(model("gpt2-medium"), 1024) \
        == 51_589_939_200
    # per layer 2·8256·128·16 + 48·16·(2·8256·64 + 3·8256 + 4·128·128·64
    # + 2·128·64), 48 layers
    assert flops.ssd_flops(model("mamba2-780m"), 2048) == 196_715_741_184


def test_step_flops():
    # 2N·49152 + 4N·24576 + 96 sequence-forwards of attention
    assert flops.step_flops(model("gpt2-medium"),
                            traffic("pdasgd-param-12x1024")) \
        == 94_235_541_897_216
    m = model("mamba2-780m")
    # 32 sequences of 2048 forward, 16 backward (twice the forward's work)
    assert flops.step_flops(m, traffic("pdasgd-param-8x2048")) == (
        4 * 779_120_640 * 65536 + 64 * 196_715_741_184)


def test_peaks():
    assert step_peak("float32") == pytest.approx(165e12)
    assert step_peak("bfloat16") == pytest.approx(989e12)


def test_kernel_bounds():
    # 2 sequences, 16 heads, 1024 positions, 64 wide, f32: 4·64 FLOPs over
    # 2·16·524800 pairs at 165 TFLOP/s (26.06 µs) outweighs 33,685,504 B
    assert kernels.attention_bound_s(2, 16, 16, 1024, 64, 4, "fwd") \
        == pytest.approx(4 * 64 * 2 * 16 * 524_800 / 165e12)
    # backward bytes win at 1 position: 4·nq + 4·nkv + lse over HBM
    assert kernels.attention_bound_s(1, 1, 1, 1, 64, 4, "bwd") \
        == pytest.approx((4 * 256 + 4 * 256 + 4) / 3.35e12)
    # 4 rows of 250 f32: x, recv, u read, out written, α and β a row
    assert kernels.mix_bound_s([1000], 4, 4) \
        == pytest.approx((16_000 + 32) / 3.35e12)
