"""Every per-layer reader on a made-up trace, against values worked by
hand; a reader with nothing to read returns None."""
import pytest

from h100bench import metrics
from h100bench.counts.kernels import attention_bound_s, mix_bound_s
from h100bench.trace import Trace, family

MODEL = {"family": "dense", "num_layers": 1, "d_model": 64, "num_heads": 2,
         "num_kv_heads": 2, "head_dim": 32, "d_ff": 128, "vocab_size": 100,
         "dtype": "float32"}
JOB = {"workers": 2, "sequences_per_worker": 4, "sequence_length": 16,
       "fb_ratio": 2}
MS = 1_000_000  # ns


def ctx(kernels, **kw):
    base = {"trace": Trace(2, 0.010, kernels, []), "unprofiled_steps": 4,
            "unprofiled_s": 2.0, "model": MODEL, "traffic": JOB,
            "groups": {"a": 1000, "b": 24}}
    base.update(kw)
    return base


KERNELS = [
    ("void flash_fwd_kernel<float>(Params)", 0, 1 * MS),
    ("void flash_bwd_dq_kernel<float>(Params)", 2 * MS, 1 * MS),
    ("void flash_bwd_dkv_kernel<float>(Params)", 3 * MS, 2 * MS),
    ("_mix_kernel", 6 * MS, 1 * MS),
    ("_mix_kernel", 7 * MS, 1 * MS),
    ("void quantize_plane_kernel<float>", 8 * MS, 1 * MS),
    ("void dequant_mix_kernel<float, true>", 9 * MS, 1 * MS),
    ("Memcpy DtoD (Device -> Device)", 9 * MS, 1 * MS),
    ("ampere_sgemm_128x64_nn", 0, 2 * MS),
]


def test_trace_union_and_gaps():
    tr = ctx(KERNELS)["trace"]
    assert tr.busy_s == pytest.approx(0.009)  # 0–5 and 6–10 ms merged
    assert tr.gaps == [(5 * MS, 6 * MS)]
    tr2 = Trace(1, 1.0, [("a", 0, MS), ("b", 5 * MS, MS)], [])
    assert tr2.gaps == [(MS, 5 * MS)] and tr2.busy_s == pytest.approx(0.002)
    assert tr2.idle_gaps()[0] == ["host in python, then b", 0.004]


@pytest.mark.parametrize("name, fam", [
    ("cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>", "gemm"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3", "gemm"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", "gemm"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("void flash_fwd_bf16_kernel<64>(Params)", "flash"),
    ("_mix_kernel", "gossip/quantize"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
])
def test_kernel_family(name, fam):
    assert family(name) == fam


def test_gemm_ms_counts_hopper_cublas():
    """cuBLASLt's Hopper kernels (nvjet_*) are matrix products."""
    nvjet = [("nvjet_tst_192x128_64x5_2x1_v_bz_coopA_TNT", 0, 3 * MS)]
    assert metrics.read("gemm_ms_per_step", ctx(KERNELS + nvjet)) \
        == pytest.approx(5.0 / 2)


@pytest.mark.parametrize("name, want", [
    ("device_idle_share", 10.0),
    ("kernels_per_step", 8 / 2),
    ("gemm_ms_per_step", 2.0 / 2),
])
def test_simple_readers(name, want):
    got = metrics.read(name, ctx(KERNELS))
    assert got == (want if want is None else pytest.approx(want))


def test_mfu():
    from h100bench.counts.flops import step_flops
    want = 100 * step_flops(MODEL, JOB) * 4 / 2.0 / 165e12
    assert metrics.read("mfu", ctx(KERNELS)) == pytest.approx(want)


def test_rooflines():
    shape = (2, 2, 2, 16, 32, 4)
    least = (attention_bound_s(*shape, "fwd")
             + attention_bound_s(*shape, "bwd"))
    assert metrics.read("flash_roofline", ctx(KERNELS)) \
        == pytest.approx(100 * least / 0.004)
    mix = mix_bound_s([2000, 48], 4, 2)  # one round over both groups
    assert metrics.read("gossip_mix_roofline", ctx(KERNELS)) \
        == pytest.approx(100 * mix / 0.002)


def test_nothing_to_read():
    empty = ctx([("elementwise_kernel", 0, MS)])
    for name in ("flash_roofline", "gossip_mix_roofline",
                 "gemm_ms_per_step"):
        assert metrics.read(name, empty) is None
