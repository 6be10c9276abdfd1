"""The fixed counts against hand-worked numbers, and the trace reduction
against a synthetic trace."""
import pytest

from counts import h100, kernels, work
from harness import manifest
from harness.tracing import read_trace

GRANITE = manifest.load_json(manifest.BENCH / "configs/granite_8b.json")
DSMOE = manifest.load_json(manifest.BENCH / "configs/deepseek_moe_16b.json")


def test_granite_step_flops_by_hand():
    # per layer: q and o 4096 x 4096, k and v 4096 x 1024, MLP 3 x 4096 x
    # 14336; 36 layers; the tied head 4096 x 49152
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    params = 36 * layer + 4096 * 49152
    assert work.active_params(GRANITE) == params == 8_053_063_680
    n = 65_536 + 1
    attn = 36 * 4 * 32 * 128 * n
    assert work.token_flops(GRANITE, n) == 2 * params + attn
    step = work.step_flops(GRANITE, [n] * 16)
    assert step == pytest.approx(876.6e9, rel=1e-3)


def test_deepseek_step_flops_by_hand():
    attn = 4 * 2048 * 2048
    dense = attn + 3 * 2048 * 10944
    moe = attn + 2048 * 64 + 3 * 2048 * 1408 * (6 + 2)
    params = dense + 27 * moe + 2048 * 102400
    assert work.active_params(DSMOE) == params
    assert params == pytest.approx(2.62e9, rel=1e-2)
    n = 2048 + 1
    assert work.step_flops(DSMOE, [n] * 64) == pytest.approx(
        64 * (2 * params + 28 * 4 * 16 * 128 * n))


def test_decode_attn_bytes_by_hand():
    pol = GRANITE["policy"]
    # K: 128 x 2 bit = 32 B + a scale and a zero (fp8); V 1.5 bit: 64 x 2
    # bit = 16 B + 2, 64 x 1 bit = 8 B + 2
    assert work.packed_bytes_per_token_head(128, pol) == 34 + 28 == 62
    n = 65_536 + 1
    live = n - 5 - 128
    assert work.packed_live(n, pol) == live
    want = live * 8 * 62 + 32 * 128 * 2 + 32 * 128 * 4 + 2 * 32 * 4
    assert work.decode_attn_bytes(GRANITE, n) == want
    assert work.decode_attn_flops(GRANITE, n) == 4 * 32 * 128 * live
    # a step of 16 slots reads ~520 MB a layer: bytes bound it
    b = 16 * work.decode_attn_bytes(GRANITE, n)
    f = 16 * work.decode_attn_flops(GRANITE, n)
    assert h100.bound_seconds(f, b) == b / h100.HBM_BYTES_PER_S
    assert work.packed_live(100, pol) == 0


def test_kernel_classes():
    assert kernels.is_decode_attn("void decode_attn_split<2, 4>(Params)")
    assert kernels.is_decode_attn("merge_splits(float const*)")
    assert kernels.is_kv_append("void kv_append_kernel<bf16>(AppendArgs)")
    for g in ("sm90_xmma_gemm_bf16bf16_bf16f32", "nvjet_hsh_128x64",
              "void gemv2T_kernel_val<int>", "cutlass::Kernel2<x>",
              "void splitKreduce_kernel<32, 16>"):
        assert kernels.is_gemm(g) and not kernels.is_glue(g)
    assert kernels.is_glue("void at::native::vectorized_elementwise_kernel")
    assert kernels.is_glue("Memcpy DtoD (Device -> Device)")


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [_ev("user_annotation", "traced_slice", 0, 100),
              _ev("user_annotation", "replays", 0, 60),
              _ev("user_annotation", "host_sync", 60, 40),
              _ev("kernel", "nvjet_gemm", 5, 20),
              _ev("kernel", "decode_attn_split<1>", 20, 20),
              _ev("kernel", "elementwise", 70, 10),
              _ev("kernel", "before", -50, 10)]
    tr = read_trace(events)
    assert tr.busy_us == 45 and tr.window_us == 100
    assert tr.time_by(kernels.is_gemm) == pytest.approx(20e-6)
    gaps = dict((round(s * 1e6), n) for n, s in tr.gaps())
    assert gaps == {5: "replays", 30: "replays", 20: "host_sync"}
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] in ("nvjet_gemm", "decode_attn_split<1>")
    assert bd["idle_gaps"][0][0] == "replays"
    assert bd["idle_gaps"][0][1] == pytest.approx(30e-6)


def test_empty_trace_is_refused():
    with pytest.raises(RuntimeError):
        read_trace([_ev("user_annotation", "traced_slice", 0, 100)])
