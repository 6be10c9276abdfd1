"""The port's CUDA kernels on the card, held to their plain PyTorch versions
on the same inputs.  Every test is marked ``requires_cuda`` and skips
without a card; the file imports neither jax nor the JAX package, so it
runs on a machine with only torch:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

* kv_quant: 0 differing bytes, edge-case rows included, rows holding both
  +0 and -0, every head dim of the repo's configs (16, 64, 128, 256), per
  head clip factors, and a prefill-size launch.
* kv_append (the fused decode append): byte-equal to its plain version
  after every one of 300 steps (pool block 0 excluded), striped and
  pooled, D 128 and 64, with and without a window; a CUDA-graph replay
  byte-equal to eager launches.
* decode_attn: f32 ``atol=3e-5, rtol=1e-4`` (sums in another order), and
  the pruned walk BITWISE equal to the full walk.  Its block-table mode
  (pooled planes, DESIGN.md §9) to the same tolerance against its plain
  version, and BITWISE equal to the striped kernel over the gathered
  planes at the same tile, for permuted, shared and null-padded tables.
* the split (flash-decoding) kernel: many splits with dead ones, to the
  plain version's tolerance; pruned == full, and two launches, BITWISE;
  every plane width (1/2/4/8 bits, one and two planes), fp16 metadata,
  Gq up to 8 and head dims 16..256 against the plain version.
* one decode step of a smoke model: ``"cuda"`` backend vs ``"reference"``
  backend in f32, where both dequantize in f32 — ``atol=rtol=1e-4``; the
  same bound for gemma3 smoke's unrolled step (hoisted local slices,
  pre-append attends) against its default step.  decode_attn also at the
  new families' head shapes (Gq 7 / D 128, Gq 2 / D 256, softcap 50) and
  kv_append at Hkv 4 / D 256; the hybrid and enc-dec families' (below).
  The MoE smoke models' step on both
  backends; their FFN on the card within f32 ``atol=1e-5`` of the CPU's
  (both dispatches, tokens dropped), and a warmed MoE Engine's streams
  equal to the unwarmed one's with the launch identities.
* the hybrid and enc-dec families: decode_attn at hymba's Hkv 5 / Gq 5 /
  D 64 (the launch plan's one kv head a CTA) and over a window-0, sink-0
  cross cache (every frame packed, no fp segment), each to the f32
  tolerance of its plain version, and kv_append at Hkv 5 / D 64; a
  warmed hymba smoke Engine (the SSM state updated in place inside the
  graph) with the unwarmed Engine's streams and the launch identities; a
  seamless smoke step with two decode_attn launches a layer, the cross
  cache untouched, and a captured step BYTE-equal to eager steps.
* the serving harness (DESIGN.md §10): a CUDA-graph replay of one decode
  step BYTE-equal to an eager step in every cache leaf and the logits,
  striped and pooled; the launch counters after N replays; traced
  replays matching the capture's region map (``repro_torch.spans``);
  every cache leaf and static buffer at the same address across
  admissions and chunks; warmed and async streams equal to eager sync ones; the pinned
  delivery ring never handing the consumer overwritten tokens.
* chunked prefill (DESIGN.md §7): the chunk append's bulk route BYTE-equal
  to its plain token loop and to a loop of ``kv_append`` after every
  chunk; warmed chunked Engines, striped and pooled, with equal streams
  and the launch identities.
* policy schedules (DESIGN.md §8): ``kv_append`` BYTE-equal and
  decode_attn to the f32 tolerance at the bits ladder's widths (4, 4) and
  (2, 2), both layouts; the fp16 route of the decode wrapper against the
  reference backend's fp16 attention (f32, ``atol=rtol=1e-5``); warmed
  scheduled Engines (fp16 guard layers, the ladder) striped, pooled and
  chunked with streams equal to the unwarmed striped engine's and the
  launch identities over the quantized layers only.
* calibration (paper Sec. 3.1): ``fake_quant`` through the bulk kv_quant
  kernel BITWISE equal to it through the plain quantizer; a calibration
  on CUDA samples takes the kernel route (2 x 11 launches a layer, no
  plain call) and gives the plain route's permutations and clip factors
  bit for bit; a self-calibrated smoke model served by warmed striped and
  pooled engines with equal streams and the launch identities, and fused-V
  weights giving the unfused prefill logits (f32, ``atol=rtol=1e-4``).
* degradation (DESIGN.md §11): ``pool_read_blocks``/``pool_write_blocks``
  round trips BYTE-equal on every plane leaf; the captured step with the
  NaN guard disarmed BITWISE equal to the unguarded eager step (every
  cache leaf and output); an armed guard sheds exactly its slot with the
  other rows BITWISE unchanged; a preempted request, its blocks spilled
  to the host tier and restored, resumes to the uninterrupted stream on a
  warmed pooled async engine.
* the RWKV6 family (no KV cache): ``wkv_chunked`` against the step
  recurrence on the card (the reference test's ``atol 2e-4, rtol 1e-3``);
  a captured rwkv smoke decode step BYTE-equal to eager steps in every
  state leaf and the logits, and a warmed Engine's streams equal to the
  unwarmed one's with no kernel launched.
* training: a smoke train step on the card against the same step on the
  CPU (f32; loss, nll and grad norm within ``rtol=1e-5``, each param leaf
  within ``atol=1e-5`` after the step, TF32 off); a checkpoint saved on
  the card, restored into a fresh state, and the next step BITWISE equal
  to the uninterrupted run's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import kv_cache as kvc
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import n_meta_groups, quantize_groups
from repro_torch.core import segments as seg
from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels import kv_quant as KQ
from repro_torch.models import transformer as T
from test_torch_util import cuda_device  # noqa: F401  (fixture)
from test_torch_util import stall_until_backpressure
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

pytestmark = pytest.mark.requires_cuda
ATOL, RTOL = 3e-5, 1e-4


def _edge_rows(rng, d):
    rows = [np.zeros(d), np.full(d, 0.5), np.full(d, -3.0),
            rng.uniform(0.0, 1e-3, d), rng.uniform(-2e-4, 2e-4, d),
            np.concatenate([[0.0], rng.uniform(0.0, 1e-3, d - 1)]),
            rng.normal(size=d) * 900.0, rng.normal(size=d) - 1000.0]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("bits", [1.0, 1.5, 2.0, 4.0, 8.0])
@pytest.mark.parametrize("fp8_meta", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quant_kernel_matches_plain(bits, fp8_meta, dtype, cuda_device):
    rng = np.random.default_rng(0)
    x = np.concatenate([_edge_rows(rng, 128),
                        rng.normal(size=(120, 128)).astype(np.float32)])
    x = torch.from_numpy(x).to(dtype).to(cuda_device)
    g = n_meta_groups(128, bits, 64)
    alpha = torch.from_numpy(rng.uniform(0.8, 1.0, size=(x.shape[0], g))
                             .astype(np.float32)).to(cuda_device)
    for a in (None, alpha):
        got = KQ.kv_quant(x, bits, 64, a, fp8_meta)
        want = KQ.kv_quant_plain(x, bits, 64, a, fp8_meta)
        for k in want:
            assert torch.equal(got[k].view(torch.uint8),
                               want[k].view(torch.uint8)), k


def _bytes_equal(got, want, what=""):
    for k in want:
        assert torch.equal(got[k].view(torch.uint8),
                           want[k].view(torch.uint8)), f"{what} {k}"


def _signed_zero_rows(rng, n, d):
    """Rows whose groups' minimum is a zero: +0 before -0, -0 before +0,
    +0 alone, mixed all-zero rows."""
    x = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    for i in range(n):
        p = np.sort(rng.permutation(d)[: d // 2])
        kind = i % 4
        if kind == 0:
            x[i, p[::2]], x[i, p[1::2]] = 0.0, -0.0
        elif kind == 1:
            x[i, p[::2]], x[i, p[1::2]] = -0.0, 0.0
        elif kind == 2:
            x[i, p] = 0.0
        else:
            x[i] = np.where(rng.uniform(size=d) < 0.5, 0.0, -0.0)
    return x


@pytest.mark.parametrize("bits", [1.0, 1.5, 2.0, 4.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quant_kernel_signed_zero_rows(bits, dtype, cuda_device):
    """A shuffle-tree minimum must give a zero the sign the plain version
    gives it (-0 below +0), or the fp8 zero byte flips (0x00 vs 0x80)."""
    rng = np.random.default_rng(8)
    x = np.concatenate([_signed_zero_rows(rng, 120, 128),
                        _edge_rows(rng, 128)])
    x = torch.from_numpy(x).to(dtype).to(cuda_device)
    for gs in (16, 64, 128):
        for fp8 in (True, False):
            got = KQ.kv_quant(x, bits, gs, None, fp8)
            want = KQ.kv_quant_plain(x, bits, gs, None, fp8)
            _bytes_equal(got, want, f"gs={gs} fp8={fp8}")
    z = KQ.kv_quant_plain(x, bits, 16)["zero_hi"]
    assert (z == 0x80).any() and (z == 0x00).any()


@pytest.mark.parametrize("d,gs,bits", [
    (16, 16, 1.5), (16, 8, 2.0), (64, 64, 1.5), (64, 16, 4.0),
    (128, 128, 2.0), (128, 32, 8.0), (256, 256, 2.0), (256, 128, 1.5),
    (256, 64, 3.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_quant_kernel_every_head_dim(d, gs, bits, dtype, cuda_device):
    """Head dims 16, 64, 128 and 256 (two quads per lane, and one 64-quad
    group spanning both halves of a D-256 row); shared, per-head and
    per-row clip factors."""
    rng = np.random.default_rng(9)
    n, h = 96, 8
    x = np.concatenate([_edge_rows(rng, d),
                        rng.normal(size=(n - 8, d)).astype(np.float32)])
    x = torch.from_numpy(x).to(dtype).to(cuda_device)
    g = n_meta_groups(d, bits, gs)
    per_head = torch.from_numpy(rng.uniform(0.7, 1.0, (h, g))
                                .astype(np.float32)).to(cuda_device)
    for alpha in (None, per_head[0], per_head, per_head.repeat(n // h, 1)):
        got = KQ.kv_quant(x, bits, gs, alpha)
        want = KQ.kv_quant_plain(x, bits, gs, alpha)
        _bytes_equal(got, want, "alpha " + str(
            None if alpha is None else tuple(alpha.shape)))
    tiled = KQ.kv_quant(x, bits, gs, per_head.repeat(n // h, 1))
    _bytes_equal(KQ.kv_quant(x, bits, gs, per_head), tiled, "per-head")


def test_kv_quant_kernel_prefill_size(cuda_device):
    """One layer of a 3000-token llama2-7b prefill: 91,744 rows of 128
    bf16 channels, K 2-bit and V 1.5-bit, per-head clip factors."""
    rng = np.random.default_rng(10)
    n, h = 2867 * 32, 32
    x = torch.randn((n, 128), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0)
                    ).to(torch.bfloat16)
    x[:8] = torch.from_numpy(_edge_rows(rng, 128)).to(cuda_device).to(
        torch.bfloat16)
    for bits in (2.0, 1.5):
        alpha = torch.from_numpy(rng.uniform(0.7, 1.0, (
            h, n_meta_groups(128, bits, 128))).astype(np.float32)
        ).to(cuda_device)
        before = KQ.LAUNCHES["kernel"]
        got = KQ.kv_quant(x, bits, 128, alpha)
        assert KQ.LAUNCHES["kernel"] == before + 1
        _bytes_equal(got, KQ.kv_quant_plain(x, bits, 128, alpha), f"{bits}")


def _append_case(dev, seed, d, hkv, gs, window, pooled, b=4, bt=16, nb=16,
                 bits=(2.0, 1.5)):
    """Identical kernel and plain caches (random contents, slots at 0,
    in the window's filling, evicting, and near the capacity), per-head
    clip factors; K/V widths ``bits``."""
    rng = np.random.default_rng(seed)
    pol = QuantPolicy(bits_k=bits[0], bits_v=bits[1], group_size=gs,
                      window=window, n_sink=5)
    max_len = 5 + window + nb * bt
    if pooled:
        cache = kvc.init_pooled_cache(b, max_len, hkv, d, pol, b * nb, bt,
                                      torch.bfloat16, device=dev)
        cache["block_tbl"].copy_(torch.from_numpy(
            rng.permutation(np.arange(1, b * nb + 1)).reshape(b, nb)
            .astype(np.int32)))
    else:
        cache = kvc.init_cache(b, max_len, hkv, d, pol, torch.bfloat16,
                               device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    for k, v in cache.items():
        if k == "length":
            v.copy_(torch.tensor([0, 20, 5 + window + 60, max_len - 40]))
        elif v.is_floating_point():
            v.copy_(torch.randn(v.shape, generator=gen, device=dev))
        elif k != "block_tbl":
            v.copy_(torch.randint(0, 256, v.shape, generator=gen,
                                  device=dev))
    alphas = [torch.from_numpy(rng.uniform(0.7, 1.0, (
        hkv, n_meta_groups(d, w, gs))).astype(np.float32)).to(dev)
        for w in bits]
    return pol, cache, {k: v.clone() for k, v in cache.items()}, alphas, gen


def _caches_equal(a, c, pooled, what):
    for k in c:
        x, y = a[k], c[k]
        if pooled and kvc.is_plane_key(k):     # null block 0 excluded
            x, y = x[1:], y[1:]
        assert torch.equal(x.view(torch.uint8) if x.dtype != torch.int32
                           else x, y.view(torch.uint8)
                           if y.dtype != torch.int32 else y), f"{what} {k}"


@pytest.mark.parametrize("d,hkv,gs", [(128, 32, 128), (64, 8, 64),
                                      (256, 4, 128),
                                      (64, 5, 64)])     # hymba: odd Hkv
@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("window", [32, 0])
def test_kv_append_kernel_matches_plain_300_steps(d, hkv, gs, pooled,
                                                  window, cuda_device):
    pol, kc, pc, (ak, av), gen = _append_case(cuda_device, 11, d, hkv, gs,
                                              window, pooled)
    b = kc["length"].shape[0]
    before = dict(KQ.LAUNCHES)
    for step in range(300):
        kn = torch.randn((b, 1, hkv, d), generator=gen, device=cuda_device
                         ).to(torch.bfloat16)
        vn = torch.randn((b, 1, hkv, d), generator=gen, device=cuda_device
                         ).to(torch.bfloat16)
        valid = None
        if step % 3:
            valid = torch.tensor([True, True, step % 3 == 1, True],
                                 device=cuda_device)
        KQ.kv_append(kc, kn, vn, pol, ak, av, valid=valid)
        KQ.kv_append_plain(pc, kn, vn, pol, ak, av, valid=valid)
        _caches_equal(kc, pc, pooled, f"step {step}")
    assert KQ.LAUNCHES["append"] == before["append"] + 300
    lens = kc["length"].tolist()
    assert lens[0] == 300 and lens[3] > 5 + window + 16 * 16


def test_kv_append_cuda_graph_replay_equals_eager(cuda_device):
    pol, gc, ec, (ak, av), gen = _append_case(cuda_device, 12, 128, 32, 128,
                                              32, True)
    b = gc["length"].shape[0]
    kn = torch.randn((b, 1, 32, 128), generator=gen, device=cuda_device
                     ).to(torch.bfloat16)
    vn = torch.randn_like(kn)
    warm = {k: v.clone() for k, v in gc.items()}
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        KQ.kv_append(warm, kn, vn, pol, ak, av)      # build + load first
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        KQ.kv_append(gc, kn, vn, pol, ak, av)
    for _ in range(40):                  # lengths advance on the device
        graph.replay()
        KQ.kv_append(ec, kn, vn, pol, ak, av)
    torch.cuda.synchronize()
    _caches_equal(gc, ec, True, "graph vs eager")
    assert gc["length"].tolist() == [40, 60, 5 + 32 + 100, 5 + 32 + 256]


def test_kv_append_rejects_fp16_policy_on_the_card(cuda_device):
    pol = QuantPolicy(bits_k=16.0, bits_v=16.0, clip=False, reorder=False,
                      window=0, n_sink=0)
    cache = kvc.init_cache(2, 16, 2, 64, pol, device=cuda_device)
    kn = torch.zeros((2, 1, 2, 64), device=cuda_device,
                     dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="fp16"):
        KQ.kv_append(cache, kn, kn, pol)


def _ragged(rng, dev, hkv, gq, d, s_mask=1024, bs=256):
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=64, window=0,
                      n_sink=0)
    mk = lambda: torch.from_numpy(rng.normal(size=(4, s_mask - 40, hkv, d))
                                  .astype(np.float32)).to(dev)
    k_qt = quantize_groups(mk(), 2.0, 64)
    v_qt = quantize_groups(mk(), 1.5, 64)
    live = np.asarray([0, 90, 600, 980])
    lo = np.asarray([0, 0, 300, 500])
    j = np.arange(s_mask)
    mask = ((j[None] < live[:, None]) & (j[None] >= lo[:, None]))
    mask = torch.from_numpy(mask.astype(np.float32)).to(dev)
    bounds = seg.packed_block_bounds(mask > 0, bs)
    q = torch.from_numpy(rng.normal(size=(4, hkv, gq, d))
                         .astype(np.float32)).to(dev)
    return pol, q, k_qt, v_qt, mask, bounds, bs


@pytest.mark.parametrize("gq,hkv,d,cap", [
    (1, 32, 128, 0.0), (1, 32, 128, 30.0), (4, 8, 64, 0.0), (4, 8, 64, 30.0),
    (7, 4, 128, 0.0),          # qwen2-vl: Gq 7 on the G = 8 template
    (2, 4, 256, 0.0),          # gemma3
    (2, 16, 128, 50.0),        # gemma2's softcap; slots 2, 3 have lo > 0
    (5, 5, 64, 0.0)])          # hymba: Hkv 5 (one head a CTA), Gq 5
def test_decode_attn_kernel_matches_plain(gq, hkv, d, cap, cuda_device):
    rng = np.random.default_rng(1)
    pol, q, k_qt, v_qt, mask, bounds, bs = _ragged(rng, cuda_device, hkv, gq,
                                                   d)
    args = (q, k_qt, v_qt, mask, pol, d, d ** -0.5)
    got = DA.decode_attn(*args, block_s=bs, softcap=cap, block_bounds=bounds)
    want = DA.decode_attn_plain(*args, block_s=bs, softcap=cap,
                                block_bounds=bounds)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    full = DA.decode_attn(*args, block_s=bs, softcap=cap)
    for a, b in zip(got, full):
        assert torch.equal(a, b)


def test_decode_attn_odd_kv_heads_take_one_head_a_cta(cuda_device):
    """Hkv 5 (hymba): the launch plan falls to one kv head a CTA (the
    kernel's ``hkv % hg`` guard), and the kernel at the serve-size mask
    (4096 packed, hymba's Gq 5 on the G 8 template) matches its plain
    version, pruned == full bitwise."""
    assert DA.launch_plan(4, 5, 64, QuantPolicy(bits_k=2.0, bits_v=1.5,
                                                group_size=128), 4096, 256,
                          cuda_device)[0] == 1
    rng = np.random.default_rng(5)
    pol, q, k_qt, v_qt, mask, bounds, bs = _ragged(rng, cuda_device, 5, 5,
                                                   64, s_mask=4096)
    args = (q, k_qt, v_qt, mask, pol, 64, 0.125)
    got = DA.decode_attn(*args, block_s=bs, block_bounds=bounds)
    want = DA.decode_attn_plain(*args, block_s=bs, block_bounds=bounds)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    for a, b in zip(got, DA.decode_attn(*args, block_s=bs)):
        assert torch.equal(a, b)


def test_decode_attn_over_a_cross_cache(cuda_device):
    """The enc-dec cross cache: frames quantized whole under
    ``without_window()`` (window 0, no sinks: every frame packed, no fp
    segment), attended by the decode wrapper, one decode_attn launch,
    against the same call on the CPU (the plain version) at the f32
    tolerance."""
    from repro_torch.kernels import ops
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=128, window=128,
                      n_sink=5).without_window()
    rng = np.random.default_rng(6)
    kv = [torch.from_numpy(rng.normal(size=(4, 1024, 16, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2)]
    cache = kvc.prefill(kv[0].to(cuda_device), kv[1].to(cuda_device), 1024,
                        pol, quant_fn=ops.make_kernel_quant_fn())
    assert not any(k.startswith(("sink_", "win_")) for k in cache)
    q = torch.from_numpy(rng.normal(size=(4, 1, 16, 64)).astype(np.float32))
    before = DA.LAUNCHES["kernel"]
    got = ops.cuda_decode_attention(q.to(cuda_device), cache, pol,
                                    scale=0.125, dtype=torch.float32)
    assert DA.LAUNCHES["kernel"] == before + 1
    want = ops.cuda_decode_attention(q, {k: v.cpu() for k, v in
                                         cache.items()}, pol, scale=0.125,
                                     dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)


def test_decode_attn_many_splits_with_dead_ones(cuda_device):
    """S_mask = 16384 at B = 2, Hkv = 2 cuts each slot into many splits:
    slot 0 has no live token (every split empty), slot 1's live range
    starts past several splits and ends inside one."""
    rng = np.random.default_rng(6)
    b, hkv, gq, d, s_mask, bs = 2, 2, 2, 64, 16384, 256
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=64, window=0,
                      n_sink=0)
    hg, tps, n_splits = DA.split_plan(s_mask // bs, bs, b, hkv, 31, 132)
    assert n_splits >= 16 and 5000 > 3 * tps * bs
    mk = lambda: torch.from_numpy(rng.normal(size=(b, s_mask - 100, hkv, d))
                                  .astype(np.float32)).to(cuda_device)
    k_qt = quantize_groups(mk(), 2.0, 64)
    v_qt = quantize_groups(mk(), 1.5, 64)
    j = np.arange(s_mask)
    mask = np.zeros((b, s_mask), np.float32)
    mask[1] = ((j >= 5000) & (j < 9000) & (rng.uniform(size=s_mask) < 0.8))
    mask = torch.from_numpy(mask).to(cuda_device)
    bounds = seg.packed_block_bounds(mask > 0, bs)
    q = torch.from_numpy(rng.normal(size=(b, hkv, gq, d))
                         .astype(np.float32)).to(cuda_device)
    args = (q, k_qt, v_qt, mask, pol, d, d ** -0.5)
    got = DA.decode_attn(*args, block_s=bs, block_bounds=bounds)
    again = DA.decode_attn(*args, block_s=bs, block_bounds=bounds)
    full = DA.decode_attn(*args, block_s=bs)
    want = DA.decode_attn_plain(*args, block_s=bs, block_bounds=bounds)
    torch.cuda.synchronize()
    assert torch.equal(got[1][0], torch.full_like(got[1][0], DA.NEG))
    assert not got[0][0].any() and not got[2][0].any()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)
    for a, r, f in zip(got, again, full):
        assert torch.equal(a, r) and torch.equal(a, f)


MODES = [  # bits_k, bits_v, group, fp8_meta, gq, d
    (2.0, 1.5, 128, True, 1, 128),     # the paper's policy, MHA
    (2.0, 1.5, 16, True, 2, 16),       # smoke-model head dim
    (4.0, 3.0, 32, True, 2, 64),       # two planes of 4 and 2 bits
    (1.0, 8.0, 64, False, 8, 128),     # 1-bit K, 8-bit V, fp16 meta
    (8.0, 4.0, 32, False, 3, 96),      # Gq 3 padded to 4, 24 quads
    (2.0, 1.5, 64, True, 2, 256),      # two quads per lane
]


@pytest.mark.parametrize("mode", MODES)
def test_decode_attn_kernel_every_plane_mode(mode, cuda_device):
    bk, bv, gs, fp8, gq, d = mode
    rng = np.random.default_rng(7)
    pol = QuantPolicy(bits_k=bk, bits_v=bv, group_size=gs, window=0,
                      n_sink=0, fp8_meta=fp8)
    b, hkv, s_mask, bs = 3, 4, 1024, 128
    g = min(gs, d)
    mk = lambda: torch.from_numpy(rng.normal(size=(b, s_mask - 24, hkv, d))
                                  .astype(np.float32)).to(cuda_device)
    k_qt = quantize_groups(mk(), bk, g, fp8_meta=fp8)
    v_qt = quantize_groups(mk(), bv, g, fp8_meta=fp8)
    mask = torch.from_numpy((rng.uniform(size=(b, s_mask)) < 0.6)
                            .astype(np.float32)).to(cuda_device)
    mask[0, 300:] = 0.0
    mask[:, s_mask - 24:] = 0.0       # past the planes, as the caller masks
    bounds = seg.packed_block_bounds(mask > 0, bs)
    q = torch.from_numpy(rng.normal(size=(b, hkv, gq, d))
                         .astype(np.float32)).to(cuda_device)
    args = (q, k_qt, v_qt, mask, pol, d, d ** -0.5)
    got = DA.decode_attn(*args, block_s=bs, block_bounds=bounds)
    want = DA.decode_attn_plain(*args, block_s=bs, block_bounds=bounds)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)
    full = DA.decode_attn(*args, block_s=bs)
    for a, f in zip(got, full):
        assert torch.equal(a, f)


def _pooled(rng, dev, hkv, gq, d, bt=16, nb=64, live=(0, 90, 600, 980),
            lo=(0, 0, 300, 500), permute=True):
    """Pool-major planes with per-slot tables: a seeded permutation of the
    physical blocks, slots 1 and 2 sharing their first two entries, and
    the null block past each slot's frontier."""
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=64, window=0,
                      n_sink=0)
    b = len(live)
    n_phys = b * nb + 1
    mk = lambda: torch.from_numpy(rng.normal(size=(n_phys, bt, hkv, d))
                                  .astype(np.float32)).to(dev)
    k_qt = quantize_groups(mk(), 2.0, 64)
    v_qt = quantize_groups(mk(), 1.5, 64)
    ids = np.arange(1, n_phys)
    tbl = (rng.permutation(ids) if permute else ids).reshape(b, nb)
    tbl[2, :2] = tbl[1, :2]
    for i, n in enumerate(live):
        tbl[i, -(-n // bt):] = 0
    s = nb * bt
    j = np.arange(s)
    mask = ((j[None] < np.asarray(live)[:, None])
            & (j[None] >= np.asarray(lo)[:, None]))
    mask = torch.from_numpy(mask.astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(b, hkv, gq, d))
                         .astype(np.float32)).to(dev)
    tbl = torch.from_numpy(tbl.astype(np.int32)).to(dev)
    return pol, q, k_qt, v_qt, mask, tbl


@pytest.mark.parametrize("gq,hkv,d", [(1, 32, 128), (4, 8, 64)])
@pytest.mark.parametrize("permute", [True, False])
def test_decode_attn_pooled_kernel_matches_plain(gq, hkv, d, permute,
                                                 cuda_device):
    rng = np.random.default_rng(2)
    pol, q, k_qt, v_qt, mask, tbl = _pooled(rng, cuda_device, hkv, gq, d,
                                            permute=permute)
    bs = 256
    bounds = seg.packed_block_bounds(mask > 0, bs)
    args = (q, k_qt, v_qt, mask, pol, d, d ** -0.5)
    before = dict(DA.LAUNCHES)
    got = DA.decode_attn(*args, block_s=bs, block_bounds=bounds,
                         block_table=tbl)
    assert DA.LAUNCHES["pooled"] == before["pooled"] + 1
    assert DA.LAUNCHES["kernel"] == before["kernel"]
    want = DA.decode_attn_plain(*args, block_s=bs, block_bounds=bounds,
                                block_table=tbl)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    full = DA.decode_attn(*args, block_s=bs, block_table=tbl)
    for a, b in zip(got, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bs", [256, 64, 16])
def test_decode_attn_pooled_bitwise_equals_striped(bs, cuda_device):
    rng = np.random.default_rng(3)
    pol, q, k_qt, v_qt, mask, tbl = _pooled(rng, cuda_device, 8, 4, 64)
    bounds = seg.packed_block_bounds(mask > 0, bs)
    args = (q, mask, pol, 64, 0.125)
    pooled = DA.decode_attn(args[0], k_qt, v_qt, *args[1:], block_s=bs,
                            block_bounds=bounds, block_table=tbl)
    striped = DA.decode_attn(args[0], DA.gather_planes(k_qt, tbl),
                             DA.gather_planes(v_qt, tbl), *args[1:],
                             block_s=bs, block_bounds=bounds)
    torch.cuda.synchronize()
    for a, b in zip(pooled, striped):
        assert torch.equal(a, b)


def test_decode_attn_pooled_rejects_bad_shapes(cuda_device):
    rng = np.random.default_rng(4)
    pol, q, k_qt, v_qt, mask, tbl = _pooled(rng, cuda_device, 8, 4, 64)
    with pytest.raises(ValueError, match="block_table"):
        DA.decode_attn(q, k_qt, v_qt, mask, pol, 64, 0.125,
                       block_table=tbl[:2])
    with pytest.raises(ValueError, match="mask"):
        DA.decode_attn(q, k_qt, v_qt, mask[:, :-256], pol, 64, 0.125,
                       block_table=tbl)


@pytest.mark.parametrize("arch", ["llama3p2_1b", "llama2_7b",
                                  "deepseek_moe_16b", "granite_moe_1b_a400m"])
def test_decode_step_cuda_backend_matches_reference(arch, cuda_device):
    cfg = configs.get_smoke(arch)
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=2)
    params = T.init_params(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(0))
    _, base = T.prefill_model(params, cfg, toks, pol, max_len=64,
                              backend="cuda")
    clone = lambda: {"scan": {k: v.clone() for k, v in base["scan"].items()}}
    tok = toks[:, -1:]
    got, _ = T.decode_step(params, cfg, tok, clone(), pol, backend="cuda")
    want, _ = T.decode_step(params, cfg, tok, clone(), pol,
                            backend="reference")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_unrolled_gemma3_step_on_the_card(cuda_device):
    """gemma3 smoke (5 of 6 layers local, window 8; 52 packed slots): the
    unrolled step (the hoisted slice, pre-append attends) on the kernels
    against the default step, f32, ``atol=rtol=1e-4``; one striped
    decode_attn launch a layer, over the slices on the local ones."""
    cfg = configs.get_smoke("gemma3_4b")
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=4)
    params = T.init_params(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(0))
    _, base = T.prefill_model(params, cfg, toks, pol, max_len=64,
                              backend="cuda")
    clone = lambda: {"scan": {k: v.clone() for k, v in base["scan"].items()}}
    unrolled, default = clone(), clone()
    for step in range(4):
        tok = toks[:, step:step + 1]
        before = DA.LAUNCHES["kernel"]
        got, unrolled = T.decode_step(params, cfg, tok, unrolled, pol,
                                      backend="cuda", unroll=True)
        assert DA.LAUNCHES["kernel"] == before + cfg.n_layers
        want, default = T.decode_step(params, cfg, tok, default, pol,
                                      backend="cuda")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_pooled_engine_streams_equal_striped_on_the_card(cuda_device):
    """The pooled Engine on the card attends through the block-table
    kernel only, and its greedy streams equal the striped Engine's."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, Request
    cfg = configs.get_smoke("llama2_7b")
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=2)
    params = T.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab_size, 40)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
               for n in (3, 3, 20, 7, 0)]
    runs = []
    for pool in (None, 40):
        eng = Engine(params, cfg, pol, batch_slots=3, max_len=90,
                     steps_per_sync=4, pool_blocks=pool, pool_block_tokens=8,
                     device=cuda_device)
        reset_launch_counts()
        hs = [eng.submit(Request(prompt=p, max_new=12, seed=i))
              for i, p in enumerate(prompts)]
        eng.run(hs)
        c = launch_counts()["decode_attn"]
        steps = cfg.n_layers * eng.n_decode_steps
        assert c["plain"] == 0
        assert (c["pooled"], c["kernel"]) == ((steps, 0) if pool else
                                              (0, steps))
        runs.append([h.tokens for h in hs])
        if pool:
            st = eng.stats()
            assert st["prefix_hits"] > 0 and st["cow_copies"] > 0
            eng.check_invariants()
    assert runs[0] == runs[1]


# ------------------------------------------------ serving harness (§10)

HARNESS_POL = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                          n_sink=2)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "granite_moe_1b_a400m"])
def test_moe_on_the_card(arch, cuda_device):
    """The MoE FFN on the card: both dispatches within f32 ``atol=1e-5``
    of the CPU's on tokens that overflow an expert; a warmed Engine (the
    MoE decode step captured as a CUDA graph) gives the unwarmed
    Engine's streams, with one kv_append and one decode_attn launch a
    layer a step and no post-warmup miss."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import moe as M
    from repro_torch.serving import Engine, Request
    cfg = configs.get_smoke(arch)
    cpu = T.init_params(cfg, seed=0, device="cpu")
    p = {k: v[0] for k, v in cpu["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32))
    for dispatch in ("grouped", "scatter"):
        c = dataclasses.replace(cfg, moe_dispatch=dispatch)
        want, _ = M.moe_ffn(x, p, c)
        got, _ = M.moe_ffn(x.to(cuda_device), {
            k: v.to(cuda_device) for k, v in p.items()}, c)
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    params = T.init_params(cfg, seed=0, device=cuda_device)
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=2)
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new=m,
                    seed=i)
            for i, (n, m) in enumerate(zip((20, 20, 12, 7), (9, 6, 8, 7)))]
    streams = []
    for warm in (False, True):
        eng = Engine(params, cfg, pol, batch_slots=2, max_len=64,
                     steps_per_sync=4, device=cuda_device)
        if warm:
            assert eng.warmup()["n_graphs"] == 1
        reset_launch_counts()
        streams.append(_serve(eng, reqs))
        c, n = launch_counts(), cfg.n_layers * eng.n_decode_steps
        assert c["kv_quant"]["append"] == n == c["decode_attn"]["kernel"]
        assert c["decode_attn"]["plain"] == c["kv_quant"]["plain"] == 0
    assert eng._graphs.replays == eng.n_decode_steps
    assert eng.warmup_report()["post_warmup_misses"] == 0
    assert streams[0] == streams[1]


def test_hybrid_engine_on_the_card(cuda_device):
    """hymba smoke: a warmed Engine (the step with its in-place SSM state
    updates captured as a CUDA graph) gives the unwarmed Engine's
    streams, with one kv_append and one decode_attn launch a layer a step
    and no post-warmup miss; one step's cuda logits within f32
    ``atol=rtol=1e-4`` of the reference backend's."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, Request
    cfg = configs.get_smoke("hymba_1p5b")
    params = T.init_params(cfg, seed=0, device=cuda_device)
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=2)
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new=m,
                    seed=i)
            for i, (n, m) in enumerate(zip((20, 20, 12, 7), (9, 6, 8, 7)))]
    streams = []
    for warm in (False, True):
        eng = Engine(params, cfg, pol, batch_slots=2, max_len=64,
                     steps_per_sync=4, device=cuda_device)
        if warm:
            assert eng.warmup()["n_graphs"] == 1
        reset_launch_counts()
        streams.append(_serve(eng, reqs))
        c, n = launch_counts(), cfg.n_layers * eng.n_decode_steps
        assert c["kv_quant"]["append"] == n == c["decode_attn"]["kernel"]
        assert c["decode_attn"]["plain"] == c["kv_quant"]["plain"] == 0
    assert eng.warmup_report()["post_warmup_misses"] == 0
    assert streams[0] == streams[1]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 30)),
                           device=cuda_device)
    _, base = T.prefill_model(params, cfg, toks, pol, max_len=64)
    tok = toks[:, -1:]
    out = {}
    for name in ("cuda", "reference"):
        c = {"scan": {k: v.clone() for k, v in base["scan"].items()}}
        out[name] = T.decode_step(params, cfg, tok, c, pol,
                                  backend=name)[0]
    torch.testing.assert_close(out["cuda"], out["reference"], atol=1e-4,
                               rtol=1e-4)


def test_encdec_step_on_the_card(cuda_device):
    """seamless smoke: prefill from frames, then decode steps with two
    decode_attn launches a layer a step (self and cross) and one
    kv_append, the cross cache never written; a captured step replayed
    BYTE-equal to eager steps; cuda logits within f32 ``atol=rtol=1e-4``
    of the reference backend's."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg = configs.get_smoke("seamless_m4t_large_v2")
    params = T.init_params(cfg, seed=0, device=cuda_device)
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=2)
    gen = torch.Generator(cuda_device).manual_seed(7)
    frames = torch.randn((2, cfg.enc_seq_len, cfg.d_model), generator=gen,
                         device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 30), generator=gen,
                         device=cuda_device)
    reset_launch_counts()
    _, base = T.prefill_model(params, cfg, toks, pol, max_len=64,
                              enc_embeds=frames)
    assert launch_counts()["kv_quant"]["kernel"] == 4 * cfg.n_layers
    clone = lambda: {"scan": {k: v.clone() for k, v in base["scan"].items()}}
    tok = toks[:, -1:].contiguous()
    ref = T.decode_step(params, cfg, tok, clone(), pol,
                        backend="reference")[0]
    eager, graphed = clone(), clone()
    reset_launch_counts()
    logits = [T.decode_step(params, cfg, tok, eager, pol)[0]
              for _ in range(3)]
    c = launch_counts()
    assert c["decode_attn"]["kernel"] == 2 * 3 * cfg.n_layers
    assert c["kv_quant"]["append"] == 3 * cfg.n_layers
    torch.testing.assert_close(logits[0], ref, atol=1e-4, rtol=1e-4)
    for k, v in eager["scan"].items():
        if k.startswith("x_"):
            assert torch.equal(v, base["scan"][k]), k
    warm = clone()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        T.decode_step(params, cfg, tok, warm, pol)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = T.decode_step(params, cfg, tok, graphed, pol)
    for k, v in clone()["scan"].items():   # the capture ran no step
        graphed["scan"][k].copy_(v)
    for step in range(3):
        graph.replay()
        assert torch.equal(out, logits[step]), step
    torch.cuda.synchronize()
    for k in eager["scan"]:
        assert torch.equal(graphed["scan"][k], eager["scan"][k]), k


def _harness_engine(cuda_device, pool=None, **kw):
    from repro_torch.serving import Engine
    cfg = configs.get_smoke("llama2_7b")
    params = T.init_params(cfg, seed=0, device=cuda_device)
    eng = Engine(params, cfg, HARNESS_POL, batch_slots=3, max_len=90,
                 steps_per_sync=4, pool_blocks=pool, pool_block_tokens=8,
                 device=cuda_device, **kw)
    return cfg, eng


def _harness_traffic(cfg, temps=(0.0,)):
    from repro_torch.serving import Request
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, cfg.vocab_size, 40)
    return [Request(prompt=np.concatenate(
                [prefix, rng.integers(0, cfg.vocab_size, n)]),
                max_new=m, seed=i, temperature=temps[i % len(temps)])
            for i, (n, m) in enumerate([(3, 12), (3, 9), (20, 14), (7, 5),
                                        (0, 11)])]


def _serve(eng, reqs):
    from repro_torch.serving import Request
    hs = [eng.submit(Request(prompt=r.prompt, max_new=r.max_new, seed=r.seed,
                             temperature=r.temperature, eos_id=r.eos_id))
          for r in reqs]
    eng.run(hs)
    eng.close()
    return [(h.tokens, h.finish_reason) for h in hs]


def _leaf_bytes(t):
    return t.view(torch.uint8) if t.dtype != torch.bool else t


@pytest.mark.parametrize("pool", [None, 40])
def test_graph_replayed_step_bytewise_equals_eager_step(pool, cuda_device):
    """Caches mid-stream (two slots admitted, one chunk decoded, then the
    Engine's copy-on-write pass and table flush for the next chunk, so no
    write lands in a shared or unowned block): ``steps_per_sync``
    replays of a captured ``decode_step`` against as many eager steps
    from the same bytes — every cache leaf and the logits equal
    bytewise."""
    from repro_torch.serving import GraphCache
    cfg, eng = _harness_engine(cuda_device, pool)
    hs = [eng.submit(r) for r in _harness_traffic(cfg)[:2]]
    eng.step()
    assert all(not h.finished for h in hs)
    if pool:
        eng._pool_prewrite()
        eng._flush_tables()
    snap = {k: v.clone() for k, v in eng._caches["scan"].items()}
    cg = {"scan": {k: v.clone() for k, v in snap.items()}}
    ce = {"scan": {k: v.clone() for k, v in snap.items()}}
    tok = torch.as_tensor(eng._tok, device=cuda_device)

    def step(caches):
        return lambda token: T.decode_step(
            eng.params, cfg, token, caches, HARNESS_POL, calib=eng.calib,
            backend="cuda")[0]

    gc = GraphCache(cuda_device)
    gc.warm("step", step(cg), (tok.clone(),))
    for k, v in cg["scan"].items():           # undo the warmup iterations
        v.copy_(snap[k])
    te = tg = tok
    for i in range(eng.steps_per_sync):
        got = gc.call("step", step(cg), tg)
        want = step(ce)(te)
        torch.cuda.synchronize()
        assert torch.equal(_leaf_bytes(got), _leaf_bytes(want)), i
        for k in snap:
            assert torch.equal(_leaf_bytes(cg["scan"][k]),
                               _leaf_bytes(ce["scan"][k])), (i, k)
        te = want[:, -1].argmax(-1, keepdim=True)
        tg = got[:, -1].argmax(-1, keepdim=True)
    assert gc.replays == eng.steps_per_sync and gc.n_graphs == 1


def test_launch_counts_after_replays(cuda_device):
    """A replay runs no wrapper, so the cache adds the capture's launches
    once per replay, and the capture itself counts none."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import GraphCache
    cfg, eng = _harness_engine(cuda_device)
    eng.submit(_harness_traffic(cfg)[0])
    eng.step()
    tok = torch.as_tensor(eng._tok, device=cuda_device)
    fn = lambda token: T.decode_step(eng.params, cfg, token, eng._caches,
                                     HARNESS_POL, calib=eng.calib,
                                     backend="cuda")[0]
    gc = GraphCache(cuda_device)
    reset_launch_counts()
    gc.warm("step", fn, (tok,))
    warm = launch_counts()
    n_l = cfg.n_layers
    assert warm["decode_attn"]["kernel"] == 3 * n_l    # warmup iterations
    assert warm["kv_quant"]["append"] == 3 * n_l
    reset_launch_counts()
    for _ in range(7):
        gc.call("step", fn, tok)
    c = launch_counts()
    assert c["decode_attn"] == {"kernel": 7 * n_l, "pooled": 0, "plain": 0}
    assert c["kv_quant"] == {"kernel": 0, "plain": 0, "append": 7 * n_l,
                             "append_plain": 0, "chunk_plain": 0}


def test_replays_match_the_captured_region_map(cuda_device):
    """A captured smoke ``decode_one`` replayed under the profiler: every
    whole replay between the ``repro_replay_begin`` / ``_end`` markers
    holds the map's device operations, every region of a dense step takes
    device time, nothing falls under ``other``, and every call opens its
    three host spans."""
    import json
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import spans
    from repro_torch.serving import GraphCache, decode_one
    cfg, eng = _harness_engine(cuda_device)
    eng.submit(_harness_traffic(cfg)[0])
    eng.step()
    b = eng.batch_slots
    ins = (torch.as_tensor(eng._tok, device=cuda_device),
           torch.zeros(b, dtype=torch.bool, device=cuda_device),
           torch.zeros(b, dtype=torch.bool, device=cuda_device),
           torch.zeros(b, dtype=torch.int32, device=cuda_device),
           torch.zeros(b, dtype=torch.float32, device=cuda_device),
           torch.full((b,), -1, dtype=torch.int64, device=cuda_device))

    def fn(token, *rest):
        return decode_one(eng.params, cfg, HARNESS_POL, token, eng._caches,
                          *rest, backend="cuda")
    gc = GraphCache(cuda_device)
    gc.warm("spans_step", fn, ins)
    op_map = spans.op_maps()["spans_step"]
    assert gc.report()["graphs"][0]["ops"] == op_map.total > 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            gc.call("spans_step", fn, *ins)
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            events = json.load(g)["traceEvents"]
    ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    got = spans.attribute(ops, op_map)
    assert got is not None, (op_map.total, [n for n, _, _ in ops][:80])
    assert got.replays == 5
    assert got.seconds.get(spans.OTHER, 0.0) == 0.0, got.seconds
    by = got.by_name()
    for name in ("embed", "attn.qkv", "attn.perm", "attn.append",
                 "attn.mask", "attn.kernel", "attn.segment", "attn.out",
                 "mlp", "head"):
        assert by.get(name, 0.0) > 0.0, (name, by)
    host = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for kind in ("call", "copy_in", "launch"):
        assert host.count(f"graph.{kind}:spans_step") == 5, kind


@pytest.mark.parametrize("pool", [None, 40])
def test_warmed_engine_buffers_stay_put(pool, cuda_device):
    """The graph is bound to addresses: every cache leaf and every static
    input keeps its data_ptr across admissions, chunks and retirements;
    warmed streams equal the unwarmed engine's; kv_append and decode_attn
    launches equal layers x decode steps with graphs on."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg, eng = _harness_engine(cuda_device, pool)
    rep = eng.warmup()
    assert rep["n_graphs"] == 1 and rep["post_warmup_misses"] == 0
    entry = next(iter(eng._graphs._entries.values()))
    ptrs = lambda: ([v.data_ptr() for v in eng._caches["scan"].values()]
                    + [t.data_ptr() for t in entry.static_in])
    before = ptrs()
    reset_launch_counts()
    warm = _serve(eng, _harness_traffic(cfg))
    assert ptrs() == before
    c = launch_counts()
    n = cfg.n_layers * eng.n_decode_steps
    assert c["kv_quant"]["append"] == n and c["kv_quant"]["append_plain"] == 0
    assert c["decode_attn"]["pooled" if pool else "kernel"] == n
    assert eng._graphs.replays == eng.n_decode_steps
    assert eng.warmup_report()["post_warmup_misses"] == 0
    _, cold = _harness_engine(cuda_device, pool)
    assert warm == _serve(cold, _harness_traffic(cfg))


def test_warmed_async_sampled_streams_equal_eager_sync(cuda_device):
    """Mixed temperatures and an EOS id: warmed + async equals unwarmed +
    sync on the card."""
    cfg, ref = _harness_engine(cuda_device)
    reqs = _harness_traffic(cfg, temps=(0.0, 0.8, 0.5))
    want = _serve(ref, reqs)
    eos = want[0][0][2]
    reqs = [dataclasses.replace(r, eos_id=eos) for r in reqs]
    _, ref = _harness_engine(cuda_device)
    want = _serve(ref, reqs)
    _, eng = _harness_engine(cuda_device, async_host=True)
    eng.warmup()
    assert _serve(eng, reqs) == want
    assert any(r == "eos" for _, r in want)


def test_pinned_ring_never_hands_over_overwritten_tokens(cuda_device):
    """host_queue=1 (a ring of 2 pinned buffers) and a consumer that
    holds its first item until the scheduler has had to wait: the
    scheduler waits for a buffer's release instead of overwriting it, and
    the delivered streams equal the sync ones."""
    cfg, ref = _harness_engine(cuda_device)
    reqs = _harness_traffic(cfg)
    want = _serve(ref, reqs)
    _, eng = _harness_engine(cuda_device, async_host=True, host_queue=1)
    eng.warmup()
    eng._host._fault_hook = lambda item: stall_until_backpressure(eng)
    got = _serve(eng, reqs)
    assert got == want
    assert len(eng._ring) == 2
    assert all(t.is_pinned() for t in eng._ring)
    assert eng.stats()["host"]["backpressure_waits"] > 0


# --------------------------------------------------- chunked prefill (§7)

@pytest.mark.parametrize("d,hkv,gs", [(128, 32, 128), (64, 8, 64)])
@pytest.mark.parametrize("window,n_sink", [(32, 5), (0, 5), (32, 0)])
def test_kv_append_chunk_matches_plain_and_kv_append_loop(d, hkv, gs, window,
                                                          n_sink,
                                                          cuda_device):
    """The chunk append's bulk route on the card leaves every leaf of a
    bf16 cache byte-equal to its plain token loop and to a loop of the
    fused ``kv_append`` kernel, after every chunk: chunks that straddle
    the sinks, shorter and longer than the window, padded tails; two bulk
    launches for a chunk that evicts, none for one that does not."""
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=gs, window=window,
                      n_sink=n_sink)
    max_len = 301
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    caches = [kvc.init_cache(1, max_len, hkv, d, pol, torch.bfloat16,
                             device=cuda_device) for _ in range(3)]
    route, plain, loop = caches
    ak, av = (0.8 + 0.2 * torch.rand((hkv, n_meta_groups(d, b, gs)),
                                     generator=gen, device=cuda_device)
              for b in (pol.bits_k, pol.bits_v))
    t0 = 0
    for n, c in ((3, 8), (1, 8), (20, 32), (64, 64), (6, 8), (100, 128),
                 (64, 64), (43, 64)):
        k, v = (torch.randn((1, c, hkv, d), generator=gen,
                            device=cuda_device).to(torch.bfloat16)
                for _ in range(2))
        before = KQ.LAUNCHES["kernel"]
        KQ.kv_append_chunk(route, k, v, pol, t0, n, ak, av)
        lo, hi = KQ.chunk_evictions(pol, t0, n)
        # no window: the token loop also quantizes a chunk that ends
        # inside the sinks (into packed row 0, where its index clamps)
        quantizes = lo < hi or (window == 0 and t0 + n <= n_sink)
        assert KQ.LAUNCHES["kernel"] - before == (2 if quantizes else 0)
        KQ.kv_append_chunk_plain(plain, k, v, pol, t0, n, ak, av)
        for i in range(n):
            KQ.kv_append(loop, k[:, i:i + 1].contiguous(),
                         v[:, i:i + 1].contiguous(), pol, ak, av)
        torch.cuda.synchronize()
        for key in route:
            for other, what in ((plain, "plain"), (loop, "kv_append loop")):
                a, b = route[key], other[key]
                if a.dtype == torch.bfloat16:
                    a, b = a.view(torch.int16), b.view(torch.int16)
                assert torch.equal(a, b), (key, what, t0, n)
        t0 += n
    assert t0 == max_len and int(route["length"]) == max_len


def test_chunked_engine_on_the_card(cuda_device):
    """Warmed chunked Engines on the card, striped and pooled: equal greedy
    streams, no post-warmup graph miss, two bulk kv_quant launches per
    layer per evicting chunk, one kv_append per layer per decode step, no
    plain call."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, Request
    cfg = configs.get_smoke("llama2_7b")
    params = T.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (70, 9, 33, 50)]
    runs = []
    for pool in (None, 40):
        eng = Engine(params, cfg, HARNESS_POL, batch_slots=2, max_len=90,
                     steps_per_sync=4, prefill_chunk=16, pool_blocks=pool,
                     pool_block_tokens=8, device=cuda_device)
        eng.warmup()
        reset_launch_counts()
        hs = [eng.submit(Request(prompt=p, max_new=10, seed=i))
              for i, p in enumerate(prompts)]
        eng.run(hs)
        c = launch_counts()["kv_quant"]
        chunks = 0
        for p in prompts:
            for t0 in range(0, len(p), 16):
                lo, hi = KQ.chunk_evictions(HARNESS_POL, t0,
                                            min(16, len(p) - t0))
                chunks += lo < hi
        assert c["kernel"] == 2 * cfg.n_layers * chunks
        assert c["append"] == cfg.n_layers * eng.n_decode_steps
        assert c["plain"] == c["append_plain"] == c["chunk_plain"] == 0
        assert eng.warmup_report()["post_warmup_misses"] == 0
        if pool:
            eng.check_invariants()
        runs.append([h.tokens for h in hs])
    assert runs[0] == runs[1]


# -------------------------------------------------- policy schedules (§8)

LADDER_WIDTHS = [(4.0, 4.0), (2.0, 2.0)]


@pytest.mark.parametrize("bits", LADDER_WIDTHS)
@pytest.mark.parametrize("pooled", [False, True])
def test_kv_append_at_ladder_widths_matches_plain(bits, pooled, cuda_device):
    pol, kc, pc, (ak, av), gen = _append_case(cuda_device, 13, 128, 32, 128,
                                              32, pooled, bits=bits)
    b = kc["length"].shape[0]
    for step in range(120):
        kn = torch.randn((b, 1, 32, 128), generator=gen, device=cuda_device
                         ).to(torch.bfloat16)
        vn = torch.randn_like(kn)
        KQ.kv_append(kc, kn, vn, pol, ak, av)
        KQ.kv_append_plain(pc, kn, vn, pol, ak, av)
        _caches_equal(kc, pc, pooled, f"{bits} step {step}")


@pytest.mark.parametrize("bits", LADDER_WIDTHS)
@pytest.mark.parametrize("gq,hkv", [(1, 32), (4, 8)])
def test_decode_attn_at_ladder_widths_matches_plain(bits, gq, hkv,
                                                    cuda_device):
    """Striped and block-table launches at (4, 4) (the word-unpack path of
    both planes) and (2, 2), D 128, against the plain version; pooled
    BITWISE equal to striped over the gathered planes."""
    rng = np.random.default_rng(8)
    pol = QuantPolicy(bits_k=bits[0], bits_v=bits[1], group_size=128,
                      window=0, n_sink=0)
    b, d, bt, nb, bs = 3, 128, 16, 64, 256
    mk = lambda: torch.from_numpy(rng.normal(size=(b, nb * bt, hkv, d))
                                  .astype(np.float32)).to(cuda_device)
    k_st = quantize_groups(mk(), bits[0], 128)
    v_st = quantize_groups(mk(), bits[1], 128)
    mask = torch.zeros((b, nb * bt), device=cuda_device)
    for i, n in enumerate((0, 300, 1000)):
        mask[i, :n] = 1.0
    bounds = seg.packed_block_bounds(mask > 0, bs)
    q = torch.from_numpy(rng.normal(size=(b, hkv, gq, d))
                         .astype(np.float32)).to(cuda_device)
    args = (q, k_st, v_st, mask, pol, d, d ** -0.5)
    got = DA.decode_attn(*args, block_s=bs, block_bounds=bounds)
    want = DA.decode_attn_plain(*args, block_s=bs, block_bounds=bounds)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)
    perm = rng.permutation(np.arange(1, b * nb + 1))
    tbl = torch.from_numpy(perm.reshape(b, nb).astype(np.int32)
                           ).to(cuda_device)
    pool = lambda qt: {k: torch.cat([torch.zeros_like(
        v.reshape((b * nb, bt) + tuple(v.shape[2:]))[:1]), v.reshape(
            (b * nb, bt) + tuple(v.shape[2:]))[torch.from_numpy(
                np.argsort(perm)).to(cuda_device)]]) for k, v in qt.items()}
    pooled = DA.decode_attn(q, pool(k_st), pool(v_st), mask, pol, d,
                            d ** -0.5, block_s=bs, block_bounds=bounds,
                            block_table=tbl)
    for a, w in zip(pooled, got):
        assert torch.equal(a, w)


def test_fp16_decode_route_matches_reference_backend(cuda_device):
    """The fp16 branch of ``cuda_decode_attention`` (the guard layers'
    route: dense partial, no kernel) against the reference backend's fp16
    attention, f32 on the card."""
    from repro_torch.core.policy import FP16_POLICY
    from repro_torch.kernels import ops
    from repro_torch.models.attention import decode_attention_skvq
    rng = np.random.default_rng(9)
    cfg = configs.get_smoke("llama2_7b")
    b, s = 3, 70
    cache = {"k": torch.from_numpy(rng.normal(size=(
                 b, s, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)),
             "v": torch.from_numpy(rng.normal(size=(
                 b, s, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)),
             "length": torch.tensor([1, 33, 70], dtype=torch.int32)}
    cache = {k: v.to(cuda_device) for k, v in cache.items()}
    q = torch.from_numpy(rng.normal(size=(
        b, 1, cfg.n_heads, cfg.head_dim)).astype(np.float32)).to(cuda_device)
    got = ops.cuda_decode_attention(q, cache, FP16_POLICY,
                                    scale=cfg.head_dim ** -0.5,
                                    dtype=torch.float32)
    want = decode_attention_skvq(q, cache, cfg, FP16_POLICY,
                                 dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("preset", ["first_last_fp16", "ladder"])
def test_scheduled_engines_on_the_card(preset, cuda_device):
    """A 4-layer smoke model under a schedule: warmed striped, pooled and
    chunked engines give the unwarmed striped engine's greedy streams; no
    graph miss; kv_append and decode_attn launch on the quantized layers
    only, the fp16 route runs on the guard layers, no plain call."""
    from repro_torch.core.policy import PolicySchedule
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, Request
    cfg = configs.get_smoke("llama2_7b").scaled(n_layers=4)
    params = T.init_params(cfg, seed=0, device=cuda_device)
    sched = (PolicySchedule.first_last_fp16(HARNESS_POL, 1)
             if preset == "first_last_fp16"
             else PolicySchedule.bits_ladder(HARNESS_POL))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (70, 9, 33, 50)]
    runs = []
    for warm, pool, chunk in ((False, None, None), (True, None, None),
                              (True, 40, None), (True, 40, 16)):
        eng = Engine(params, cfg, sched, batch_slots=2, max_len=90,
                     steps_per_sync=4, pool_blocks=pool, pool_block_tokens=8,
                     prefill_chunk=chunk, device=cuda_device)
        if warm:
            eng.warmup()
        reset_launch_counts()
        hs = [eng.submit(Request(prompt=p, max_new=10, seed=i))
              for i, p in enumerate(prompts)]
        eng.run(hs)
        c = launch_counts()
        nq = sum(not p.is_fp16 for p in eng.schedule)
        steps = eng.n_decode_steps
        assert nq == (2 if preset == "first_last_fp16" else 4)
        assert c["kv_quant"]["append"] == nq * steps
        assert c["decode_attn"]["pooled" if pool else "kernel"] == nq * steps
        assert c["fp16"]["attend"] == c["fp16"]["append"] \
            == (4 - nq) * steps
        assert c["decode_attn"]["plain"] == c["kv_quant"]["plain"] \
            == c["kv_quant"]["append_plain"] \
            == c["kv_quant"]["chunk_plain"] == 0
        if warm:
            rep = eng.warmup_report()
            assert rep["post_warmup_misses"] == 0
            assert rep["replays"] == steps
        if pool:
            assert len(eng.check_invariants()) == (
                1 if preset == "first_last_fp16" else 3)
        runs.append([h.tokens for h in hs])
    assert all(r == runs[0] for r in runs[1:])


# ------------------------------------------------- calibration (Sec. 3.1)

def _calib_samples(gen, dev, n, h, d):
    """K/V-like samples on the card: log-normal channel scales, three
    outlier channels a head."""
    scales = torch.exp(torch.randn((1, h, d), generator=gen, device=dev))
    scales[..., :3] *= 30
    return torch.randn((n, h, d), generator=gen, device=dev) * scales


@pytest.mark.parametrize("alpha_kind", ["none", "scalar", "per_head"])
@pytest.mark.parametrize("bits,d,gs", [(2.0, 128, 128), (1.5, 128, 128),
                                       (4.0, 64, 32), (1.5, 64, 16)])
def test_fake_quant_kernel_route_equals_plain(bits, d, gs, alpha_kind,
                                             cuda_device):
    """fake_quant through the bulk kv_quant kernel equals it through the
    plain quantize_groups on the card: the codes are byte-equal, so the
    values are BITWISE equal; one launch a call."""
    from repro_torch.core.quant import fake_quant
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_kernel_quant_fn
    gen = torch.Generator(device=cuda_device).manual_seed(int(bits * 10) + d)
    x = _calib_samples(gen, cuda_device, 256, 4, d)
    g = n_meta_groups(d, bits, gs)
    alpha = {"none": None,
             "scalar": torch.tensor(0.85, device=cuda_device),
             "per_head": 0.6 + 0.4 * torch.rand((4, g), generator=gen,
                                                device=cuda_device)
             }[alpha_kind]
    reset_launch_counts()
    got = fake_quant(x, bits, gs, alpha=alpha,
                     quant_fn=make_kernel_quant_fn())
    assert launch_counts()["kv_quant"]["kernel"] == 1
    want = fake_quant(x, bits, gs, alpha=alpha)
    assert torch.equal(got, want)


@pytest.mark.parametrize("gs,d,bits_v", [(128, 128, 1.5), (32, 64, 1.5),
                                         (16, 64, 2.0)])
def test_calibration_kernel_route_equals_plain(gs, d, bits_v, cuda_device):
    """calibrate_model on CUDA samples takes the kernel route (2 x 11
    grid points x layers bulk launches, no plain call) and gives the
    plain route's tables on the same card: equal permutations,
    bitwise-equal clip factors."""
    from repro_torch.core import calibrate as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gen = torch.Generator(device=cuda_device).manual_seed(gs + d)
    n_l = 2
    ks = torch.stack([_calib_samples(gen, cuda_device, 1024, 4, d)
                      for _ in range(n_l)])
    vs = torch.stack([_calib_samples(gen, cuda_device, 1024, 4, d)
                      for _ in range(n_l)])
    pol = QuantPolicy(bits_k=2.0, bits_v=bits_v, group_size=gs, window=16,
                      n_sink=4)
    reset_launch_counts()
    kern = C.calibrate_model(lambda: (ks, vs), pol, seed=3)
    c = launch_counts()["kv_quant"]
    assert c["kernel"] == 2 * len(C.ALPHA_GRID) * n_l and c["plain"] == 0
    plain = C.calibrate_model(lambda: (ks, vs), pol, seed=3,
                              quant_fn=quantize_groups)
    for a, b in zip(kern.layers, plain.layers):
        for f in ("perm_k", "perm_v", "smooth_k"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for f in ("alpha_k", "alpha_v"):
            np.testing.assert_array_equal(getattr(a, f).view(np.uint32),
                                          getattr(b, f).view(np.uint32))
    table = kern.stacked()
    assert table["perm_k"].device.type == "cuda"
    assert table["perm_k"].dtype == torch.int64
    assert table["alpha_v"].dtype == torch.float32


def test_calibrated_model_on_the_card(cuda_device):
    """collect_kv -> calibrate_model -> Engine(calib=...) on a smoke model
    at head dim 128: warmed striped and pooled engines give equal
    streams with the launch identities; fused-V weights with an identity
    perm_v give the unfused prefill logits (f32, atol = rtol = 1e-4)."""
    from repro_torch.core import calibrate as C
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, Request
    cfg = configs.get_smoke("llama2_7b").scaled(head_dim=128, d_model=256,
                                                n_heads=2, n_kv_heads=2)
    params = T.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(8)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 256)),
                           device=cuda_device)
    cal = C.calibrate_model(lambda: T.collect_kv(params, cfg, toks),
                            PAPER_POLICY).stacked()
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (300, 180, 420)]
    runs = []
    for pool in (None, 80):
        eng = Engine(params, cfg, PAPER_POLICY, batch_slots=2, max_len=517,
                     steps_per_sync=4, pool_blocks=pool,
                     pool_block_tokens=16, calib=cal, device=cuda_device)
        eng.warmup()
        reset_launch_counts()
        hs = [eng.submit(Request(prompt=p, max_new=12, seed=i))
              for i, p in enumerate(prompts)]
        eng.run(hs)
        c = launch_counts()
        steps = eng.n_decode_steps
        assert c["kv_quant"]["append"] == cfg.n_layers * steps
        assert c["decode_attn"]["pooled" if pool else "kernel"] \
            == cfg.n_layers * steps
        assert c["decode_attn"]["plain"] == c["kv_quant"]["plain"] \
            == c["kv_quant"]["append_plain"] == 0
        assert eng.warmup_report()["post_warmup_misses"] == 0
        runs.append([h.tokens for h in hs])
    assert runs[0] == runs[1]
    fused = dict(params, layers=dict(params["layers"], attn=(
        T.fuse_v_permutation(params["layers"]["attn"], cal["perm_v"],
                             cfg.n_heads))))
    eye = T.identity_calib(cfg, PAPER_POLICY, device=cuda_device)["perm_v"]
    a, _ = T.prefill_model(params, cfg, toks, PAPER_POLICY, calib=cal,
                           max_len=517)
    b, _ = T.prefill_model(fused, cfg, toks, PAPER_POLICY,
                           calib=dict(cal, perm_v=eye), max_len=517)
    torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------- degradation (§11)

def test_pool_block_read_write_round_trip_on_the_card(cuda_device):
    """Layer-stacked pooled leaves (L, NP+1, BT, H, W): blocks read to
    the host and written back elsewhere land byte for byte, in place."""
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=128, window=8,
                      n_sink=2)
    shapes = kvc.pooled_cache_shapes(3, 10 + 16 * 6, 4, 128, pol, 20, 16)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    cache = {k: (torch.randint(0, 256, (2,) + sh, generator=gen,
                               dtype=torch.int32, device=cuda_device)
                 .to(dt) if kvc.is_plane_key(k) else
                 torch.zeros((2,) + sh, dtype=dt, device=cuda_device))
             for k, (sh, dt) in shapes.items()}
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    src, dst = [3, 7, 11, 19], [1, 5, 9, 20]
    blocks = kvc.pool_read_blocks(cache, src, pool_axis=1)
    for b, phys in zip(blocks, src):
        assert sorted(b) == sorted(k for k in cache if kvc.is_plane_key(k))
        for k, a in b.items():
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, before[k][:, phys].cpu().numpy())
    one = kvc.pool_read_block(cache, 11, pool_axis=1)
    assert all(np.array_equal(one[k], blocks[2][k]) for k in one)
    kvc.pool_write_blocks(cache, blocks, dst, pool_axis=1)
    kvc.pool_write_block(cache, blocks[0], 2, pool_axis=1)
    torch.cuda.synchronize()
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    for k, v in cache.items():
        want = before[k].clone()
        if kvc.is_plane_key(k):
            for s_, d_ in zip(src + [3], dst + [2]):
                want[:, d_] = before[k][:, s_]
        assert torch.equal(_leaf_bytes(v), _leaf_bytes(want)), k


def _guard_setup(cuda_device):
    """A striped harness engine mid-stream (3 slots admitted, one chunk
    decoded) and a snapshot of its caches and step inputs."""
    cfg, eng = _harness_engine(cuda_device)
    hs = [eng.submit(r) for r in _harness_traffic(cfg)[:3]]
    eng.step()
    assert all(not h.finished for h in hs)
    snap = {k: v.clone() for k, v in eng._caches["scan"].items()}
    b = eng.batch_slots
    ins = (torch.as_tensor(eng._tok, device=cuda_device),
           torch.zeros(b, dtype=torch.bool, device=cuda_device),
           torch.zeros(b, dtype=torch.bool, device=cuda_device),
           torch.zeros(b, dtype=torch.int32, device=cuda_device),
           torch.zeros(b, dtype=torch.float32, device=cuda_device),
           torch.full((b,), -1, dtype=torch.int64, device=cuda_device),
           torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                       device=cuda_device))
    return cfg, eng, snap, ins


def _guarded_steps(cfg, eng, snap, ins, flags, cuda_device):
    """``steps_per_sync`` replays of the captured guarded step (the
    static guard set to ``flags``) and as many unguarded eager steps, each
    from the snapshot; returns their outputs and caches."""
    from repro_torch.serving import GraphCache, decode_one
    cg = {"scan": {k: v.clone() for k, v in snap.items()}}
    ce = {"scan": {k: v.clone() for k, v in snap.items()}}
    guard = torch.zeros(eng.batch_slots, dtype=torch.bool,
                        device=cuda_device)

    def step(caches, with_guard):
        def fn(token, done, bad, live, temps, eos, unif, *g):
            return decode_one(eng.params, cfg, HARNESS_POL, token, caches,
                              done, bad, live, temps, eos, unif,
                              backend="cuda",
                              nan_inject=g[0] if with_guard else None)
        return fn

    gc = GraphCache(cuda_device)
    gc.warm("step", step(cg, True), tuple(x.clone() for x in ins) + (guard,))
    for k, v in cg["scan"].items():            # undo the warmup iterations
        v.copy_(snap[k])
    guard.copy_(torch.as_tensor(flags))
    tg, dg, bg, lg = ins[0], ins[1], ins[2], ins[3]
    te, de, be, le = ins[0], ins[1], ins[2], ins[3]
    outs = []
    for _ in range(eng.steps_per_sync):
        got = gc.call("step", step(cg, True), tg, dg, bg, lg, *ins[4:],
                      guard)
        got = tuple(x.clone() for x in got)
        want = step(ce, False)(te, de, be, le, *ins[4:])
        outs.append((got, want))
        tg, dg, bg, lg = got[0][:, None], got[1], got[2], got[3]
        te, de, be, le = want[0][:, None], want[1], want[2], want[3]
    torch.cuda.synchronize()
    assert gc.replays == eng.steps_per_sync
    return outs, cg["scan"], ce["scan"]


def test_disarmed_nan_guard_replay_bitwise_equals_unguarded_eager(
        cuda_device):
    """The captured step carries the NaN guard (DESIGN.md §11): with every
    flag False its outputs and every cache leaf equal the unguarded eager
    step's bitwise, step after step."""
    cfg, eng, snap, ins = _guard_setup(cuda_device)
    outs, cg, ce = _guarded_steps(cfg, eng, snap, ins, [False] * 3,
                                  cuda_device)
    for got, want in outs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for k in snap:
        assert torch.equal(_leaf_bytes(cg[k]), _leaf_bytes(ce[k])), k


def test_armed_nan_guard_sheds_exactly_its_slot(cuda_device):
    """An armed guard on slot 1: that row raises ``bad`` and pins
    ``done`` from the first step; the other rows' outputs and cache rows
    equal the unguarded eager step's bitwise."""
    cfg, eng, snap, ins = _guard_setup(cuda_device)
    outs, cg, ce = _guarded_steps(cfg, eng, snap, ins, [False, True, False],
                                  cuda_device)
    keep = torch.tensor([0, 2], device=cuda_device)
    for got, want in outs:
        nxt, done, bad, live = got
        assert bool(bad[1]) and bool(done[1]) and int(live[1]) == 0
        for g, w in zip(got, want):
            assert torch.equal(g[keep], w[keep])
    for k, v in cg.items():                    # (L, B, ...) leaves
        assert torch.equal(_leaf_bytes(v[:, keep]),
                           _leaf_bytes(ce[k][:, keep])), k


def test_preempted_stream_resumes_bit_identically_on_the_card(cuda_device):
    """A priority-5 request preempts a running priority-0 one on a warmed
    pooled async engine with the host spill tier: the victim's blocks
    spill, restore at its resume, and both streams equal an uninterrupted
    run's; the audit is clean and no call missed the graph."""
    from repro_torch.serving import Request
    cfg = configs.get_smoke("llama2_7b")
    rng = np.random.default_rng(12)
    lo_p, hi_p = (rng.integers(0, cfg.vocab_size, 40) for _ in range(2))

    def serve(pool, late):
        _, eng = _harness_engine(cuda_device, pool, async_host=True,
                                 host_spill_bytes=1 << 22)
        eng.warmup()
        lo = eng.submit(Request(prompt=lo_p, max_new=12, seed=0))
        hi, n = None, 0
        while True:
            worked = eng.step()
            n += 1
            assert n < 200
            if hi is None and (not late or lo._sched_consumed >= 3):
                hi = eng.submit(Request(prompt=hi_p, max_new=12, seed=1,
                                        priority=5))
            if not worked and hi is not None:
                break
        eng.drain()
        eng.check_invariants()
        c = eng.stats()["counters"]
        assert eng.warmup_report()["post_warmup_misses"] == 0
        eng.close()
        return [lo.tokens, hi.tokens], [lo.finish_reason, hi.finish_reason], c

    got, reasons, c = serve(8, True)
    want, _, c0 = serve(40, False)
    assert c["preemptions"] >= 1 and c["restored_blocks"] >= 1
    assert c["spilled_blocks"] >= 1 and c0["preemptions"] == 0
    assert reasons == ["length", "length"]
    assert got == want


# ------------------------------------------------------------ rwkv6 (ssm)

def test_wkv_chunked_matches_naive_on_the_card(cuda_device):
    """The chunk-parallel WKV against the step recurrence on the card, at
    a padded length, with a random initial state (the reference test's
    tolerance)."""
    from repro_torch.models import rwkv6 as R
    g = torch.Generator(device=cuda_device).manual_seed(0)
    b, s, h, d = 2, 304, 4, 64
    rnd = lambda *shape: torch.randn(shape, generator=g, device=cuda_device)
    r, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    logw = torch.clamp(-torch.exp(rnd(b, s, h, d) - 1), -5.0, -1e-4)
    u, s0 = rnd(h, d), rnd(b, h, d, d)
    y1, f1 = R.wkv_chunked(r, k, v, logw, u, s0)
    y2, f2 = R.wkv_naive(r, k, v, logw, u, s0)
    torch.testing.assert_close(y1, y2, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(f1, f2, atol=2e-4, rtol=1e-3)


def test_rwkv_captured_step_bytewise_equals_eager(cuda_device):
    """rwkv6 smoke: a captured decode step replayed from a prefill state
    BYTE-equal to eager steps (state written in place), and a warmed
    Engine's streams equal to the unwarmed one's, with no kernel
    launched."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, GraphCache, Request
    cfg = configs.get_smoke("rwkv6_3b")
    params = T.init_params(cfg, seed=0, device=cuda_device)
    pol = QuantPolicy(bits_k=2.0, bits_v=1.5, group_size=16, window=8,
                      n_sink=2)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 21)), device=cuda_device)
    _, caches = T.prefill_model(params, cfg, toks, pol)
    cg = {"scan": {k: v.clone() for k, v in caches["scan"].items()}}
    ce = {"scan": {k: v.clone() for k, v in caches["scan"].items()}}
    step = lambda c: lambda token: T.decode_step(params, cfg, token, c,
                                                 pol)[0]
    gc = GraphCache(cuda_device)
    tok = toks[:, -1:].clone()
    gc.warm("step", step(cg), (tok.clone(),))
    for k, v in cg["scan"].items():               # undo the warmup runs
        v.copy_(caches["scan"][k])
    tg = te = tok
    for i in range(6):
        got, want = gc.call("step", step(cg), tg), step(ce)(te)
        torch.cuda.synchronize()
        assert torch.equal(_leaf_bytes(got), _leaf_bytes(want)), i
        for k in ce["scan"]:
            assert torch.equal(_leaf_bytes(cg["scan"][k]),
                               _leaf_bytes(ce["scan"][k])), (i, k)
        tg = got[:, -1].argmax(-1, keepdim=True)
        te = want[:, -1].argmax(-1, keepdim=True)
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new=m,
                    seed=i)
            for i, (n, m) in enumerate(zip((20, 20, 12, 7), (9, 6, 8, 7)))]
    streams = []
    for warm in (False, True):
        eng = Engine(params, cfg, pol, batch_slots=2, max_len=64,
                     steps_per_sync=4, device=cuda_device)
        if warm:
            assert eng.warmup()["n_graphs"] == 1
        reset_launch_counts()
        streams.append(_serve(eng, reqs))
        assert not any(n for d in launch_counts().values()
                       for n in d.values())
    assert eng._graphs.replays == eng.n_decode_steps
    assert eng.warmup_report()["post_warmup_misses"] == 0
    assert streams[0] == streams[1]


# ------------------------------------------------------------ training

def _train_setup(dev):
    import functools
    from repro_torch.data import DataLoader, SyntheticCorpus
    from repro_torch.training import make_train_step, warmup_cosine
    cfg = configs.get_smoke("llama3p2_1b")
    dl = DataLoader(SyntheticCorpus(cfg.vocab_size, seed=1), batch=8, seq=64,
                    device=dev)
    lr = functools.partial(warmup_cosine, peak_lr=5e-3, warmup=1, total=20)
    return cfg, dl, make_train_step(cfg, lr_fn=lr)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Three smoke train steps from the same f32 params on the card and on
    the CPU (TF32 off): metrics within ``rtol=1e-5``, params within
    ``atol=1e-5``."""
    from repro_torch.training import init_train_state
    from repro_torch.tree import leaves, tree_map
    states = {}
    for dev in ("cpu", cuda_device):
        cfg, dl, step = _train_setup(dev)
        st = tree_map(lambda x: x.to(dev),
                      init_train_state(cfg, seed=0, device="cpu"))
        metrics = []
        for i in range(3):
            st, m = step(st, dl.batch_at(i))
            metrics.append({k: float(v) for k, v in m.items()})
        states[str(dev)] = (st, metrics)
    (sc, mc), (sg, mg) = states["cpu"], states[str(cuda_device)]
    for a, b in zip(mc, mg):
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), k
    for a, b in zip(leaves(sc["params"]), leaves(sg["params"])):
        torch.testing.assert_close(b.cpu(), a, atol=1e-5, rtol=0)
    assert int(sg["step"]) == 3


def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """Two steps on the card, save, a third; restore into a fresh state on
    the card and take the third again: BITWISE the uninterrupted run
    (params, moments, steps and metrics)."""
    from repro_torch.checkpoint import load_latest, save_checkpoint
    from repro_torch.training import init_train_state
    from repro_torch.tree import leaves
    cfg, dl, step = _train_setup(cuda_device)
    st = init_train_state(cfg, seed=0, device=cuda_device)
    for i in range(2):
        st, _ = step(st, dl.batch_at(i))
    save_checkpoint(str(tmp_path), 2, st)
    a, ma = step(st, dl.batch_at(2))
    fresh = init_train_state(cfg, seed=5, device=cuda_device)
    got = load_latest(str(tmp_path), fresh, device=cuda_device)
    assert got["step"] == 2
    assert all(x.device.type == "cuda" for x in leaves(got["state"]))
    b, mb = step(got["state"], dl.batch_at(2))
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
