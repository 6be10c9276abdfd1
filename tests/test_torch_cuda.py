"""The port's CUDA kernels on the card, held to their plain PyTorch versions
on the same inputs.  Every test is marked ``requires_cuda`` and skips
without a card; the file imports neither jax nor the JAX package, so it
runs on a machine with only torch:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

* kv_quant: 0 differing bytes, edge-case rows included.
* decode_attn: f32 ``atol=3e-5, rtol=1e-4`` (sums in another order), and
  the pruned walk BITWISE equal to the full walk.
* one decode step of a smoke model: ``"cuda"`` backend vs ``"reference"``
  backend in f32, where both dequantize in f32 — ``atol=rtol=1e-4``.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import n_meta_groups, quantize_groups
from repro_torch.core import segments as seg
from repro_torch.kernels import decode_attn as DA
from repro_torch.kernels import kv_quant as KQ
from repro_torch.models import transformer as T
from test_torch_util import cuda_device  # noqa: F401  (fixture)

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


@pytest.mark.parametrize("gq,hkv,d", [(1, 32, 128), (4, 8, 64)])
@pytest.mark.parametrize("cap", [0.0, 30.0])
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


@pytest.mark.parametrize("arch", ["llama3p2_1b", "llama2_7b"])
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
