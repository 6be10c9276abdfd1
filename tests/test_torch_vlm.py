"""qwen2-vl's M-RoPE decoder (``qwen2_vl_7b``) in the port against the JAX
reference, on the same seeded numpy inputs, at the SMOKE shape, in f32:
the M-RoPE tables, prefill and decode from tokens and from patch
embeddings, the conversion, the Engine, the refusals of the pool and of
chunked prefill, and the CLI.  The helpers, backend pairs and tolerances
are ``tests/test_torch_families.py``'s, and so are the cases that run
for every family (the ``_check_*`` helpers, here at ``qwen2_vl_7b``);
besides:

* ``mrope_tables``: each band BITWISE the port's plain ``rope_table`` of
  its stream; against JAX ``atol = 1e-5`` — cos/sin of f32 angles up to
  300 rad, where torch's and XLA's range reductions differ by a few ulp
  of the angle (~2e-6 measured).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import layers as JL
from repro.models import transformer as JT
from repro import serving as jsv

from repro_torch import configs
from repro_torch import serving as tsv
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from test_torch_families import (KW, MAX_LEN, PAIRS, _check_cli,
                                 _check_configs, _check_convert,
                                 _check_engine, _check_init_leaves,
                                 _check_prefill_decode, _close,
                                 _compare_caches, _jprefill, _jstep,
                                 _setup)
from test_torch_util import t2n
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ARCH = "qwen2_vl_7b"


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", [ARCH])
def test_configs_equal_reference_field_by_field(arch):
    _check_configs(arch)


@pytest.mark.parametrize("arch", [ARCH])
def test_init_params_leaves_equal_reference(arch):
    _check_init_leaves(arch)


# ------------------------------------------------------------ model parity

@pytest.mark.parametrize("arch", [ARCH])
@pytest.mark.parametrize("tb,jb", PAIRS)
def test_prefill_and_decode_match_reference(arch, tb, jb, rng):
    _check_prefill_decode(arch, tb, jb, rng)


# ------------------------------------------------------------ M-RoPE

def test_mrope_tables_match_reference(rng):
    pos = rng.integers(0, 300, (3, 2, 11)).astype(np.int32)   # distinct
    for sections, hd in (((2, 3, 3), 16), ((16, 24, 24), 128)):
        want = JL.mrope_tables(jnp.asarray(pos), hd, 1e6, sections)
        got = TL.mrope_tables(torch.from_numpy(pos), hd, 1e6, sections)
        for g, w in zip(got, want):
            np.testing.assert_allclose(t2n(g), np.asarray(w), atol=1e-5,
                                       rtol=0)
        edges = np.cumsum((0,) + sections)
        for s in range(3):               # band s takes stream s's angles
            plain = TL.rope_table(torch.from_numpy(pos[s]), hd, 1e6)
            cols = slice(edges[s], edges[s + 1])
            for g, w in zip(got, plain):
                assert torch.equal(g[..., cols], w[..., cols]), (s, cols)
    # text-only streams: M-RoPE equals plain RoPE at the same positions
    flat = np.broadcast_to(pos[:1], pos.shape)
    got = TL.mrope_tables(torch.from_numpy(flat.copy()), 16, 1e4, (2, 3, 3))
    plain = TL.rope_table(torch.from_numpy(pos[0]), 16, 1e4)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tb,jb", PAIRS)
def test_embeds_prefill_and_decode_match_reference(tb, jb, rng):
    """qwen2-vl smoke from patch embeddings with distinct (t, h, w)
    positions (a 4 x 6 grid after 6 text tokens), then 5 decode steps
    from embeddings at explicit 3-D positions."""
    jcfg, tcfg, jp, tp, jcal, tcal = _setup("qwen2_vl_7b", rng)
    emb = rng.normal(0, 0.5, (2, 30, jcfg.d_model)).astype(np.float32)
    t = np.concatenate([np.arange(6), np.full(24, 6)])
    hh = np.concatenate([np.arange(6), 6 + np.repeat(np.arange(4), 6)])
    ww = np.concatenate([np.arange(6), 6 + np.tile(np.arange(6), 4)])
    pos = np.broadcast_to(np.stack([t, hh, ww])[:, None], (3, 2, 30)
                          ).astype(np.int32).copy()
    kw = tuple(sorted(KW.items()))
    lj, cj = _jprefill(jcfg, kw, jb)(jp, {"embeds": jnp.asarray(emb),
                                          "positions": jnp.asarray(pos)},
                                     jcal)
    lt, ct = T.prefill_model(tp, tcfg, None, QuantPolicy(**KW), calib=tcal,
                             max_len=MAX_LEN, backend=tb,
                             embeds=torch.from_numpy(emb),
                             positions=torch.from_numpy(pos))
    _close(lt, lj, "prefill")
    _compare_caches(ct, cj)
    for step in range(5):
        e = rng.normal(0, 0.5, (2, 1, jcfg.d_model)).astype(np.float32)
        p3 = np.full((3, 2, 1), 12 + step, np.int32)
        p3[1] += 1
        lj, cj = _jstep(jcfg, kw, jb)(jp, token=jnp.asarray(e), caches=cj,
                                      calib=jcal, positions=jnp.asarray(p3))
        lt, ct = T.decode_step(tp, tcfg, None, ct, QuantPolicy(**KW),
                               calib=tcal, backend=tb,
                               embeds=torch.from_numpy(e),
                               positions=torch.from_numpy(p3))
        _close(lt, lj, f"step {step}")
    _compare_caches(ct, cj)


def test_text_only_mrope_equals_arange_positions(rng):
    """Tokens with no positions: the 3 streams are ``arange``, so passing
    them explicitly gives bitwise the same prefill."""
    cfg = configs.get_smoke("qwen2_vl_7b")
    tp = T.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 21)))
    a, _ = T.prefill_model(tp, cfg, toks, QuantPolicy(**KW), max_len=40)
    pos = torch.arange(21, dtype=torch.int32).expand(3, 2, 21)
    b, _ = T.prefill_model(tp, cfg, toks, QuantPolicy(**KW), max_len=40,
                           positions=pos)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="M-RoPE"):
        T.prefill_model(tp, configs.get_smoke("gemma3_4b"), toks,
                        QuantPolicy(**KW), positions=pos)
    with pytest.raises(ValueError, match="embeds"):
        T.prefill_model(T.init_params(configs.get_smoke("gemma3_4b"),
                                      device="cpu"),
                        configs.get_smoke("gemma3_4b"), None,
                        QuantPolicy(**KW),
                        embeds=torch.zeros((1, 4, 64)))


# ------------------------------------------------------------ conversion

@pytest.mark.parametrize("arch", [ARCH])
def test_convert_carries_norms_biases_and_head(arch, rng):
    _check_convert(arch, rng)


# ------------------------------------------------------------ engines

@pytest.mark.parametrize("arch,mode", [(ARCH, "striped")])
def test_engine_streams_equal_reference(arch, mode, rng):
    _check_engine(arch, mode, rng)


@pytest.mark.parametrize("what", ["pool", "chunk"])
def test_vlm_refusals_equal_reference(what):
    """Pool and chunk refuse the vlm family at build time, with the
    reference's messages."""
    jcfg, tcfg = (jconfigs.get_smoke("qwen2_vl_7b"),
                  configs.get_smoke("qwen2_vl_7b"))
    kw = (dict(pool_blocks=40, pool_block_tokens=8) if what == "pool"
          else dict(prefill_chunk=8))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jsv.Engine(jp, jcfg, JPolicy(**KW), batch_slots=2, max_len=52, **kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    with pytest.raises(want.type) as got:
        tsv.Engine(tp, tcfg, QuantPolicy(**KW), batch_slots=2, max_len=52,
                   device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ CLI

@pytest.mark.parametrize("arch", [ARCH])
def test_cli_serves_the_new_archs_on_the_cpu(arch, capsys):
    _check_cli(arch, capsys)
