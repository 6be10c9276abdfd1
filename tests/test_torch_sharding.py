"""The port's sharding plans (``distributed/sharding.py`` and
``launch/shardings.py``) against the JAX reference's, in one process.

Both packages build their plans for a mesh given by its axis names and
sizes alone (``jax.sharding.AbstractMesh`` against the port's
``AbstractMesh``), so the production meshes are held here with no
devices: (16, 16) ``("data", "model")``, (2, 16, 16) ``("pod", "data",
"model")`` and (2, 2, 2).  Every plan must be EQUAL leaf by leaf, by path
name: the port's spec ``P(*entries)`` compared as a JAX ``PartitionSpec``
with the reference's.  The port's train state is built from
``transformer.param_shapes`` at full width (meta tensors), the
reference's by ``jax.eval_shape`` of its ``init_train_state``.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.distributed import sharding as jsh
from repro.launch import shardings as jls
from repro.models import transformer as JT
from repro.training import init_train_state as j_init_state

from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import shardings as tls
from repro_torch.models import transformer as T
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "2x2x2"]
CACHE_ARCHS = ["llama3p2_1b", "gemma3_4b", "hymba_1p5b", "rwkv6_3b",
               "seamless_m4t_large_v2"]
POLICY = dict(bits_k=2.0, bits_v=1.5, group_size=16, window=8, n_sink=2)


def _meshes(shape, axes):
    return JMesh(shape, axes), tsh.AbstractMesh(shape, axes)


def _flat(tree, path=()):
    """``{"a/b/c": leaf}`` of a nested dict (a P is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, jax.sharding.Sharding)))[0]
    out = {}
    for path, leaf in flat:
        spec = leaf.spec if isinstance(leaf, jax.sharding.Sharding) else leaf
        out["/".join(str(getattr(p, "key", p)) for p in path)] = spec
    return out


def _assert_same_specs(got, want, what):
    got, want = _flat(got), _jflat(want)
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    bad = {k: (got[k], want[k]) for k in want if JP(*got[k]) != want[k]}
    assert not bad, (what, bad)


def _meta_tree(shapes):
    out = {}
    for path, shape in shapes.items():
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = torch.empty(shape, device="meta")
    return out


def _port_state(cfg):
    """The port's train state layout at full width, as meta tensors."""
    params = _meta_tree(T.param_shapes(cfg))
    step = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": params, "opt": {"m": params, "v": params, "step": step},
            "step": step}


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return jax.eval_shape(lambda: j_init_state(jconfigs.get(arch),
                                               jax.random.PRNGKey(0)))


def test_rule_tables_equal_the_reference():
    for name in ("TRAIN_RULES", "SERVE_RULES", "LONG_SERVE_RULES",
                 "REPL_SERVE_RULES", "SEQ_PARALLEL_TRAIN_RULES"):
        assert getattr(tsh, name) == getattr(jsh, name), name
    assert [s for s, _ in tsh._PARAM_RULES] == [s for s, _ in
                                               jsh._PARAM_RULES]
    for (_, a), (_, b) in zip(tsh._PARAM_RULES, jsh._PARAM_RULES):
        assert JP(*a) == b


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_state_plans_equal_the_reference(arch):
    """param_partition_specs, drop_indivisible, fsdp_extend and
    state_shardings (fsdp on and off) over the full-width train state,
    on the three meshes."""
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    ours, theirs = _port_state(configs.get(arch)), _ref_state(arch)
    for shape, axes in MESHES:
        jm, tm = _meshes(shape, axes)
        what = f"{arch} {shape}"
        ps, pj = (tsh.param_partition_specs(ours, tm),
                  jsh.param_partition_specs(theirs, jm))
        _assert_same_specs(ps, pj, what + " param_partition_specs")
        ds, dj = (tls.drop_indivisible(ps, ours, tm),
                  jls.drop_indivisible(pj, theirs, jm))
        _assert_same_specs(ds, dj, what + " drop_indivisible")
        _assert_same_specs(tls.fsdp_extend(ds, ours, tm),
                           jls.fsdp_extend(dj, theirs, jm),
                           what + " fsdp_extend")
        for fsdp in (True, False):
            _assert_same_specs(
                tls.state_shardings(ours, tm, fsdp=fsdp),
                jls.state_shardings(theirs, jm, fsdp=fsdp),
                f"{what} state_shardings fsdp={fsdp}")
            _assert_same_specs(
                tls.params_shardings(ours["params"], tm, fsdp=fsdp),
                jls.params_shardings(theirs["params"], jm, fsdp=fsdp),
                f"{what} params_shardings fsdp={fsdp}")


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_and_token_plans_equal_the_reference(mesh):
    jm, tm = _meshes(*mesh)
    for b in (1, 8, 64):
        shapes = {"tokens": (b, 32), "labels": (b, 32), "embeds": (b, 32, 16),
                  "positions": (3, b, 32), "scalar": ()}
        ours = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        theirs = {k: jax.ShapeDtypeStruct(s, jnp.float32)
                  for k, s in shapes.items()}
        _assert_same_specs(tls.batch_shardings(ours, tm),
                           jls.batch_shardings(theirs, jm), f"batch {b}")
        for tok in ((b, 1), (b,)):
            got = tls.token_sharding(torch.empty(tok, device="meta"), tm)
            want = jls.token_sharding(jax.ShapeDtypeStruct(tok, jnp.int32),
                                      jm)
            assert JP(*got) == want.spec, (tok, got, want.spec)


def _prefill_caches(arch):
    """(the port's, the reference's) caches of a 2 x 20-token smoke
    prefill (the same params, converted)."""
    jcfg = jconfigs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 20))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    kw = {}
    if jcfg.family == "encdec":
        frames = np.random.default_rng(1).normal(
            size=(2, jcfg.enc_seq_len, jcfg.d_model)).astype(np.float32)
        jb["enc_embeds"] = jnp.asarray(frames)
        kw["enc_embeds"] = torch.from_numpy(frames)
    _, cj = JT.prefill_model(jax.tree.map(jnp.asarray, tree), jcfg, jb,
                             JPolicy(**POLICY), max_len=64)
    cfg = configs.get_smoke(arch)
    _, ct = T.prefill_model(params_from_numpy(tree, cfg, device="cpu"), cfg,
                            torch.from_numpy(toks), QuantPolicy(**POLICY),
                            max_len=64, **kw)
    return ct, cj


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_plans_equal_the_reference(arch):
    """cache_shardings with long_ctx off and on over each package's own
    smoke prefill caches, on the three meshes.  Both trees hold one
    ``"scan"`` group here (no config of these has ``first_dense``) with
    the same leaf names and shapes, so the plans compare leaf by leaf."""
    ct, cj = _prefill_caches(arch)
    assert sorted(ct) == sorted(cj) == ["scan"], (sorted(ct), sorted(cj))
    assert {k: tuple(v.shape) for k, v in ct["scan"].items()} == \
        {k: tuple(v.shape) for k, v in cj["scan"].items()}
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    for shape, axes in MESHES:
        jm, tm = _meshes(shape, axes)
        for long_ctx in (False, True):
            _assert_same_specs(
                tls.cache_shardings(ct, cfg, tm, long_ctx=long_ctx),
                jls.cache_shardings(cj, jcfg, jm, long_ctx=long_ctx),
                f"{arch} {shape} long_ctx={long_ctx}")


def test_logical_is_the_identity_outside_a_context():
    x = torch.randn(2, 3, 4)
    assert tsh.current_rules() is None
    assert tsh.logical(x, "batch", "seq", None) is x
    assert tsh.logical(x, "batch") is x      # no rank check outside either
    with tsh.use_sharding(tsh.AbstractMesh((2, 2), ("data", "model")),
                          tsh.TRAIN_RULES):
        assert tsh.current_rules() == tsh.TRAIN_RULES
        with pytest.raises(ValueError, match="rank 3"):
            tsh.logical(x, "batch")
        assert tsh.logical(x, "batch", "seq", None) is x   # a plain tensor
    assert tsh.current_rules() is None


@pytest.mark.parametrize("mesh", MESHES + [((4,), ("model",))],
                         ids=MESH_IDS + ["model4"])
def test_spec_for_drops_axes_the_mesh_lacks(mesh):
    jm, tm = _meshes(*mesh)
    names = [("batch", "seq", "ff"), ("batch", "kv_seq", "kv_heads", None),
             ("experts", "cap", None), ("vocab",), (None, "d", "state")]
    for rules in ("TRAIN_RULES", "LONG_SERVE_RULES",
                  "SEQ_PARALLEL_TRAIN_RULES"):
        for ns in names:
            with tsh.use_sharding(tm, getattr(tsh, rules)):
                got = tsh.spec_for(*ns)
            with jsh.use_sharding(jm, getattr(jsh, rules)):
                want = jsh.spec_for(*ns)
            assert JP(*got) == want, (rules, ns, got, want)
            assert all(a is None or set((a,) if isinstance(a, str) else a)
                       <= set(mesh[1]) for a in got)
