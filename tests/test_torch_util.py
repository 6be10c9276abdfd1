"""Shared helpers for the port's parity tests (tests/test_torch_*.py) —
moving arrays between the JAX reference and the torch port as numpy, the
run-wide JAX compilation cache and the one torch thread every such file
turns on — and the tests of that carrier (``repro_torch.convert``)."""
import functools
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.convert import tree_from_numpy, tree_to_numpy

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache, on while the module's tests run,
    in one directory the whole test run shares (every xdist worker's): the
    reference's jitted steps and Engines, built again case after case and
    file after file from the same programs, compile once a run.  A
    compiled program is the one a fresh compile gives, so no number
    changes.  The previous settings come back after the module (the JAX
    package's own tests run as they did); a no-op where JAX is not
    imported (the card's runs).  Each port test file imports it."""
    jax = sys.modules.get("jax")
    if jax is None:
        yield
        return
    from jax.experimental.compilation_cache import compilation_cache as cc
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    want = {"jax_compilation_cache_dir": str(root / "jax_compile_cache"),
            "jax_persistent_cache_min_compile_time_secs": 0.0}
    prev = {k: getattr(jax.config, k) for k in want}
    for k, v in want.items():
        jax.config.update(k, v)
    cc.reset_cache()
    try:
        yield
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)
        cc.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while the module's tests run: the suite runs its
    files in parallel processes, where the default threads of each only
    contend (six workers made tests/test_torch_quality*.py 8x slower with
    them).  Each port test file imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``requires_cuda``; skips without one (the
    decision is made here, at run time, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def jax_cache_ops():
    """The reference's ``kv_cache.prefill`` and ``decode_append`` and its
    ``pallas_decode_attention``, jitted once a process and shared by every
    file and case (run eagerly, each call dispatched its ops, and the
    Pallas kernel's interpreter, one by one): ``.prefill(k, v, max_len,
    policy, ...)``, ``.append(cache, k, v, policy, ...)``,
    ``.attention(q, cache, policy, ...)``; the length, the policy, the
    quantizer and the wrapper's levers are static."""
    import jax
    from repro.core import kv_cache as jkvc
    from repro.kernels.ops import pallas_decode_attention
    return SimpleNamespace(
        prefill=jax.jit(jkvc.prefill, static_argnums=(2, 3),
                        static_argnames=("quant_fn",)),
        append=jax.jit(jkvc.decode_append, static_argnums=(3,),
                       static_argnames=("quant_fn",)),
        attention=jax.jit(pallas_decode_attention, static_argnums=(2,),
                          static_argnames=("scale", "softcap", "window",
                                           "dtype", "interpret", "block_s",
                                           "prune_blocks")))


def stall_until_backpressure(eng, timeout: float = 10.0) -> None:
    """An async Engine's consumer hook that holds its first item until the
    scheduler has had to wait for it (a full queue or an unreleased ring
    buffer): backpressure then happens whatever the host's speed."""
    deadline = time.monotonic() + timeout
    while (eng._host.backpressure_waits == 0
           and time.monotonic() < deadline):
        time.sleep(0.002)


def j2t(tree, dtype=None):
    """JAX pytree (dict of arrays) -> same structure of CPU tensors."""
    import jax
    return tree_from_numpy(jax.tree.map(np.asarray, tree), CPU, dtype)


def bits_of(a) -> np.ndarray:
    """Array -> its raw bit pattern, so float leaves compare bit-exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype.kind == "f":
        return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])
    return a


def assert_tree_exact(got, want, what=""):
    """Leaf-for-leaf bit-exact equality of a torch tree and a JAX tree."""
    if torch.is_tensor(got):
        got = tree_to_numpy(got)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            assert_tree_exact(got[k], want[k], f"{what}/{k}")
        return
    g, w = bits_of(got), bits_of(np.asarray(want))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bad = np.flatnonzero(g.reshape(-1) != w.reshape(-1))
    assert bad.size == 0, (f"{what}: {bad.size}/{g.size} differ, first at "
                           f"{bad[:5]}: got {g.reshape(-1)[bad[:5]]} want "
                           f"{w.reshape(-1)[bad[:5]]}")


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float32).numpy() \
        if t.is_floating_point() else t.detach().cpu().numpy()


def test_bf16_round_trips_through_uint16_view():
    import jax.numpy as jnp
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)),
                    jnp.bfloat16)
    t = j2t({"w": x})["w"]
    assert t.dtype == torch.bfloat16
    assert_tree_exact({"w": t}, {"w": x})


def test_params_from_numpy_keeps_keys_and_layouts():
    import jax
    from repro.configs import get_smoke
    from repro.models import transformer as JT
    from repro_torch.convert import params_from_numpy
    cfg = get_smoke("llama2_7b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    assert tp["layers"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                                 cfg.q_dim)
    assert_tree_exact(tp, jp)
