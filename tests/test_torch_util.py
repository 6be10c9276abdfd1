"""Shared helpers for the port's parity tests (tests/test_torch_*.py) —
moving arrays between the JAX reference and the torch port as numpy — and
the tests of that carrier (``repro_torch.convert``)."""
import numpy as np
import pytest
import torch

from repro_torch.convert import tree_from_numpy, tree_to_numpy

CPU = "cpu"


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``requires_cuda``; skips without one (the
    decision is made here, at run time, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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
