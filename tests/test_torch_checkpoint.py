"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
reference's: the five scenarios of ``tests/test_checkpoint.py`` through the
port, and checkpoints crossing between the packages in both directions.

Both packages write the same layout (``step_XXXXXXXX/manifest.json``,
``leaf_NNNNN.npy`` in ``jax.tree.flatten`` order, crc32 a leaf, the atomic
``.tmp-<pid>`` rename, ``LATEST``), so every comparison here is EXACT:
leaves bit for bit, manifests field for field.  The one difference is
bf16: both write a bf16 leaf as 2-byte void records with manifest dtype
``"bfloat16"``; the port loads it back, the reference's load raises
(ROADMAP §3), and the test asserts both.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import load_latest as j_load_latest
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.training import init_train_state as j_init_state

from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, load_latest,
                                    save_checkpoint)
from repro_torch.convert import train_state_from_numpy, tree_to_numpy
from repro_torch.training import init_train_state
from repro_torch.tree import leaves
from test_torch_util import bits_of
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

CPU = "cpu"


def _state(seed=0):
    """The reference test's state, as the port's tensors."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.zeros((8,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _bits(tree):
    """A torch, JAX or numpy tree's leaves (keys sorted) as bit patterns."""
    if torch.is_tensor(leaves(tree)[0]):
        return [bits_of(tree_to_numpy(x)) for x in leaves(tree)]
    return [bits_of(np.asarray(x)) for x in jax.tree.leaves(tree)]


def _equal(got, want):
    """Leaf for leaf, bit for bit, shapes and widths included."""
    g, w = _bits(got), _bits(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


# ------------------------------------------------ the reference's scenarios

def test_roundtrip_exact(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 7, s)
    out = load_latest(str(tmp_path), s, device=CPU)
    assert out["step"] == 7
    _equal(out["state"], s)
    assert out["state"]["step"].dtype == torch.int32


def test_corrupt_falls_back(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 1, s)
    save_checkpoint(str(tmp_path), 2, _state(1))
    d2 = os.path.join(str(tmp_path), "step_00000002")
    leaf = max((os.path.join(d2, f) for f in os.listdir(d2)
                if f.endswith(".npy")), key=os.path.getsize)
    with open(leaf, "r+b") as f:
        f.seek(os.path.getsize(leaf) - 8)
        f.write(b"\xde\xad\xbe\xef")
    out = load_latest(str(tmp_path), s, device=CPU)
    assert out["step"] == 1  # fell back to the previous valid step
    _equal(out["state"], s)


def test_manager_gc_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=1)
    s = _state()
    for step in range(5):
        mgr.maybe_save(step, s)
    kept = sorted(d for d in os.listdir(str(tmp_path))
                  if d.startswith("step_"))
    assert len(kept) == 2 and kept[-1] == "step_00000004"
    out = mgr.restore_or_none(s, device=CPU)
    assert out["step"] == 4
    assert CheckpointManager(str(tmp_path), save_every=3).maybe_save(4, s) \
        is None
    assert load_latest(str(tmp_path / "absent"), s, device=CPU) is None


def test_atomic_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 3, _state())
    assert not [d for d in os.listdir(str(tmp_path)) if ".tmp" in d]
    assert (tmp_path / "LATEST").read_text() == "step_00000003"


def test_load_moves_to_the_device_and_dtype_of_like(tmp_path):
    """The reference's reshard-on-load, here: the leaves are read on the
    host, then take ``like``'s dtypes and the given device."""
    s = _state()
    save_checkpoint(str(tmp_path), 1, s)
    like = {"params": {"w": torch.zeros((8, 8), dtype=torch.float64),
                       "b": torch.zeros((8,), dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int64)}
    out = load_latest(str(tmp_path), like, device=torch.device(CPU))
    got = out["state"]
    assert got["params"]["w"].dtype == torch.float64
    assert got["params"]["b"].dtype == torch.bfloat16
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int64
    assert torch.equal(got["params"]["w"], s["params"]["w"].double())
    assert all(x.device.type == "cpu" for x in leaves(got))
    assert load_latest(str(tmp_path), {"params": s["params"]},
                       device=CPU) is None           # another leaf count


def test_preemption_hook_saves_on_sigterm(tmp_path):
    """SIGTERM -> a save of ``get_state()`` (the handler restored after)."""
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    old = signal.getsignal(signal.SIGTERM)
    try:
        mgr.register_preemption_hook(lambda: (11, s))
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, old)
    out = mgr.restore_or_none(s, device=CPU)
    assert out["step"] == 11
    _equal(out["state"], s)


# ------------------------------------------------ across the packages

@pytest.fixture(scope="module")
def jax_state():
    """A reference train state (llama3.2-1b smoke, AdamW moments, error
    feedback) after one jitted step, so no leaf is trivially zero."""
    from repro.data import DataLoader as JLoader
    from repro.data import SyntheticCorpus as JCorpus
    from repro.training import make_train_step as j_make_step
    jcfg = jconfigs.get_smoke("llama3p2_1b")
    st = j_init_state(jcfg, jax.random.PRNGKey(0), grad_compress=True)
    step = jax.jit(j_make_step(jcfg, lr_fn=lambda s: jnp.float32(1e-3),
                               grad_compress=True))
    st, _ = step(st, JLoader(JCorpus(jcfg.vocab_size, seed=1), 2, 16
                             ).batch_at(0))
    return st


def test_reference_checkpoint_loads_into_the_port_bitwise(tmp_path,
                                                          jax_state):
    """The reference's ``save_checkpoint`` of a train state, the port's
    ``load_latest`` into the port's own fresh state: every leaf bit for
    bit, and the port's trainer state continues from it."""
    cfg = configs.get_smoke("llama3p2_1b")
    j_save_checkpoint(str(tmp_path), 1, jax_state)
    fresh = init_train_state(cfg, seed=3, grad_compress=True, device=CPU)
    out = load_latest(str(tmp_path), fresh, device=CPU)
    assert out["step"] == 1
    _equal(out["state"], jax.tree.map(np.asarray, jax_state))
    conv = train_state_from_numpy(jax.tree.map(np.asarray, jax_state), cfg,
                                  device=CPU)
    _equal(out["state"], conv)


def test_port_checkpoint_loads_into_the_reference_bitwise(tmp_path,
                                                          jax_state):
    """The port's ``save_checkpoint`` of a converted train state, the
    reference's ``load_latest``: every leaf bit for bit, and the
    manifests equal field for field (the treedef string included)."""
    cfg = configs.get_smoke("llama3p2_1b")
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    conv = train_state_from_numpy(jax.tree.map(np.asarray, jax_state), cfg,
                                  device=CPU)
    save_checkpoint(str(tdir), 5, conv)
    j_save_checkpoint(str(jdir), 5, jax_state)
    out = j_load_latest(str(tdir), jax_state)
    assert out["step"] == 5
    _equal(conv, jax.tree.map(np.asarray, out["state"]))
    mj = json.loads((jdir / "step_00000005" / "manifest.json").read_text())
    mt = json.loads((tdir / "step_00000005" / "manifest.json").read_text())
    assert mt == mj
    for meta in mj["leaves"]:
        assert (tdir / "step_00000005" / meta["file"]).read_bytes() == \
            (jdir / "step_00000005" / meta["file"]).read_bytes()


def test_bf16_leaves_as_the_reference_writes_them(tmp_path):
    """A bf16 leaf: both packages write the same file and manifest entry;
    the port loads it bit for bit, the reference's load raises."""
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    js = {"w": jnp.asarray(x, jnp.bfloat16), "s": jnp.int32(2)}
    ts = {"w": torch.from_numpy(x).to(torch.bfloat16),
          "s": torch.tensor(2, dtype=torch.int32)}
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    j_save_checkpoint(str(jdir), 1, js)
    save_checkpoint(str(tdir), 1, ts)
    mj = json.loads((jdir / "step_00000001" / "manifest.json").read_text())
    mt = json.loads((tdir / "step_00000001" / "manifest.json").read_text())
    assert mt == mj and mt["leaves"][1]["dtype"] == "bfloat16"
    for meta in mj["leaves"]:
        assert (tdir / "step_00000001" / meta["file"]).read_bytes() == \
            (jdir / "step_00000001" / meta["file"]).read_bytes()
    for d in (jdir, tdir):
        out = load_latest(str(d), ts, device=CPU)
        assert out["state"]["w"].dtype == torch.bfloat16
        assert torch.equal(out["state"]["w"].view(torch.int16),
                           ts["w"].view(torch.int16))
    with pytest.raises(ValueError):
        j_load_latest(str(tdir), js)
