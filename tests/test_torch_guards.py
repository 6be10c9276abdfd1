"""Structural guards of the port: it never imports jax, the JAX package or
its benchmark harness, it runs without jax installed, its entry points
default to the GPU and refuse to fall back to the CPU quietly, and its
kernel build looks for nvcc where it should."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.core.kv_cache import init_cache, init_pooled_cache
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.serving import Engine
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = {"jax", "jaxlib", "repro", "benchmarks"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = sorted(set(_imports(path)) & BANNED)
    assert not bad, f"{path} imports {bad}"


def test_port_runs_with_jax_blocked(tmp_path):
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.policy import QuantPolicy\n"
        "from repro_torch.models import transformer as T\n"
        "cfg = configs.get_smoke('llama3p2_1b')\n"
        "pol = QuantPolicy(group_size=16, window=8, n_sink=2, bits_v=1.5)\n"
        "p = T.init_params(cfg, seed=0, device='cpu')\n"
        "tok = torch.randint(0, cfg.vocab_size, (2, 20))\n"
        "_, c = T.prefill_model(p, cfg, tok, pol, max_len=32)\n"
        "lg, c = T.decode_step(p, cfg, tok[:, -1:], c, pol, backend='cuda')\n"
        "assert lg.shape == (2, 1, cfg.vocab_size)\n"
        "assert bool(torch.isfinite(lg).all())\n"
        "assert 'jax' not in [m for m, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs.get_smoke("llama2_7b")
    p = T.init_params(cfg, seed=0, device="cpu")
    for call in (lambda: resolve_device(),
                 lambda: init_cache(1, 64, cfg.n_kv_heads, cfg.head_dim,
                                    PAPER_POLICY),
                 lambda: T.init_params(cfg, seed=0),
                 lambda: T.identity_calib(cfg, PAPER_POLICY),
                 lambda: Engine(p, cfg, PAPER_POLICY, batch_slots=1,
                                max_len=64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2_7b", "--smoke"])


def test_training_and_rwkv_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path):
    """The trainer's entry points (state, loader, checkpoint load, CLI)
    and the RWKV6 family's (its zero state, the Engine, the serving CLI)
    run on the GPU by default and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.checkpoint import load_latest, save_checkpoint
    from repro_torch.data import DataLoader, SyntheticCorpus
    from repro_torch.launch import serve, train
    from repro_torch.models import rwkv6
    from repro_torch.training import init_train_state
    cfg = configs.get_smoke("llama3p2_1b")
    state = init_train_state(cfg, seed=0, device="cpu")
    save_checkpoint(str(tmp_path), 1, state)
    rwkv = configs.get_smoke("rwkv6_3b")
    p = T.init_params(rwkv, seed=0, device="cpu")
    for call in (lambda: init_train_state(cfg, seed=0),
                 lambda: DataLoader(SyntheticCorpus(cfg.vocab_size), 2,
                                    8).batch_at(0),
                 lambda: load_latest(str(tmp_path), state),
                 lambda: train.main(["--smoke", "--steps", "1"]),
                 lambda: rwkv6.init_rwkv_state(1, rwkv),
                 lambda: Engine(p, rwkv, PAPER_POLICY, batch_slots=1,
                                max_len=64),
                 lambda: serve.main(["--arch", "rwkv6_3b", "--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert load_latest(str(tmp_path), state, device="cpu")["step"] == 1


def test_meshes_default_to_cuda_and_raise_without_it():
    """``make_mesh``, ``make_production_mesh``, ``make_local_mesh`` and
    ``init_world`` called with no device ask for CUDA and raise without a
    card, before any process group is touched, as ``resolve_device``
    does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    import torch.distributed as dist
    from repro_torch.launch import mesh
    for call in (lambda: mesh.make_mesh((1, 1), ("data", "model")),
                 lambda: mesh.make_production_mesh(multi_pod=True),
                 mesh.make_local_mesh, mesh.init_world):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()


def test_pooled_entry_points_raise_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs.get_smoke("llama2_7b")
    p = T.init_params(cfg, seed=0, device="cpu")
    pooled = dict(pool_blocks=8, pool_block_tokens=16)
    max_len = PAPER_POLICY.n_sink + PAPER_POLICY.window + 64
    for call in (lambda **kw: init_pooled_cache(
                     1, max_len, cfg.n_kv_heads, cfg.head_dim, PAPER_POLICY,
                     8, 16, **kw),
                 lambda **kw: Engine(p, cfg, PAPER_POLICY, batch_slots=1,
                                     max_len=max_len, **pooled, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2_7b", "--smoke", "--pool-blocks", "8"])


def test_cpu_tensors_take_plain_versions_cuda_default_backend():
    from repro_torch.models import backends as bk
    assert bk.default_backend_name("cuda") == "cuda"
    assert bk.default_backend_name("cpu") == "reference"
    assert bk.get_backend("cuda").quant_fn(PAPER_POLICY) is not None


def test_build_finds_nvcc_in_order(tmp_path, monkeypatch):
    fake = tmp_path / "cuda" / "bin"
    fake.mkdir(parents=True)
    nvcc = fake / "nvcc"
    nvcc.write_text("#!/bin/sh\nexit 0\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert _build.find_nvcc() == str(nvcc)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


def test_build_dir_is_keyed_by_sources_and_ignored(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    d = _build.build_dir()
    assert d.parent == ROOT / "build" / "repro_torch_kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir().parent == tmp_path


def test_concurrent_builds_run_nvcc_once_per_source(tmp_path, monkeypatch):
    """A build started while another thread builds waits for it and reuses
    its libraries: one nvcc run per source in all."""
    import threading
    log = tmp_path / "calls"
    fake = tmp_path / "cuda" / "bin"
    fake.mkdir(parents=True)
    nvcc = fake / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {log}\n"
        "sleep 0.3\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then shift; echo lib > \"$1\"; fi\n"
        "  shift\n"
        "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    outs = []
    threads = [threading.Thread(target=lambda: outs.append(_build.build_all()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(outs) == 3 and len(set(outs)) == 1
    assert log.read_text().split() == ["run"] * len(_build.SOURCES)
    assert all((outs[0] / f"lib{n}.so").is_file() for n in _build.SOURCES)


def test_calibration_runs_with_jax_blocked_and_defaults_to_cuda():
    """Calibration, the baselines and the filters import and run with jax
    blocked; the stacked table goes to the card unless asked for the CPU,
    and CUDA samples resolve the clip search to the kernel route."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.core import baselines, calibrate, filters\n"
        "from repro_torch.core.policy import QuantPolicy\n"
        "from repro_torch.models import transformer as T\n"
        "cfg = configs.get_smoke('llama3p2_1b')\n"
        "pol = QuantPolicy(group_size=16, window=8, n_sink=2, bits_v=1.5)\n"
        "p = T.init_params(cfg, seed=0, device='cpu')\n"
        "tok = torch.randint(0, cfg.vocab_size, (2, 24))\n"
        "cal = calibrate.calibrate_model(lambda: T.collect_kv(p, cfg, tok),"
        " pol)\n"
        "t = cal.stacked(device='cpu')\n"
        "_, c = T.prefill_model(p, cfg, tok, pol, calib=t, max_len=32)\n"
        "k = torch.randn(1, 32, cfg.n_kv_heads, cfg.head_dim)\n"
        "ctx = baselines.MethodCtx(pol, cal.layers[0])\n"
        "for name, fn in baselines.METHODS.items():\n"
        "    kq, vq = fn(k, k, ctx)\n"
        "    assert kq.shape == k.shape, name\n"
        "keep = filters.combine([filters.AttentionSinkFilter(2)],"
        " torch.arange(8), {})\n"
        "assert int(keep.sum()) == 2\n"
        "assert 'jax' not in [m for m, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    from repro_torch.core import calibrate
    from repro_torch.core.quant import quantize_groups
    assert calibrate.resolve_quant_fn(None, "cuda") is not quantize_groups
    if torch.cuda.is_available():
        return
    cal = calibrate.Calibration([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cal.stacked()
