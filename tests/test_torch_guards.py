"""Structural guards of the port: it never imports jax or the JAX package,
it runs without jax installed, its entry points default to the GPU and
refuse to fall back to the CPU quietly, and its kernel build looks for
nvcc where it should."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.core.kv_cache import init_cache
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import transformer as T
from repro_torch.serving import Engine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = {"jax", "jaxlib", "repro"}


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
