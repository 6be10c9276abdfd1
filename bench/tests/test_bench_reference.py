"""The plain reference against the port at smoke sizes on the CPU: the
SKVQ quantizer, dense and MoE decode through a filled cache, and the
restore of a round's state.  With f32 weights the two compute the same function, so
the logits agree to f32 rounding; the benchmark's own comparison (served
bf16 tokens against the f32 reference) is exercised by the runs in
``test_bench_faults``."""
import pytest
import torch

import smoke
from harness import inputs, manifest, program
from reference import dense, moe, skvq

program.prepare(manifest.ROOT)
from repro_torch.core.quant import dequantize_groups, quantize_groups  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

DEV = torch.device("cpu")


def _cfg(name, over):
    cfg = dict(manifest.load_json(manifest.BENCH / f"configs/{name}.json"))
    cfg.update(over, dtype="float32")
    return cfg


@pytest.mark.parametrize("bits,group", [(2.0, 128), (1.5, 128), (1.5, 16),
                                        (4.0, 64)])
def test_fake_quant_is_the_port_quantizer(bits, group):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((64, 4, 128), generator=g).to(torch.bfloat16)
    x[0, 0, :16] = 0.0                     # a flat group
    want = dequantize_groups(quantize_groups(x, bits, group), 128, bits,
                             group, dtype=torch.float32)
    assert torch.equal(skvq.fake_quant(x, bits, group), want)


@pytest.mark.parametrize("name,ref,over", [
    ("granite_8b", dense, smoke.DENSE),
    ("deepseek_moe_16b", moe, smoke.MOE)])
def test_decode_through_filled_cache(name, ref, over):
    """decode_one's steps from a filled cache == the teacher-forced
    reference, logits to f32 rounding, over more steps than the window."""
    cfg = _cfg(name, over)
    arch, pol = program.arch_config(cfg), program.policy(cfg)
    params = inputs.draw_weights(ref.param_specs(cfg), 11, DEV,
                                 dtype=torch.float32)
    program.check_params(params, arch)
    b, l0, steps = 2, 40, 12
    hkv, hd = cfg["num_key_value_heads"], cfg["head_dim"]
    src = lambda s, l: inputs.prefix_kv(11, s, l, l0, hkv, hd, DEV,
                                        torch.float32)
    caches = program.alloc_caches(arch, pol, b, l0 + steps, DEV,
                                  torch.float32)
    program.fill(caches, arch, pol, l0, src)
    tok = torch.tensor([[3], [9]])
    fed, logits = [tok], []
    for _ in range(steps):
        lg, _ = T.decode_step(params, arch, tok, caches, pol,
                              backend="cuda")
        logits.append(lg[:, 0].float())
        tok = lg[:, 0].float().argmax(-1)[:, None]
        fed.append(tok)
    got = torch.stack(logits, 1)
    served = torch.cat(fed[1:], 1)
    want = ref.forward(params, cfg, torch.cat(fed[:-1], 1), p0=l0,
                       qstart=l0, prefix=src)
    assert (want - got).abs().max() < 1e-4 * want.abs().max()
    assert ref.gaps(want, served).max() < 1e-4 * want.abs().max()


def test_round_state_restores_the_whole_cache():
    """A round writes only the regions ``program.round_state`` snapshots:
    restoring them after a whole round gives back every leaf of the
    filled cache, bit for bit."""
    cfg = _cfg("granite_8b", smoke.DENSE)
    arch, pol = program.arch_config(cfg), program.policy(cfg)
    params = inputs.draw_weights(dense.param_specs(cfg), 7, DEV,
                                 dtype=torch.float32)
    b, l0, steps = 3, 40, 16
    hkv, hd = cfg["num_key_value_heads"], cfg["head_dim"]
    src = lambda s, l: inputs.prefix_kv(7, s, l, l0, hkv, hd, DEV,
                                        torch.float32)
    caches = program.alloc_caches(arch, pol, b, l0 + steps, DEV,
                                  torch.float32)
    program.fill(caches, arch, pol, l0, src)
    full = {k: t.clone() for k, t in caches["scan"].items()}
    part = [t.clone() for t in program.round_state(caches, pol, l0)]
    assert sum(t.numel() for t in part) < \
        sum(t.numel() for t in full.values())
    tok = torch.tensor([[3], [9], [17]])
    for _ in range(steps):
        lg, _ = T.decode_step(params, arch, tok, caches, pol, backend="cuda")
        tok = lg[:, 0].float().argmax(-1)[:, None]
    assert any(not torch.equal(caches["scan"][k], full[k]) for k in full)
    for dst, s in zip(program.round_state(caches, pol, l0), part):
        dst.copy_(s)
    for k, t in caches["scan"].items():
        assert torch.equal(t, full[k]), k


def test_reference_imports_nothing_of_the_program():
    import sys
    before = {m for m in sys.modules if m.startswith("repro_torch")}
    assert before          # the port is loaded here, by the test
    for mod in (dense, moe, skvq):
        src = open(mod.__file__).read()
        assert "repro_torch" not in src and "import repro" not in src
