"""The port's ``SyntheticCorpus`` and its serving CLI's prompts against the
reference package: equal seeds draw byte-equal token arrays, and both
serving CLIs build byte-equal request lists from the same arguments
(EXACT: integer tokens)."""
import numpy as np
import pytest

from repro.data import SyntheticCorpus as JCorpus
from repro.launch import serve as jserve

from repro_torch.data import SyntheticCorpus
from repro_torch.launch import serve as tserve
from test_torch_util import (  # noqa: F401
    jax_compile_cache, one_torch_thread)


@pytest.mark.parametrize("vocab,seed", [(256, 0), (32000, 0), (64, 3)])
def test_corpus_samples_equal_reference(vocab, seed):
    a, b = SyntheticCorpus(vocab, seed=seed), JCorpus(vocab, seed=seed)
    np.testing.assert_array_equal(a.next_tok, b.next_tok)
    np.testing.assert_array_equal(a.motifs, b.motifs)
    for i, n in enumerate((1, 17, 300)):
        got = a.sample(n, np.random.default_rng(i))
        want = b.sample(n, np.random.default_rng(i))
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
        assert got.min() >= 2 and got.max() < vocab


class _Stop(Exception):
    pass


def _cli_requests(module, monkeypatch, argv):
    """The requests a CLI builds before its Engine, captured by replacing
    its ``Request`` with a recorder and its ``Engine`` with a stop."""
    seen = []
    real = module.Request

    def record(**kw):
        seen.append(kw)
        return real(**kw)

    def stop(*args, **kw):
        raise _Stop

    monkeypatch.setattr(module, "Request", record)
    monkeypatch.setattr(module, "Engine", stop)
    with pytest.raises(_Stop):
        module.main(argv)
    return seen


@pytest.mark.parametrize("extra", [[], ["--prompt-jitter", "8",
                                        "--max-new-jitter", "4"]])
def test_both_clis_build_the_same_prompts(monkeypatch, extra):
    argv = ["--arch", "llama3p2_1b", "--smoke", "--batch", "2",
            "--requests", "5", "--prompt-len", "48", "--new-tokens", "16"]
    want = _cli_requests(jserve, monkeypatch, argv + extra)
    got = _cli_requests(tserve, monkeypatch,
                        argv + extra + ["--device", "cpu"])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert np.asarray(g["prompt"]).tolist() == \
            np.asarray(w["prompt"]).tolist()
        assert (g["max_new"], g["seed"]) == (w["max_new"], w["seed"])
