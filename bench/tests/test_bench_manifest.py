"""The manifest and its data files: every name resolves to its file, the
contract's shapes hold, no data file is ignored by git, and a new cell,
mix or metric is picked up from new files alone."""
import json
import re
import shutil
import subprocess

import pytest

from harness import manifest

M = manifest.load_manifest()
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
             "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(M) == ROOT_KEYS
    assert M["command"] == ["python3", "bench/run.py"]
    assert M["paths"] == ["bench"]
    assert 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_resolves_every_file(cell):
    c = manifest.Cell(M, cell)
    assert c.driver().run
    assert c.reference().forward
    assert set(c.layer_readers()) == {m["name"] for m in c.per_layer}
    from harness import compare
    assert set(c.limits) & set(compare.STATS)
    assert c.chips == 1


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_reports_what_the_contract_asks(cell):
    c = manifest.Cell(M, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_names_units_and_bounds():
    names = [x["name"] for x in M["configs"] + M["workloads"]] + \
        manifest.metric_names(M)
    assert len(names) == len(set(names))
    for n in names:
        assert manifest.NAME.match(n), n
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {m["layer"] for m in M["per_layer"]}
    assert layers <= {"traffic", "engine", "step", "products", "kernels",
                      "device"}


def test_configs_state_their_cuts():
    for c in M["configs"]:
        cfg = manifest.load_json(manifest.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert key in cfg["changed"]


def test_no_data_file_is_ignored_by_git():
    if shutil.which("git") is None or not (manifest.ROOT / ".git").exists():
        pytest.skip("not a git checkout")
    files = [str(p.relative_to(manifest.ROOT))
             for p in manifest.BENCH.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    files.append("BENCHMARK.json")
    out = subprocess.run(["git", "check-ignore", "--no-index", *files],
                         cwd=manifest.ROOT, capture_output=True, text=True)
    assert out.stdout.strip() == "", out.stdout
    assert not any(re.match(r"bench.*\.json$", p.rsplit("/", 1)[-1])
                   for p in files)


def test_new_cell_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, add a mix, a cell and a metric as new files and
    entries: the harness resolves them and leaves the old files as they
    were."""
    shutil.copytree(manifest.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(M))
    (tmp_path / "bench/traffic/short_decode.json").write_text(json.dumps(
        dict(manifest.load_json(manifest.BENCH / "traffic/long_decode.json"),
             context=1024)))
    (tmp_path / "bench/limits/granite8b.short_decode.json").write_text(
        json.dumps({"max_logit_gap": 1.0}))
    (tmp_path / "bench/layer_metrics/tokens_per_step.decode.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    man["workloads"].append({"name": "granite8b.short_decode",
                             "config": "granite_8b",
                             "traffic": "short_decode", "chips": 1,
                             "why": "a test cell"})
    man["per_layer"].append({"name": "tokens_per_step.decode", "unit": "1",
                             "better": "higher", "source": "device_trace",
                             "layer": "step", "moves": "decode_tok_s",
                             "workloads": ["granite8b.short_decode"]})
    for m in man["end_to_end"]:
        if "workloads" in m and "granite8b.long_decode" in m["workloads"]:
            m["workloads"].append("granite8b.short_decode")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    c = manifest.Cell(manifest.load_manifest(tmp_path / "BENCHMARK.json"),
                      "granite8b.short_decode", tmp_path)
    assert c.traffic["context"] == 1024
    assert c.driver().__name__ == "bench_driver_decode_rounds"
    readers = c.layer_readers()
    assert readers["tokens_per_step.decode"].read({}) == 1.0
    assert "step_mfu.decode" not in readers
    for old in ("traffic/long_decode.json", "configs/granite_8b.json"):
        assert (tmp_path / "bench" / old).read_bytes() == \
            (manifest.BENCH / old).read_bytes()
