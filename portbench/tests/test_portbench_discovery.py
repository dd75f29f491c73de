"""A configuration, a traffic mix and a metric added as files are found
by name, with no edit to any file the benchmark already has."""

import json
import shutil

from portbench import harness


def copy_tree(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    return tmp_path


def test_added_files_are_found(tmp_path):
    root = copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "zkevm16.json").read_text())
    cfg["name"] = "zkevm16_copy"
    (pb / "configs" / "zkevm16_copy.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "verify.b128.json").read_text())
    mix["batch"] = 512
    (pb / "traffic" / "verify.b512.json").write_text(json.dumps(mix))
    (pb / "metrics" / "verify.calls.py").write_text(
        'def read(r):\n'
        '    return len(r["spans"]) if r.get("entry") == "verify" else None\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "zkevm16_copy", "source": "https://x.org",
                            "file": "portbench/configs/zkevm16_copy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "zkevm16_copy.verify.b512",
                              "config": "zkevm16_copy", "traffic": "verify.b512",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "verify.calls", "unit": "calls",
                              "better": "higher", "source": "program_counter",
                              "layer": "verifier host: protocol/batched.py",
                              "moves": "proofs_verified_per_s",
                              "workloads": ["zkevm16_copy.verify.b512"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.find_cell("zkevm16_copy.verify.b512", root)
    assert cell.config["name"] == "zkevm16_copy" and cell.mix["batch"] == 512
    assert harness.entry_module(cell, root).run is not None
    vals = harness.per_layer_values(cell, {"entry": "verify", "spans": [{}] * 7},
                                    root)
    assert vals["verify.calls"] == {"value": 7, "unit": "calls"}
    # the metric is listed for the new cell only
    assert "verify.calls" not in [
        m["name"] for m in harness.find_cell("zkevm16.verify.b128", root).per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_every_listed_name_has_its_file():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.find_cell(w["name"])
        harness.entry_module(cell)
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]).read)


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    cell = harness.find_cell("zkevm16.prove")
    assert harness.per_layer_values(cell, {"entry": "prove", "spans": [],
                                           "trace": None}) == {}
