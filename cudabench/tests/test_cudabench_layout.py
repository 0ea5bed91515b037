"""The harness finds every configuration, cell, traffic, loop and metric by name, and a file
added to a copy is found without an edit to any other file.  ``BENCHMARK.json`` keeps its
documented shape."""

import json
import re
import shutil

from cudabench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_is_found_by_name():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for cfg in bench["configs"]:
        assert (harness.ROOT / cfg["file"]).is_file()
        assert harness.load_json("configs", cfg["name"])["name"] == cfg["name"]
    rates = {"flagship.train": "train_episodes_per_s", "vox.train_r1": "train_episodes_per_s.r1"}
    for w in bench["workloads"]:
        spec = harness.cell_spec(w["name"], bench)
        assert spec["cell"]["config"] == w["config"] and spec["chips"] == w["chips"] == 1
        assert spec["end_to_end"] == [rates[w["name"]], "setup_s"]
        assert set(spec["per_layer"]) == {m["name"] for m in bench["per_layer"]
                                          if m["moves"] == rates[w["name"]]}
        assert len(spec["per_layer"]) == 7
        assert callable(harness.load_module("loops", spec["traffic"]["loop"]).run)
    for kind, entries in (("metrics", bench["per_layer"]), ("end_to_end", bench["end_to_end"])):
        for m in entries:
            reader = harness.load_module(kind, m["name"])
            assert reader.UNIT == m["unit"] and callable(reader.read)
            assert reader.read({}) is None  # nothing to read: no number


def test_benchmark_file_shape():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for k in ("end_to_end", "per_layer") for n in
                   (x["name"] for x in bench[k]))) == len(bench["end_to_end"]) + len(
        bench["per_layer"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(bench)) < 64 * 1024


def test_added_files_are_found_in_a_copy(tmp_path, monkeypatch):
    """A new configuration, cell and metric in a copy: the harness finds them, and no file
    that was there changes."""
    copy = tmp_path / "cudabench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cfg = json.loads((copy / "configs" / "flagship.json").read_text())
    cfg["name"] = "flagship_b64"
    cfg["game"]["batch_size"] = 64
    (copy / "configs" / "flagship_b64.json").write_text(json.dumps(cfg))
    cell = json.loads((copy / "workloads" / "flagship.train.json").read_text())
    cell["config"] = "flagship_b64"
    (copy / "workloads" / "flagship_b64.train.json").write_text(json.dumps(cell))
    (copy / "metrics" / "steps.train.py").write_text(
        'UNIT = "steps"\n\n\ndef read(ctx):\n    return ctx["unprofiled"]["steps"]\n')
    (copy / "end_to_end" / "steps_per_s.py").write_text(
        'UNIT = "steps/s"\n\n\ndef read(ctx):\n    return ctx["window"]["steps"] / 2\n')
    (copy / "loops" / "replay.py").write_text(
        'def run(spec, seed, seconds, trace, device, t_process):\n    return seed\n')
    (copy / "traffic" / "replay.json").write_text(json.dumps({"loop": "replay"}))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="flagship_b64"))
    bench["workloads"].append({"name": "flagship_b64.train", "config": "flagship_b64",
                               "traffic": "episodes", "chips": 1, "why": "B=64"})
    bench["end_to_end"][0]["workloads"].append("flagship_b64.train")
    bench["workloads"].append({"name": "flagship.replay", "config": "flagship",
                               "traffic": "replay", "chips": 1, "why": "a loop of its own"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "game step",
                               "moves": "train_episodes_per_s"})
    bench["per_layer"].append({"name": "mfu.replay", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "steps_per_s", "workloads": ["flagship.replay"]})
    bench["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["flagship.replay"]})
    (copy / "workloads" / "flagship.replay.json").write_text(
        json.dumps(dict(cell, config="flagship", traffic="replay")))
    monkeypatch.setattr(harness, "HERE", copy)
    spec = harness.cell_spec("flagship_b64.train", bench)
    assert spec["config"]["game"]["batch_size"] == 64
    assert "steps.train" in spec["per_layer"]
    assert harness.load_module("metrics", "steps.train").read({"unprofiled": {"steps": 7}}) == 7
    spec = harness.cell_spec("flagship.replay", bench)
    assert spec["end_to_end"] == ["setup_s", "steps_per_s"] and spec["per_layer"] == ["mfu.replay"]
    assert harness.load_module("loops", spec["traffic"]["loop"]).run(spec, 9, 1, 0, "cpu", 0) == 9
    assert harness.load_module("end_to_end", "steps_per_s").read({"window": {"steps": 8}}) == 4
    # a metric with a suffix and no file of its own is read by its quantity's file
    assert harness.load_module("metrics", "mfu.replay").UNIT == "%"
    assert all(p.read_bytes() == b for p, b in before.items())
