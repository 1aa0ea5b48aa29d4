"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import re

from tsim_bench.common import HERE, ROOT, load, manifest, module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    None: {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_names_and_units():
    m = manifest()
    assert set(m) == KEYS[None]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[part]]
        assert len(names) == len(set(names))
        for e in m[part]:
            extra = {"workloads"} if part in ("end_to_end",
                                               "per_layer") else set()
            assert KEYS[part] <= set(e) <= KEYS[part] | extra, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert TEXT.match(e[k]), (e["name"], k)
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in m["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for word in m["command"]:
        assert TEXT.match(word) and not word.startswith("/")
        assert ".." not in word


def test_bounds_and_sources():
    m = manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in e2e.values():
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in m["per_layer"]:
        assert e["moves"] in e2e
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    layers = {}
    for e in m["per_layer"]:
        layers.setdefault(e["name"], e["layer"])
    cells = {w["name"] for w in m["workloads"]}
    for e in m["per_layer"]:
        assert set(e.get("workloads", cells)) <= cells
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for c in cells:
        assert any(c in e.get("workloads", [c]) for e in m["per_layer"])
        assert sum(c in e.get("workloads", [c])
                   for e in m["end_to_end"]) >= 2


def test_run_seconds_fit_the_check():
    m = manifest()
    s = m["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    # 2 + 14 x 24 runs of (s + 60) s, 2 x 90 s to compile a cell, 1200
    # spare: within 43200 s
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_found_by_name():
    m = manifest()
    for c in m["configs"]:
        path = ROOT / c["file"]
        assert path.parent == HERE / "configs" and path.stem == c["name"]
        cfg = json.loads(path.read_text())
        assert set(cfg["config"]) and cfg["reduced"] == c["reduced"]
        for step in cfg["steps"]:
            assert callable(module("steps", step["step"]).run)
    used = set()
    for w in m["workloads"]:
        cell = load("cells", w["name"])
        assert cell["config"] == w["config"]
        used.add(w["config"])
        roll = module("rollouts", cell["rollout"])
        for fn in ("worlds", "sample", "begin", "chunk", "world",
                   "start_worlds", "ref_starts", "ref_rollout"):
            assert callable(getattr(roll, fn))
        assert cell["horizon"] % cell["chunk"] == 0
        assert set(cell["path"]) == {"env", "positive", "zero"}
        assert set(cell["limits"]) == {"int_diff", "float_gap"}
    assert used == {c["name"] for c in m["configs"]}
    for e in m["per_layer"]:
        assert callable(module("metrics", e["name"]).read)


def test_the_path_pin_refuses_another_path():
    import pytest
    from tsim_bench.harness import PathError, check_path
    for w in manifest()["workloads"]:
        path = load("cells", w["name"])["path"]
        ok = {k: 5 for k in path["positive"]}
        check_path(ok, path)
        for k in path["positive"]:
            with pytest.raises(PathError, match=k):
                check_path({**ok, k: 0}, path)
        for k in path["zero"]:
            with pytest.raises(PathError, match=k):
                check_path({**ok, k: 1}, path)
