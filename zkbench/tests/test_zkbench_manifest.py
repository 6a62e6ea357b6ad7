"""BENCHMARK.json holds to the benchmark's contract, and every
configuration, mix and metric it names is found by its name."""

import json
import re

import pytest

from zkbench import manifest
from zkbench.manifest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "zkbench/run.py"]
    assert bench["paths"] == ["zkbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(bench, section):
    entries = bench[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key])


def test_configs(bench):
    for c in bench["configs"]:
        assert c["source"].startswith("https://")
        assert c["file"].startswith("zkbench/")
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"] == []
        assert manifest.load_config(c["name"], ROOT / c["file"]).zk


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    assert {w["config"] for w in bench["workloads"]} == configs
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        cell = manifest.cell(w["name"], trace=False)
        assert cell.mix.name == w["traffic"]


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert next(m for m in bench["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = [m["name"] for m in bench["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in bench["per_layer"]
                  if cell in m.get("workloads", [cell])]
        assert layers and all(m["moves"] in reported for m in layers)


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, section):
    for m in bench[section]:
        assert callable(manifest.metric_module(m["name"]).read)


@pytest.mark.parametrize("trace", [False, True])
def test_cells_find_their_metrics(bench, trace):
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"], trace)
        names = {m["name"] for m in cell.metrics}
        section = "per_layer" if trace else "end_to_end"
        assert names == {m["name"] for m in bench[section]
                         if w["name"] in m.get("workloads", [w["name"]])}


def test_unknown_workload():
    with pytest.raises(KeyError):
        manifest.cell("nothing.here", trace=False)
