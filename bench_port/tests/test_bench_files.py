"""Every file the benchmark names loads by its name, and BENCHMARK.json
agrees with the workload, configuration, traffic and metric files."""
import json
import os
import re

import pytest

from bench_port import spec

ROOT = os.path.dirname(spec.ROOT)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_and_agree(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = spec.workload(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key], key
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    spec.generator(mix["generator"])
    spec.engine(cfg["engine"])
    conf = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert conf["file"] == f"bench_port/configs/{wl['config']}.json"
    assert conf["reduced"] == cfg["reduced"] == []
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in wl["end_to_end"]:
        assert e2e[m]["unit"] == wl["units"][m]
        assert cell in e2e[m].get("workloads", CELLS)
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for m in wl["per_layer"]:
        assert spec.metric(m).UNIT == per_layer[m]["unit"]
        assert cell in per_layer[m]["workloads"]
        assert per_layer[m]["moves"] in wl["end_to_end"]


def test_every_metric_has_a_reader_and_every_listed_cell_lists_it():
    readers = spec.names("metrics", ".py")
    assert all(m["name"] in readers for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["name"] in spec.workload(cell)["per_layer"]
    for m in BENCH["end_to_end"]:
        for cell in m.get("workloads", CELLS):
            assert m["name"] in spec.workload(cell)["end_to_end"]


def test_names_units_and_limits():
    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert name.match(m["name"]) and unit.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
                assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        check = spec.workload(cell)["check"]
        assert check["limits"] and all(v["limit"] > 0 for v in check["limits"].values())


@pytest.mark.parametrize("cell", spec.names("workloads", ".json"))
def test_every_workload_file_names_files_that_exist(cell):
    """Each workload file loads with all it names."""
    wl = spec.workload(cell)
    cfg, mix = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    spec.generator(mix["generator"])
    spec.engine(cfg["engine"])
    for m in wl["per_layer"]:
        spec.metric(m)
    assert wl["check"]["limits"]


FORM = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_has_the_contract_form():
    """Each entry has exactly its keys (a metric may add ``workloads``), every
    text field is one line of 1-200 characters, and the sizes are in range."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert set(BENCH) == {"command", "paths", "run_seconds", *FORM}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for group, keys in FORM.items():
        entries = BENCH[group]
        assert entries and len({e["name"] for e in entries}) == len(entries)
        for e in entries:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (group, e["name"], set(e) ^ keys)
            assert name.match(e["name"])
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (group, e["name"], key)
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(name.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and name.match(w["config"]) and name.match(w["traffic"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
