"""BENCHMARK.json against the contract's shapes: names, units, keys,
which cells report which metric, and a reader file for every metric."""

import json
import re

import pytest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture
def bench(checkout):
    return json.loads((checkout / "BENCHMARK.json").read_text())


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and (
        "\n" not in text and "\t" not in text)


def test_top_level(bench, checkout):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((checkout / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs(bench, checkout):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/")
        data = json.loads((checkout / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert c["name"] in used
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)


def test_workloads(bench, checkout):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
        pb = checkout / "portbench"
        assert (pb / "workloads" / f"{w['name']}.json").exists()
        assert (pb / "traffic" / f"{w['traffic']}.json").exists()
        cell = json.loads((pb / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert cell["limits"]["max_logit_gap"] > 0


def metrics(bench):
    return bench["end_to_end"] + bench["per_layer"]


def test_metric_entries(bench, checkout):
    names = [m["name"] for m in metrics(bench)]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"ttft_p95_ms", "tpot_p95_ms", "setup_s"} == e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and line(m["layer"])
    for m in metrics(bench):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_named_alike(bench):
    by_prefix = {}
    for m in bench["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def reports(bench, cell, kind):
    return {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = reports(bench, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        per = reports(bench, w["name"], "per_layer")
        assert per
        for m in bench["per_layer"]:
            if m["name"] in per:
                assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_reader_for_every_metric(bench, checkout):
    from portbench.manifest import Layout

    layout = Layout(checkout)
    for m in metrics(bench):
        assert callable(layout.reader(m["name"]))


def test_files_named_from_name_characters(checkout):
    for p in (checkout / "portbench").rglob("*"):
        if "__pycache__" in p.parts or ".build" in p.parts:
            continue
        rel = p.relative_to(checkout).as_posix()
        assert PATH.match(rel), rel
