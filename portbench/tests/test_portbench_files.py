"""The bench's files: BENCHMARK.json against its required form, and every
cell, configuration, traffic mix, driver and per-layer reader found by
name."""

import json
import os
import re

import pytest

from portbench import harness

REPO = os.path.dirname(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names), names
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in [w["why"] for w in b["workloads"]] + [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    b = bench()
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = next(w for w in bench()["workloads"] if w["name"] == cell)
    c = harness.load_cell(cell)
    assert (c["config"], c["traffic"], c["chips"]) == (entry["config"], entry["traffic"],
                                                       entry["chips"])
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert os.path.isfile(os.path.join(harness.ROOT, "drivers", c["mix"]["kind"] + ".py"))
    conf = next(x for x in bench()["configs"] if x["name"] == entry["config"])
    assert conf["file"] == f"portbench/configs/{entry['config']}.json"
    assert c["cfg"]["source"] == conf["source"] and c["cfg"]["name"] == conf["name"]


def test_every_per_layer_metric_has_its_reader():
    readers = harness.metric_readers()
    for m in bench()["per_layer"]:
        assert harness.reader_of(m["name"], readers).UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in bench()["end_to_end"]}


def test_reader_of_a_split_metric():
    readers = harness.metric_readers()
    assert harness.reader_of("train.mfu.any_cell", readers) is readers["train.mfu"]
    assert harness.reader_of("serve.mfu", readers) is readers["serve.mfu"]
    with pytest.raises(SystemExit):
        harness.reader_of("no_such.metric", readers)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_names_its_metrics_as_the_benchmark_does(cell):
    """A cell's ``rate`` is its one end-to-end metric besides ``setup_s``,
    and its ``per_layer`` list the per-layer metrics that list the cell,
    each moving a metric the cell reports."""
    b, c = bench(), harness.load_cell(cell)
    e2e = {m["name"] for m in b["end_to_end"] if cell in m.get("workloads", [cell])}
    assert e2e == {"setup_s", c["rate"]}
    listed = [m for m in b["per_layer"] if cell in m["workloads"]]
    assert sorted(c["per_layer"]) == sorted(m["name"] for m in listed)
    assert all(m["moves"] in e2e for m in listed)


def test_every_cell_reports_a_per_layer_metric_and_setup():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in b["per_layer"])
