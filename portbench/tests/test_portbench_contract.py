"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file."""

import importlib
import json
import re

from portbench import harness, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.benchmark()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    # a full check of 24 cells fits its time
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] \
        + [w["config"] for w in BENCH["workloads"]] \
        + [w["traffic"] for w in BENCH["workloads"]] \
        + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_is_found_as_a_file():
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert (harness.PKG / "fits" / f"{cfg['fit']}.py").is_file()
        assert (harness.PKG / "reference" / f"{cfg['fit']}_fit.py").is_file()
        ref_fit = importlib.import_module(
            f"portbench.reference.{cfg['fit']}_fit")
        assert set(cfg["limits"]) == set(ref_fit.NUMBERS)
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for w in BENCH["workloads"]:
        harness.cell(BENCH, w["name"])
        assert traffic.load(w["traffic"])["cameras"]["azimuths"] >= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_moves_names_an_end_to_end_metric_every_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        listed = m.get("workloads", cells)
        assert set(listed) <= set(cells)
        reporting = e2e[m["moves"]].get("workloads", cells)
        assert set(listed) <= set(reporting), m["name"]
    for w in cells:
        names = {m["name"] for m in harness.metrics_of(BENCH, w, False)}
        assert "setup_s" in names and len(names) >= 2
        assert harness.metrics_of(BENCH, w, True)


def test_one_layer_name_per_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
