"""``BENCHMARK.json`` keeps to the contract's shape, and every name in
it has its file."""

import json
import re

from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_shape_and_names():
    m = _manifest()
    assert set(m) == KEYS
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert m["paths"] == ["benchmark"]
    r = m["run_seconds"]
    assert 1 <= r <= 51
    # a full check of 24 cells fits its day
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        names = [e["name"] for e in m[group]]
        assert len(set(names)) == len(names)
        for e in m[group]:
            assert set(e) == keys and NAME.match(e["name"])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e and "\n" not in x["layer"]
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"


def test_every_name_has_its_file():
    m = _manifest()
    bench = ROOT / "benchmark"
    configs = {c["name"] for c in m["configs"]}
    for c in m["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and set(c["reduced"]) <= set(
            data["reduced"])
    for w in m["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        data = json.loads((bench / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert data["config"] == w["config"]
        assert data["mode"] == w["traffic"]
        assert (bench / "traffic" / f"{data['mode']}.py").exists()
    for x in m["end_to_end"] + m["per_layer"]:
        assert (bench / "metrics" / f"{x['name']}.py").exists(), x["name"]
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for w in m["workloads"]:
        def reports(group):
            return [x["name"] for x in m[group]
                    if "workloads" not in x or w["name"] in x["workloads"]]
        assert "setup_s" in reports("end_to_end")
        assert len(reports("end_to_end")) >= 2 and reports("per_layer")
