"""A cell, a configuration and a metric added as files alone, in a copy
of the benchmark, run without an edit to any file that was there."""

import json
import shutil

from benchmark import harness
from benchmark.tests.tiny import CELL_OVERRIDES
from benchmark.tests.conftest import ROOT

METRIC = '''"""Records the sink reaped in the window."""


def read(run):
    return run.mode.verdicted
'''


def test_dropped_in_cell_config_and_metric_run(tmp_path, bench_root):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    manifest = json.loads((bench_root / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    # a new deployment: config 2's sliding window over a SYN+benign mix
    cfg = json.loads((bench / "configs" / "syn_benign_online.json")
                     .read_text())
    cfg["name"] = "syn_sliding"
    cfg["fsx"]["limiter"] = {"kind": "sliding_window",
                             "pps_threshold": 5.0,
                             "bps_threshold": 1e9}
    (bench / "configs" / "syn_sliding.json").write_text(json.dumps(cfg))
    (bench / "workloads" / "syn_sliding.paced.json").write_text(json.dumps({
        "config": "syn_sliding", "mode": "paced_inline",
        "params": {"rate_pps": 20000.0, "pool_records": 16384}}))
    (bench / "metrics" / "records.reaped.py").write_text(METRIC)
    manifest["configs"].append({
        "name": "syn_sliding", "source": "test",
        "file": "benchmark/configs/syn_sliding.json", "reduced": [],
        "why": "test"})
    manifest["workloads"].append({
        "name": "syn_sliding.paced", "config": "syn_sliding",
        "traffic": "paced_inline", "chips": 1, "why": "test"})
    manifest["per_layer"].append({
        "name": "records.reaped", "unit": "records", "better": "higher",
        "source": "program_counter", "layer": "sink",
        "moves": "verdict_p99_ms", "workloads": ["syn_sliding.paced"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    out = harness.run_cell(tmp_path, "syn_sliding.paced", 11, 1.5, True,
                           device="cpu",
                           overrides=CELL_OVERRIDES["syn_benign_online.paced"])
    assert out["correct"], out["checks"]
    assert out["metrics"]["records.reaped"]["value"] == out["attempted"]
    assert out["served"]["dropped_rate"] > 0      # the sliding window bit
