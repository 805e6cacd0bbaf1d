"""Each cell's harness end to end at a tiny size on the CPU: the window
serves through the program's engine, the plain reference replays what it
served, and the two agree exactly."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT
from benchmark.tests.tiny import CELLS, CELL_OVERRIDES

#: The end-to-end metric each cell reports on the CPU (the sharded
#: cell's, the card's busy time from the device trace, only on the card)
E2E = {"mixed_l34_1m.sharded": None,
       "syn_benign_online.paced": "verdict_p99_ms"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_reference(cell, bench_root):
    out = harness.run_cell(bench_root, cell, 2**31 + 12345, 1.5, False,
                           device="cpu", overrides=CELL_OVERRIDES[cell])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    served = out["served"]
    # the comparison has something to compare: records dropped by the
    # blacklist and the model, blocks written back
    assert served["blocks"] > 0
    assert served["dropped_blacklist"] > 0 and served["dropped_ml"] > 0
    assert served["records_per_s"] > 0
    assert served["device_ops"] == 0 and served["device_busy_s"] == 0.0
    if E2E[cell]:
        assert E2E[cell] in out["metrics"]
    assert "card_records_per_s" not in out["metrics"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_host_layers(cell, bench_root):
    out = harness.run_cell(bench_root, cell, 99, 1.5, True, device="cpu",
                           overrides=CELL_OVERRIDES[cell])
    assert out["correct"], out["checks"]
    assert "boot.serving_ready_s" in out["metrics"]
    if cell == "mixed_l34_1m.sharded":
        # served over the window's first part, before the profiler
        assert out["metrics"]["served.records_per_s"]["value"] > 0
    # device metrics come from the card's trace only: none on the CPU
    assert not any(k.startswith(("device.", "step")) or "roofline" in k
                   for k in out["metrics"])


def test_sharded_run_counts_its_producer_and_the_host():
    cell = "mixed_l34_1m.sharded"
    out = harness.run_cell(ROOT, cell, 2**33 + 1, 1.5, False, device="cpu",
                           overrides=CELL_OVERRIDES[cell])
    assert out["correct"], out["checks"]
    prod = out["served"]["producer"]
    # the window's counters: the producer refilled the rings and, on the
    # CPU, where the engine is slow, found them full between refills
    assert prod["refills"] > 0 and prod["full_sleeps"] > 0
    assert prod["refills_empty"] <= prod["refills_under_batch"]
    assert 0 < prod["held_at_refill"]
    assert set(out["setup_phases"]) >= {"warm_s", "producer_ready_s"}
    host = out["host"]
    # every process of the run was counted over the window
    cores = host["cores"]
    assert set(cores) == {"engine", "bench-producer", "fsx-ingest-0",
                          "fsx-ingest-1"}, cores
    assert all(0 <= c <= 64 for c in cores.values()) and cores["engine"] > 0
    assert host["probe_ms"] > 0


class _Mode:
    verdicted = 3_000_000


class _Run:
    mode = _Mode()
    device_ops = 80_000
    device_busy_s = 0.15


def test_card_rate_reads_the_device_trace():
    reader = harness.load_reader(ROOT / "benchmark", "card_records_per_s")
    assert reader.read(_Run()) == 3_000_000 / 0.15
    # no device trace (off the card): nothing to read, never 0
    run = _Run()
    run.device_ops, run.device_busy_s = 0, 0.0
    assert reader.read(run) is None


class _Event:
    def __init__(self, start, duration, device):
        self._s, self._d, self._t = start, duration, device

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


def test_device_busy_is_the_union_of_device_intervals():
    import types

    import torch

    from benchmark import trace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event(100, 50, cuda), _Event(120, 10, cuda),  # inside
              _Event(140, 30, cuda),                         # overlaps
              _Event(300, 20, cuda),                         # apart
              _Event(0, 1000, cpu)]                          # the host's
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    n, busy = trace.device_busy(prof)
    assert n == 4 and busy == (70 + 20) * 1e-9
