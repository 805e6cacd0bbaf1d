"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from
the checkout's root (on the card: ``-m cuda`` for the card's cases)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips on hosts without one "
        "(run on the card: python -m pytest -m cuda benchmark/tests)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cell runs on the card)")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bench_root(tmp_path_factory):
    """A checkout root whose ``BENCHMARK.json`` also lists the paced cell
    (``paced_cell.json``: its configuration, cell and metrics, entries a
    later PR would add), over this checkout's ``benchmark/``."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((Path(__file__).parent / "paced_cell.json")
                       .read_text())
    for group, entries in extra.items():
        have = {e["name"]: e for e in manifest[group]}
        for e in entries:
            if e["name"] not in have:
                manifest[group].append(e)
            elif "workloads" in have[e["name"]]:
                have[e["name"]]["workloads"] += e["workloads"]
    root = tmp_path_factory.mktemp("root")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / "benchmark").symlink_to(ROOT / "benchmark")
    return root
