"""The port's CUDA kernels and engine on the card, against their plain
versions.  Every test here needs an NVIDIA GPU and skips without one
(the kernels have no CPU mode).  The file imports no JAX, so it runs on
a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.engine import (
    CollectSink, Engine, Scenario, TrafficSource, TrafficSpec,
)
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.ops import kernels

ARTIFACT = str(Path(__file__).resolve().parents[1] / "artifacts"
               / "logreg_int8.npz")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["golden", "log1p"])
@pytest.mark.parametrize("b", [1, 7, 15, 2047, 2048, 2049, 4099])
def test_score_int8_kernel_matches_plain(cuda, name, b):
    tp = (logreg.golden_params(cuda) if name == "golden"
          else logreg.load_params(ARTIFACT, cuda))
    x = torch.from_numpy(np.random.default_rng(b).uniform(
        0, 2e6, (b, 8)).astype(np.float32)).to(cuda)
    n0 = kernels.LAUNCHES["score_int8"]
    got = kernels.score_int8(tp, x)
    assert kernels.LAUNCHES["score_int8"] == n0 + 1
    want = kernels.score_int8_plain(tp, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["golden", "log1p"])
def test_score_int8_packed_table_equals_plain_output(cuda, name):
    """The kernel's output stage is a table lookup by the output code;
    the table must be the plain output stage for all 256 codes."""
    tp = (logreg.golden_params(cuda) if name == "golden"
          else logreg.load_params(ARTIFACT, cuda))
    packed = kernels.pack_score_params(tp)
    codes = torch.arange(256, dtype=torch.float32, device=cuda)
    assert torch.equal(packed.table, logreg.score_from_code(tp, codes))
    assert list(packed.args.table) == packed.table.cpu().tolist()


def test_score_int8_wrapper_refuses_bad_inputs(cuda):
    tp = logreg.golden_params(cuda)
    x = torch.zeros(16, 8, device=cuda)
    with pytest.raises(ValueError):
        kernels.score_int8(tp, x.double())
    with pytest.raises(ValueError):
        kernels.score_int8(tp, torch.zeros(16, 7, device=cuda))
    with pytest.raises(ValueError):
        kernels.score_int8(tp, torch.zeros(8, 16, device=cuda).t())


def _summary_case(cuda, n, occupancy):
    rng = np.random.default_rng(n)
    key = np.where(rng.random(n) < occupancy,
                   rng.integers(1, 1 << 32, n, dtype=np.uint64), 0
                   ).astype(np.uint32)
    state = np.zeros((n, schema.NUM_TABLE_COLS), np.float32)
    state[:, schema.TableCol.LAST_SEEN] = rng.uniform(0, 100, n)
    state[:, schema.TableCol.BLOCKED_UNTIL] = np.where(
        rng.random(n) < 0.3, rng.uniform(80, 200, n), 0)
    return (torch.from_numpy(key.view(np.int32)).to(cuda),
            torch.from_numpy(state).to(cuda))


@pytest.mark.parametrize("occupancy", [0.005, 0.47])
@pytest.mark.parametrize("n", [1, 4, 13, 1003, (1 << 20) - 3, 1 << 20])
def test_table_summary_ragged_and_occupancy(cuda, n, occupancy):
    """Row counts that end in a partial 4-row key group and a partial
    256-row warp step, and the sparse (0.5 %) and half-full (47 %)
    occupancies of the served tables."""
    k, s = _summary_case(cuda, n, occupancy)
    got = kernels.table_summary_counts(k, s, 90.0, 30.0)
    want = kernels.table_summary_plain(k, s, 90.0, 30.0)
    assert torch.equal(got[0], want[0])
    assert float(got[1]) == float(want[1])


def test_table_summary_wrapper_refuses_bad_inputs(cuda):
    k, s = _summary_case(cuda, 1 << 12, 0.5)
    with pytest.raises(ValueError):
        kernels.table_summary_counts(k.long(), s, 90.0, 30.0)
    with pytest.raises(ValueError):
        kernels.table_summary_counts(k, s.double(), 90.0, 30.0)
    with pytest.raises(ValueError):
        kernels.table_summary_counts(k[::2], s[::2], 90.0, 30.0)


def test_table_summary_refuses_a_key_view_not_16_byte_aligned(cuda):
    """The kernel reads keys as 16-byte words: a key view that starts 4
    bytes into its buffer raises; the same rows copied to an aligned
    tensor (the state view stays as it is) give the plain answer."""
    k, s = _summary_case(cuda, (1 << 16) + 1, 0.47)
    assert k[1:].data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.table_summary_counts(k[1:], s[1:], 90.0, 30.0)
    got = kernels.table_summary_counts(k[1:].clone(), s[1:], 90.0, 30.0)
    want = kernels.table_summary_plain(k[1:], s[1:], 90.0, 30.0)
    assert torch.equal(got[0], want[0])
    assert float(got[1]) == float(want[1])


@pytest.mark.parametrize("n", [1000, (1 << 20) - 3, 1 << 20])
def test_table_summary_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    key = np.where(rng.random(n) < 0.5,
                   rng.integers(1, 1 << 32, n, dtype=np.uint64), 0
                   ).astype(np.uint32)
    state = np.zeros((n, schema.NUM_TABLE_COLS), np.float32)
    state[:, schema.TableCol.LAST_SEEN] = rng.uniform(0, 100, n)
    state[:, schema.TableCol.BLOCKED_UNTIL] = np.where(
        rng.random(n) < 0.3, rng.uniform(80, 200, n), 0)
    k = torch.from_numpy(key.view(np.int32)).to(cuda)
    s = torch.from_numpy(state).to(cuda)
    n0 = kernels.LAUNCHES["table_summary"]
    got = kernels.table_summary_counts(k, s, 90.0, 30.0)
    assert kernels.LAUNCHES["table_summary"] == n0 + 1
    want = kernels.table_summary_plain(k, s, 90.0, 30.0)
    assert torch.equal(got[0], want[0])
    assert float(got[1]) == float(want[1])


def _digest(e):
    k, st = schema.table_to_numpy(e.table)
    return hashlib.sha256(k.tobytes() + st.tobytes()).hexdigest()


@pytest.mark.parametrize("scenario", ["syn_benign_mix", "mixed_l34_1m"])
def test_cuda_engine_equals_cpu_engine(cuda, scenario):
    cfg = config.FsxConfig(table=config.TableConfig(capacity=1 << 14,
                                                    salt=99),
                           batch=config.BatchConfig(max_batch=2048))
    out = {}
    for device in ("cuda", "cpu"):
        src = TrafficSource(TrafficSpec(scenario=Scenario(scenario),
                                        seed=5), total=12 * 2048)
        e = Engine(cfg, src, CollectSink(),
                   params=logreg.load_params(ARTIFACT, device),
                   device=device)
        r = e.run()
        out[device] = (r.stats, e.sink.blocked, _digest(e), r.table)
    assert out["cuda"] == out["cpu"]
