"""The record pool of a run: ``n`` records of the configuration's
scenario, drawn from the seed with the benchmark's own generator."""

from __future__ import annotations

import numpy as np

from benchmark.traffic.gen import Scenario, TrafficGen, TrafficSpec
from benchmark.traffic.records import FLOW_RECORD_DTYPE

#: Records drawn per generator call: the pool of a seed is the same
#: bytes whatever the caller (the draws depend on the call sizes).
CHUNK = 1 << 20


def traffic_spec(traffic: dict, seed: int) -> TrafficSpec:
    """The configuration's ``traffic`` block -> a generator spec."""
    return TrafficSpec(
        scenario=Scenario(traffic["scenario"]),
        rate_pps=float(traffic["rate_pps"]),
        attack_fraction=float(traffic["attack_fraction"]),
        n_attack_ips=int(traffic["n_attack_ips"]),
        n_benign_ips=int(traffic["n_benign_ips"]),
        seed=int(seed))


def make_pool(traffic: dict, seed: int, n: int) -> np.ndarray:
    """``n`` records on the generator's clock (``ts_ns`` rises by one
    inter-arrival a record from its first value)."""
    gen = TrafficGen(traffic_spec(traffic, seed))
    out = np.empty(n, FLOW_RECORD_DTYPE)
    for i in range(0, n, CHUNK):
        out[i:i + CHUNK] = gen.next_records(min(CHUNK, n - i))
    return out
