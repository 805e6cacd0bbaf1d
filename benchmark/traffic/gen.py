"""Synthetic traffic generators — the five BASELINE.json configs.

The benchmark's frozen copy of ``flowsentryx_tpu_torch/engine/traffic.py``
(numpy only, importing nothing of the program): the same seed gives
byte-identical records to the program's ``TrafficGen``, and a later change
to the program's generator cannot move the benchmark's traffic.

The reference has no load generator at all (its TODO says "Need to
create the testing phase", ``TODO.md:272``); these model the scenarios
BASELINE.json names so benches and tests share one traffic vocabulary.
Each generator yields ``FLOW_RECORD_DTYPE`` arrays — the same records
the kernel's feature extractor emits (``kern/fsx_kern.c``
``extract_features``) — at a configurable packet rate on a synthetic
clock, so a scenario is reproducible and rate-exact regardless of how
fast the host happens to run it.

Feature values are *streaming estimates as the kernel would emit them*:
attack flows get flood-like statistics (tiny IATs, uniform sizes),
benign flows get interactive-like ones.  They exercise the classifier
realistically without pretending to be a packet parser.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from benchmark.traffic import records as schema


class Scenario(enum.Enum):
    """BASELINE.json configs 1-5 (plus a benign-only control)."""

    BENIGN = "benign"
    ICMP_FLOOD_SINGLE = "icmp_flood_single"     # config 1
    UDP_FLOOD_MULTI = "udp_flood_multi"         # config 2
    OFFLINE_BATCH = "offline_batch"             # config 3 (classifier only)
    SYN_BENIGN_MIX = "syn_benign_mix"           # config 4
    MIXED_L34_1M = "mixed_l34_1m"               # config 5


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Shape of one scenario's packet stream."""

    scenario: Scenario = Scenario.SYN_BENIGN_MIX
    rate_pps: float = 10_000_000.0     # synthetic-clock packet rate
    attack_fraction: float = 0.8       # fraction of packets that are attack
    n_attack_ips: int = 1024           # attack source pool
    n_benign_ips: int = 4096           # benign source pool
    seed: int = 0

    def with_(self, **kw) -> "TrafficSpec":
        return dataclasses.replace(self, **kw)


#: Per-scenario overrides applied on top of a user spec.
_SCENARIO_SHAPE: dict[Scenario, dict] = {
    Scenario.BENIGN: dict(attack_fraction=0.0),
    Scenario.ICMP_FLOOD_SINGLE: dict(n_attack_ips=1),
    Scenario.UDP_FLOOD_MULTI: dict(n_attack_ips=4096),
    Scenario.OFFLINE_BATCH: dict(),
    Scenario.SYN_BENIGN_MIX: dict(attack_fraction=0.5),
    Scenario.MIXED_L34_1M: dict(n_attack_ips=1 << 19, n_benign_ips=1 << 19),
}

_PROTO = {"icmp": 1, "tcp": 6, "udp": 17}


class TrafficGen:
    """Streaming generator: ``next_records(n)`` → n records on a
    synthetic clock advancing at ``spec.rate_pps``."""

    def __init__(self, spec: TrafficSpec):
        # Scenario shape supplies defaults; explicit user settings win
        # (only fields still at their dataclass default are shaped).
        defaults = TrafficSpec()
        shape = {
            k: v
            for k, v in _SCENARIO_SHAPE[spec.scenario].items()
            if getattr(spec, k) == getattr(defaults, k)
        }
        shaped = spec.with_(**shape)
        self.spec = shaped
        self.rng = np.random.default_rng(shaped.seed)
        self.now_ns = 1_000_000_000  # synthetic boot-relative clock
        self._dt_ns = max(1, int(1e9 / shaped.rate_pps))
        # disjoint IP pools: attack = [1, A], benign = [2^24, 2^24+B)
        self._attack_ips = self.rng.integers(
            1, 1 << 24, shaped.n_attack_ips, dtype=np.uint32
        ) if shaped.scenario is not Scenario.ICMP_FLOOD_SINGLE else np.array(
            [0xBADBAD], np.uint32  # single flooder, inside the <2^24 attack pool
        )
        self._benign_ips = (
            self.rng.integers(0, 1 << 24, shaped.n_benign_ips, dtype=np.uint32)
            + np.uint32(1 << 24)
        )

    @property
    def attack_ips(self) -> np.ndarray:
        """Ground-truth attack source pool (stable for a given seed)."""
        return self._attack_ips

    @property
    def benign_ips(self) -> np.ndarray:
        """Ground-truth benign source pool (stable for a given seed)."""
        return self._benign_ips

    # -- feature synthesis (kernel-estimator statistics) --------------------

    def _attack_feat(self, n: int) -> np.ndarray:
        """Flood statistics: fixed small packets, machine-gun IATs,
        short intense flows (kernel-estimator semantics: duration from
        first/last stamps, rate = pkts/duration)."""
        f = np.zeros((n, schema.NUM_FEATURES), np.uint32)
        f[:, schema.Feature.DST_PORT] = self.rng.choice([80, 443, 53], n)
        size = self.rng.integers(60, 80, n)
        f[:, schema.Feature.PKT_LEN_MEAN] = size
        f[:, schema.Feature.PKT_LEN_STD] = self.rng.integers(0, 3, n)
        iat = self.rng.integers(1, 50, n)  # µs: flood-rate arrivals
        npkts = self.rng.integers(100, 5000, n).astype(np.uint64)
        dur_us = np.maximum(iat.astype(np.uint64) * npkts, 1)
        f[:, schema.Feature.FLOW_DUR_MS] = dur_us // 1000
        f[:, schema.Feature.FLOW_PPS_X1000] = np.minimum(
            npkts * np.uint64(1_000_000_000) // dur_us, 0xFFFFFFFF)
        f[:, schema.Feature.FWD_IAT_MEAN] = iat
        f[:, schema.Feature.FWD_IAT_STD] = self.rng.integers(0, 20, n)
        f[:, schema.Feature.FWD_IAT_MAX] = iat * self.rng.integers(1, 4, n)
        return f

    def _benign_feat(self, n: int) -> np.ndarray:
        """Interactive statistics: varied sizes, human-scale IATs,
        short-to-medium flows at interactive rates."""
        f = np.zeros((n, schema.NUM_FEATURES), np.uint32)
        f[:, schema.Feature.DST_PORT] = self.rng.choice(
            [443, 443, 443, 80, 22, 8443], n
        )
        size = self.rng.integers(100, 1500, n)
        std = self.rng.integers(100, 600, n)
        f[:, schema.Feature.PKT_LEN_MEAN] = size
        f[:, schema.Feature.PKT_LEN_STD] = std
        iat = self.rng.integers(5_000, 500_000, n)  # µs: ms-scale arrivals
        npkts = self.rng.integers(2, 200, n).astype(np.uint64)
        dur_us = np.maximum(iat.astype(np.uint64) * npkts, 1)
        f[:, schema.Feature.FLOW_DUR_MS] = dur_us // 1000
        f[:, schema.Feature.FLOW_PPS_X1000] = np.minimum(
            npkts * np.uint64(1_000_000_000) // dur_us, 0xFFFFFFFF)
        f[:, schema.Feature.FWD_IAT_MEAN] = iat
        f[:, schema.Feature.FWD_IAT_STD] = iat // self.rng.integers(1, 4, n)
        f[:, schema.Feature.FWD_IAT_MAX] = iat * self.rng.integers(2, 8, n)
        return f

    # -- record stream ------------------------------------------------------

    def next_records(self, n: int) -> np.ndarray:
        """The next ``n`` packets of the scenario as ring records."""
        spec = self.spec
        buf = np.zeros(n, dtype=schema.FLOW_RECORD_DTYPE)
        is_attack = self.rng.random(n) < spec.attack_fraction

        na = int(is_attack.sum())
        nb = n - na
        feat = np.zeros((n, schema.NUM_FEATURES), np.uint32)
        if na:
            feat[is_attack] = self._attack_feat(na)
            buf["saddr"][is_attack] = self.rng.choice(self._attack_ips, na)
        if nb:
            feat[~is_attack] = self._benign_feat(nb)
            buf["saddr"][~is_attack] = self.rng.choice(self._benign_ips, nb)
        buf["feat"] = feat

        if spec.scenario is Scenario.ICMP_FLOOD_SINGLE:
            proto = np.where(is_attack, _PROTO["icmp"], _PROTO["tcp"])
        elif spec.scenario is Scenario.UDP_FLOOD_MULTI:
            proto = np.where(is_attack, _PROTO["udp"], _PROTO["tcp"])
        elif spec.scenario is Scenario.SYN_BENIGN_MIX:
            proto = np.full(n, _PROTO["tcp"], np.uint8)
            buf["flags"][is_attack] |= schema.FLAG_TCP_SYN | schema.FLAG_TCP
        else:  # mixed L3/L4
            proto = self.rng.choice(list(_PROTO.values()), n)
        buf["ip_proto"] = proto

        buf["pkt_len"] = np.where(
            is_attack,
            self.rng.integers(60, 80, n),
            self.rng.integers(100, 1500, n),
        )
        buf["ts_ns"] = (self.now_ns
                        + np.arange(n, dtype=np.uint64) * self._dt_ns)
        self.now_ns += n * self._dt_ns
        return buf

    def labels_for(self, buf: np.ndarray) -> np.ndarray:
        """Ground truth for a generated buffer (attack pool membership)."""
        return buf["saddr"] < (1 << 24)
