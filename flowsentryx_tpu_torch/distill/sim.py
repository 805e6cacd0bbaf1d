"""Simulated kernel tier: the escalation protocol without root.

Counterpart of ``flowsentryx_tpu/distill/sim.py`` (a copy, numpy only).

Production wires the distilled model into XDP (``fsx distill --pin``
against an ``--ml`` image) and the band counters come back through the
kernel stats map (``fsx status --pin``, the daemon's report).  Neither
bpf(2) nor a NIC exists in CI — so this module applies the SAME band
split, from the SAME plan, to the record stream in front of the engine:
:class:`SimKernelTier` drops the confident-attack band, suppresses the
confident-benign band, forwards only the uncertain band, and counts
everything into ``EngineReport.escalation``.  The scorer is
:meth:`DistillPlan.bands` — pure u32-vs-u32 integer compares, proven
bit-identical to the emitted bytecode by tests/test_distill.py — so the
simulated split is exactly the split the kernel would produce on the
same records.

Fidelity note: the kernel scores at *emit cadence* (every packet while
a flow is young, then every 16th) and the record stream IS that
cadence, so per-record banding is faithful.  What the sim adds
optionally (``block_s``) is the drop band's blacklist amplification —
once a source trips the drop band, its subsequent records are swallowed
at the simulated gate until the TTL lapses, mirroring the in-kernel
``blacklist_map`` insert.  Counters mirror the kernel split:
``kernel_drops`` ↔ ``dropped_ml``, ``blacklist_hits`` ↔ the
``dropped_blacklist`` share the ML tier caused, ``kernel_passes`` ↔
``ml_pass``, ``escalated`` ↔ ``ml_escalated``.
"""

from __future__ import annotations

import numpy as np

from flowsentryx_tpu_torch.core import wire as schema
from flowsentryx_tpu_torch.distill.plan import DistillPlan


class SimKernelTier:
    """Band-splits ``FLOW_RECORD_DTYPE`` record arrays in front of the
    engine (``Engine(kernel_tier=...)`` / ``fsx serve
    --sim-kernel-tier``)."""

    def __init__(self, plan: DistillPlan, block_s: float | None = 10.0):
        self.plan = plan
        #: Simulated blacklist TTL seconds (None disables the
        #: amplification model; 10 s mirrors ModelConfig.ml_block_s).
        self.block_s = block_s
        self.records_in = 0
        self.kernel_drops = 0     # drop-band records (dropped_ml twin)
        self.blacklist_hits = 0   # swallowed by the simulated blacklist
        self.kernel_passes = 0    # benign band, emit suppressed
        self.escalated = 0        # forwarded to the engine
        self._blocked: dict[int, int] = {}  # saddr -> until ts_ns
        self._last_ts = 0         # newest record ts seen (eviction clock)
        #: Prune expired blacklist entries past this size — a spoofed-
        #: source flood (fresh saddr per drop) must not grow the dict
        #: unboundedly over a long run (the kernel analog is an LRU map).
        self._prune_at = 1 << 16

    def filter(self, records: np.ndarray) -> np.ndarray:
        """One drained record array in → the escalate-band subset out."""
        n = len(records)
        if not n:
            return records
        self.records_in += n
        self._last_ts = max(self._last_ts, int(records["ts_ns"].max()))
        if len(self._blocked) > self._prune_at:
            self._blocked = {s: u for s, u in self._blocked.items()
                             if u > self._last_ts}
        keep = np.ones(n, bool)
        if self.block_s is not None and self._blocked:
            ts = records["ts_ns"]
            until = np.array(
                [self._blocked.get(int(s), 0) for s in records["saddr"]],
                np.uint64)
            hit = ts < until
            self.blacklist_hits += int(hit.sum())
            keep &= ~hit
        bands = self.plan.bands(records["feat"])
        drop = keep & (bands == schema.ML_BAND_DROP)
        self.kernel_drops += int(drop.sum())
        if self.block_s is not None and drop.any():
            ttl = np.uint64(int(self.block_s * 1e9))
            for s, t in zip(records["saddr"][drop], records["ts_ns"][drop]):
                self._blocked[int(s)] = max(
                    self._blocked.get(int(s), 0), int(t + ttl))
        benign = keep & (bands == schema.ML_BAND_PASS)
        self.kernel_passes += int(benign.sum())
        keep &= bands == schema.ML_BAND_ESCALATE
        self.escalated += int(keep.sum())
        return records[keep]

    def report(self) -> dict:
        """The ``EngineReport.escalation`` block (rates added by the
        engine, which owns the wall clock)."""
        return {
            "mode": "sim",
            "thresholds": {
                "t_lo": self.plan.t_lo, "t_hi": self.plan.t_hi,
                "acc_pass": self.plan.acc_pass,
                "acc_drop": self.plan.acc_drop,
            },
            "records_in": self.records_in,
            "kernel_drops": self.kernel_drops,
            "blacklist_hits": self.blacklist_hits,
            "kernel_passes": self.kernel_passes,
            "escalated": self.escalated,
            "escalation_ratio": round(
                self.escalated / max(self.records_in, 1), 6),
            # currently live entries, not all-time-ever-blocked
            "blocked_sources": sum(
                1 for u in self._blocked.values() if u > self._last_ts),
        }
