"""Open loop into the engine's inline batcher: the online deployment
under load that independent senders offer.

Record ``i`` of the window is due at ``t_start + (i + 1) / rate`` (the
benchmark's copy of the program's ``PacedSource``), whether or not the
engine keeps up; the window offers exactly ``rate * seconds`` records
and runs until every one of them is verdicted.  A record's latency is
the time its batch was reaped (the engine's reap hook) less the time it
was due.  The engine runs with ``fsx serve``'s defaults: one batch a
dispatch, the sink thread where the host has cores for it.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.traffic.paced import PacedSource
from benchmark.traffic.pool import make_pool

#: Seconds past the window a run may take to verdict what was due in it.
DRAIN_GRACE_S = 60.0


class Mode:
    def __init__(self, run):
        self.run = run
        p = run.workload["params"]
        self.rate = float(p["rate_pps"])
        self.pool_records = int(p["pool_records"])
        self.mega_n = p.get("mega_n", 0)
        self.total = int(round(self.rate * run.seconds))
        self.ns: list[int] = []
        self.lat: list[np.ndarray] = []
        self.engine = None

    def setup(self) -> None:
        from flowsentryx_tpu_torch.engine import Engine

        run = self.run
        pool = make_pool(run.config["traffic"], run.seed, self.pool_records)
        self.pool = pool
        self.src = PacedSource(pool, self.rate, self.total)
        self.engine = Engine(run.fsx, self.src, run.sink, params=run.params,
                             device=run.device, mega_n=self.mega_n,
                             compile_cache=run.compile_cache)
        self.engine.warm()

        def reaped(n, t):
            self.ns.append(n)
            self.lat.append(t - self.src.pop_scheduled(n))
        self.engine.on_reap = reaped

    def serve(self, seconds: float, last: bool):
        if last:
            # the rest of the schedule, and whatever is still due
            left = self.run.seconds
            if self.src.t_start is not None:
                left -= time.perf_counter() - self.src.t_start
            seconds = max(left, 0.0) + DRAIN_GRACE_S
        return self.engine.run(max_seconds=seconds)

    def mark(self) -> int:
        return len(self.ns)

    def finish(self) -> None:
        pass

    @property
    def attempted(self) -> int:
        return self.total

    @property
    def verdicted(self) -> int:
        return int(sum(self.ns))

    def lost(self) -> int:
        return self.total - self.verdicted

    def reference_pool(self) -> np.ndarray:
        return self.pool

    def summary(self) -> dict:
        """The rate offered, and percentiles of the latency over the
        records verdicted, in ms."""
        lat = (np.concatenate(self.lat) if self.lat else np.zeros(1)) * 1e3
        q = np.percentile(lat, (50, 90, 95, 99, 99.9))
        return {"rate_pps": self.rate, "max_ms": float(lat.max()),
                **{f"p{k}_ms": float(v)
                   for k, v in zip(("50", "90", "95", "99", "999"), q)}}

    def latencies_s(self) -> np.ndarray:
        """Due -> reaped of every due record; one never verdicted counts
        as infinitely late."""
        got = (np.concatenate(self.lat) if self.lat
               else np.zeros(0, np.float64))
        return np.concatenate([got, np.full(self.lost(), np.inf)])

    def batches(self, pool: np.ndarray, device):
        """``(t0, batch sizes, iterator of (pool indices, ns
        timestamps))`` of every reaped batch in order: batch ``j`` holds
        the records after those of batches ``0..j-1``, stamped with their
        due times."""
        import torch

        d = torch.device(device)
        sched = PacedSource(pool, self.rate, self.total)
        k = np.arange(self.verdicted, dtype=np.int64)
        stamps = torch.from_numpy(np.round(sched._sched_rel_s(k) * 1e9)
                                  .astype(np.int64)).to(d)
        t0 = int(stamps[0]) if len(k) else 0
        n_pool = len(pool)

        def gen():
            k0 = 0
            for n in self.ns:
                p = torch.remainder(k0 + torch.arange(n, device=d), n_pool)
                yield p, stamps[k0:k0 + n]
                k0 += n
        return t0, list(self.ns), gen()
