"""The process mesh's leader and followers.

On a process mesh (:mod:`.mesh`, one process per shard) rank 0 is the
leader: it runs the whole engine (ingest, staging, sink, reports,
health), and each follower holds one shard and does its part of every
step.  The reference places each wire batch replicated on every device
(``flowsentryx_tpu/engine/engine.py:338-348``); here the leader
broadcasts it.  Every exchange between them is a small header, four
int64 words ``(op, seq, a, b)`` broadcast from the leader, then the op's
collectives, which every rank makes in the same order:

* ``STEP``: the batch is broadcast, and every rank runs the process step
  (:func:`~.step.make_process_step`) on its shard;
* ``CAPTURE``: every rank captures its step as one CUDA graph (NCCL on
  the card; under gloo the exchanges are host calls and the step runs
  eagerly);
* ``REPORT``: ``table_summary`` over each rank's rows, folded;
* ``ROWS`` / ``LOAD``: the table gathered in the one table's row order
  (checkpoints, the digest), or scattered back (restore);
* ``BLOCKS``: the block records of one step gathered (a verdict wire
  that overflowed, or no wire);
* ``CHECK`` / ``COUNTS``: each rank's last step outputs and stats, or its
  kernel launch counts, gathered (the tests' and the card phase's
  comparisons);
* ``PING``: nothing (the idle leader's keepalive); ``STOP``: the
  follower returns.

A follower runs :func:`serve` until ``STOP``; each wait for a header is
bounded by the group's timeout, so a dead leader makes it raise.  Its
process runs ``python -m flowsentryx_tpu_torch.parallel.follower SPEC``
(:mod:`.launch` spawns it) and imports only this package.
"""

from __future__ import annotations

import json
import struct
import sys
import time
from collections import OrderedDict

import torch
import torch.distributed as dist

from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.models.registry import batch_scorer
from flowsentryx_tpu_torch.ops import fused, kernels
from flowsentryx_tpu_torch.parallel import exchange, layout
from flowsentryx_tpu_torch.parallel import step as pstep
from flowsentryx_tpu_torch.sync import tuning

(OP_PING, OP_STEP, OP_CAPTURE, OP_REPORT, OP_ROWS, OP_LOAD, OP_BLOCKS,
 OP_CHECK, OP_COUNTS, OP_STOP) = range(10)

#: Words of a header: ``(op, seq, a, b)``.
HEADER_WORDS = 4


def _f64_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def _f64(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(bits)))[0]


def process_steps(cfg, classify, mesh, wire: str, quant: dict):
    """The process step over ``wire`` (compact16 with ``quant``, or
    raw48), as the engine and every follower build it."""
    if wire == schema.WIRE_COMPACT16:
        return pstep.make_process_compact_step(cfg, classify, mesh, **quant)
    return pstep.make_process_raw_step(cfg, classify, mesh)


def fold_blocks(parts: list[torch.Tensor]) -> torch.Tensor:
    """The ranks' block records of one step (each its owner's ``[n*C]``
    keys and untils, then the clock and the route drops) as the
    one-process step's record: every owner's keys, every owner's untils,
    the clock, the route drops."""
    rows = (parts[0].shape[0] - 2) // 2
    return torch.cat([p[:rows] for p in parts]
                     + [p[rows:2 * rows] for p in parts] + [parts[0][-2:]])


def _digest(out, stats) -> torch.Tensor:
    """One rank's last step outputs and its stats as one flat int32
    buffer (:meth:`Leader.check` splits it)."""
    parts = [out.verdict.to(torch.int32),
             out.block_key.to(torch.int32),
             out.block_until.view(torch.int32),
             out.now.reshape(1).view(torch.int32),
             out.route_drop.reshape(1).to(torch.int32)]
    if out.wire is not None:
        parts.append(out.wire)
    parts.append(torch.stack(list(stats)).view(torch.int32))
    return torch.cat([p.reshape(-1).to(out.now.device) for p in parts])


def split_digest(d, b_local: int, rows: int, k: int) -> dict:
    """:func:`_digest`'s buffer (numpy int32) as named parts."""
    o = 0
    out = {}
    for name, n in (("verdict", b_local), ("block_key", rows),
                    ("block_until", rows), ("now", 1), ("route_drop", 1),
                    ("wire", 2 * k + 4 if k else 0),
                    ("stats", 2 * len(schema.GlobalStats._fields))):
        out[name] = d[o:o + n]
        o += n
    out["stats"] = dict(zip(schema.GlobalStats._fields,
                            out["stats"].view("<i8").tolist()))
    return out


class StepTimer:
    """Event time of this rank's steps on the card: a pair of timing
    events around each, so host launch gaps inside a step count (read
    at :meth:`event_ms`, which waits for them); steps counted on any
    device."""

    def __init__(self):
        self.pairs: list = []
        self.steps = 0

    def around(self, fn, on: torch.Tensor):
        """``fn()``, timed on the card when ``on`` lies there."""
        if on.device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            self.pairs.append((e0, e1))
        else:
            out = fn()
        self.steps += 1
        return out

    def wrap(self, step):
        """``step`` (the engine's) timed per call."""
        def timed(table, stats, params, raw):
            return self.around(lambda: step(table, stats, params, raw),
                               table.key_rows)
        return timed

    def event_ms(self) -> float:
        for _, e1 in self.pairs[-1:]:
            e1.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in self.pairs)

    def reset(self) -> None:
        self.pairs, self.steps = [], 0


class Shard:
    """One rank's serving state on a process mesh, leader or follower:
    the process step over the boot message's wire, this rank's table and
    stats, the params, and the last block records by step number."""

    def __init__(self, mesh, boot: dict):
        self.mesh = mesh
        self.cfg = cfg = boot["cfg"]
        dev = mesh.device
        self.params = type(boot["params"])(*(t.to(dev)
                                              for t in boot["params"]))
        classify, self.score_params = batch_scorer(cfg.model.name,
                                                   self.params)
        self.step = process_steps(cfg, classify, mesh, boot["wire"],
                                  boot["quant"])
        self.words = (schema.COMPACT_RECORD_WORDS
                      if boot["wire"] == schema.WIRE_COMPACT16
                      else schema.RECORD_WORDS)
        self.table = pstep.make_process_table(cfg, mesh)
        self.stats = schema.make_stats(dev)
        self.graph = None
        self.input = torch.zeros((cfg.batch.max_batch + 1, self.words),
                                 dtype=torch.int32)
        self.keep = boot["keep"]
        self.records: OrderedDict = OrderedDict()
        self.out = None
        self.timer = StepTimer()

    def capture(self) -> None:
        from flowsentryx_tpu_torch.ops.graph import StepGraph

        kernels.build_all()
        self.graph = StepGraph(self.step, self.table, self.stats,
                               self.params, tuple(self.input.shape))

    def run_step(self, seq: int) -> None:
        """The broadcast batch through this rank's step."""
        key = self.table.key_rows
        if self.graph is not None:
            exchange.broadcast(self.mesh, self.graph.input)
            self.timer.around(self.graph.replay, key)
            self.out = self.graph.out
            rec = self.graph.keep.clone()
        else:
            exchange.broadcast(self.mesh, self.input)
            x = self.input.to(self.mesh.device)
            _, _, self.out = self.timer.around(
                lambda: self.step(self.table, self.stats, self.params, x),
                key)
            rec = fused.block_record(self.out)
        self.records[seq] = rec
        while len(self.records) > self.keep:
            self.records.popitem(last=False)

    def handle(self, op: int, seq: int, a: int, b: int) -> None:
        """One header's op on a follower (the leader's side is
        :class:`Leader`)."""
        mesh = self.mesh
        if op == OP_STEP:
            self.run_step(seq)
        elif op == OP_CAPTURE:
            self.capture()
        elif op == OP_REPORT:
            kernels.table_summary(self.table, _f64(a), _f64(b), mesh=mesh)
        elif op == OP_ROWS:
            layout.gather_rows(self.table, mesh)
        elif op == OP_LOAD:
            load_rows(mesh, self.table, self.stats, None)
        elif op == OP_BLOCKS:
            exchange.gather(mesh, self.records[seq])
        elif op == OP_CHECK:
            exchange.gather(mesh, _digest(self.out, self.stats))
        elif op == OP_COUNTS:
            rank_counts(mesh, self.timer, reset=bool(a))
        elif op != OP_PING:
            raise ValueError(f"follower: unknown op {op}")


def load_rows(mesh, table, stats, whole) -> None:
    """Restore's scatter: the leader's whole table (``whole``: ``[N]``
    int32 keys, ``[N, 12]`` f32 state, and the stats as ``[6]`` int64;
    None on a follower, whose buffers the broadcast fills) into every
    rank's own row range, in place, park rows reset."""
    n_rows = table.key.shape[0] * mesh.size
    if whole is None:
        whole = (torch.zeros(n_rows, dtype=torch.int32),
                 torch.zeros(n_rows, schema.NUM_TABLE_COLS,
                             dtype=torch.float32),
                 torch.zeros(len(stats), dtype=torch.int64))
    key, state, counters = (exchange.broadcast(mesh, t) for t in whole)
    table.key.copy_(layout.rank_rows(key, mesh.rank, mesh.size))
    table.state.copy_(layout.rank_rows(state, mesh.rank, mesh.size))
    table.key_rows[-1:].zero_()
    table.state_rows[-1:].zero_()
    for field, v in zip(stats, counters.tolist()):
        field.fill_(v)


def rank_counts(mesh, timer: StepTimer | None,
                reset: bool = False) -> list[dict]:
    """Every rank's counters, in rank order: its kernel launches
    (``kernels.LAUNCHES``), its steps and their event ms (``timer``;
    the leader's is the caller's, or none), and its exchange calls and
    their host ms (``exchange.TIMES``).  ``reset`` zeroes them all after
    the read."""
    names = list(kernels.LAUNCHES)
    keys = names + ["steps", "step_event_ms", "exchange_calls",
                    "exchange_host_ms"]
    mine = torch.tensor(
        [kernels.LAUNCHES[k] for k in names]
        + ([timer.steps, timer.event_ms()] if timer else [0, 0.0])
        + [exchange.TIMES["calls"], exchange.TIMES["host_s"] * 1e3],
        dtype=torch.float64)
    if reset:
        for k in names:
            kernels.LAUNCHES[k] = 0
        if timer:
            timer.reset()
        exchange.reset_times()
    out = []
    for part in exchange.gather(mesh, mine.to(mesh.device)):
        d = dict(zip(keys, part.tolist()))
        out.append({k: v if k.endswith("_ms") else int(v)
                    for k, v in d.items()})
    return out


class Leader:
    """Rank 0's side of the protocol: each call sends its header, then
    makes the op's collectives beside the followers.  ``boot`` is the
    message every follower builds its :class:`Shard` from (config,
    params, wire, quantizer, records kept); it is sent here."""

    def __init__(self, mesh, boot: dict):
        self.mesh = mesh
        self._hdr = torch.zeros(HEADER_WORDS, dtype=torch.int64)
        self._seq = 0
        self._last = time.monotonic()
        dist.broadcast_object_list([boot], 0, group=mesh.group)
        self.stopped = False

    def _send(self, op: int, seq: int = 0, a: int = 0, b: int = 0) -> None:
        self._hdr.copy_(torch.tensor([op, seq, a, b]))
        exchange.broadcast(self.mesh, self._hdr)
        self._last = time.monotonic()

    def _next_step(self) -> int:
        seq = self._seq
        self._seq += 1
        self._send(OP_STEP, seq)
        return seq

    def step(self, x: torch.Tensor) -> int:
        """Send one batch (``x``: the leader's step input); its step
        number."""
        seq = self._next_step()
        exchange.broadcast(self.mesh, x)
        return seq

    def step_shard(self, shard: Shard, x: torch.Tensor) -> int:
        """One step of the leader's own :class:`Shard` (rather than an
        engine's step): ``x`` into its input, then the step on every
        rank, captured or eager as the shard is.  Its step number."""
        seq = self._next_step()
        (shard.graph.input if shard.graph is not None
         else shard.input).copy_(x)
        shard.run_step(seq)
        return seq

    def capture(self, shard: Shard | None = None) -> None:
        """Every follower captures its step; with ``shard``, the
        leader's own too."""
        self._send(OP_CAPTURE)
        if shard is not None:
            shard.capture()

    def report(self, table, now: float, stale_s: float) -> dict:
        self._send(OP_REPORT, 0, _f64_bits(now), _f64_bits(stale_s))
        return kernels.table_summary(table, now, stale_s, mesh=self.mesh)

    def rows(self, table):
        """The whole table's ``(key, state)`` in the one table's order."""
        self._send(OP_ROWS)
        return layout.gather_rows(table, self.mesh)

    def load(self, table, stats, key, state, counters) -> None:
        """Scatter a whole table and the stats over the ranks."""
        self._send(OP_LOAD)
        load_rows(self.mesh, table, stats, (
            torch.from_numpy(key.view("<i4")).contiguous(),
            torch.from_numpy(state).contiguous(),
            torch.tensor(counters, dtype=torch.int64)))

    def blocks(self, seq: int, own: torch.Tensor) -> torch.Tensor:
        """Step ``seq``'s block record over every owner (``own``: the
        leader's), in the one-process layout."""
        self._send(OP_BLOCKS, seq)
        return fold_blocks(exchange.gather(self.mesh, own))

    def check(self, out, stats) -> list:
        """Every rank's last step outputs and stats (numpy int32 digests,
        :func:`split_digest`)."""
        self._send(OP_CHECK)
        return [p.cpu().numpy() for p in
                exchange.gather(self.mesh, _digest(out, stats))]

    def counts(self, reset: bool = False,
               timer: StepTimer | None = None) -> list[dict]:
        """:func:`rank_counts` (``timer``: the leader's step timer)."""
        self._send(OP_COUNTS, 0, int(reset))
        return rank_counts(self.mesh, timer, reset)

    def keepalive(self) -> None:
        """A header when the link has been quiet for ``MESH_PING_S``."""
        if time.monotonic() - self._last > tuning.MESH_PING_S:
            self._send(OP_PING)

    def stop(self) -> None:
        if not self.stopped:
            self.stopped = True
            self._send(OP_STOP)


def serve(mesh) -> None:
    """A follower's loop: the leader's boot message, then one header
    and its op at a time until ``STOP``.  Each header wait is bounded by
    the group's timeout (a dead leader raises)."""
    boot = [None]
    dist.broadcast_object_list(boot, 0, group=mesh.group)
    shard = Shard(mesh, boot[0])
    hdr = torch.zeros(HEADER_WORDS, dtype=torch.int64)
    while True:
        op, seq, a, b = exchange.broadcast(mesh, hdr).tolist()
        if op == OP_STOP:
            return
        shard.handle(op, seq, a, b)


def _die_with_parent() -> None:
    """SIGKILL this process when the leader's process exits (Linux
    ``PR_SET_PDEATHSIG``): a leader that exits takes its followers."""
    import ctypes
    import signal

    try:
        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))
    except (OSError, AttributeError):
        pass   # not Linux: the group's timeout still ends the follower


def main(argv=None) -> int:
    """A follower process: ``SPEC`` is the JSON of :mod:`.launch`
    (``address``, ``world``, ``rank``, ``device``, ``backend``,
    ``timeout_s``, ``threads``)."""
    from flowsentryx_tpu_torch.parallel import mesh as pmesh

    spec = json.loads((sys.argv[1:] if argv is None else argv)[0])
    _die_with_parent()
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    pmesh.init_distributed(spec["address"], spec["world"], spec["rank"],
                           backend=spec["backend"], device=spec["device"],
                           timeout_s=spec["timeout_s"])
    try:
        serve(pmesh.make_mesh())
    finally:
        pmesh.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
