"""Replay what a window served through the plain reference, and compare.

The benchmark hands the reference what it hands the program: the record
pool it made from the seed, and which records went into which batch, in
the order the engine dispatched them (learned from outside the program:
the sealed batches the ingest object handed over, or the records each
reaped dispatch held).  The reference encodes each batch itself, runs
:class:`~.step.ReferenceFilter`, and the comparison holds the program's
counters, blocks and table to it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.step import (
    INVALID_KEY, STAT_NAMES, ReferenceFilter, length_units, quantize_inputs,
)

#: Every number compared is a count of disagreements: exact, limit 0.
LIMITS = {"counters_off": 0, "blocks_off": 0, "table_rows_off": 0}


class PoolInputs:
    """The pool's records as the reference reads them, on ``device``:
    sources, input codes and 8-byte length units (the pool's own
    timestamps are not used: each traffic mode stamps its records)."""

    def __init__(self, pool: np.ndarray, weights: dict, device):
        d = torch.device(device)
        self.saddr = torch.from_numpy(
            pool["saddr"].astype(np.int64)).to(d)
        self.q8 = torch.from_numpy(quantize_inputs(pool["feat"], weights)).to(d)
        self.len8 = torch.from_numpy(length_units(pool["pkt_len"])).to(d)


def replay(ref: ReferenceFilter, inputs: PoolInputs, batches, t0_ns: int,
           max_batch: int, n_batches: int, n_records: int):
    """Run ``batches`` — ``(pool indices, int64 ns timestamps)`` pairs of
    device tensors, at most ``max_batch`` records each, in dispatch order
    — through ``ref``.  On the card the step is one CUDA graph, captured
    once at ``max_batch`` lanes (a shorter batch masks the rest).
    Returns ``(block keys u32, block expiries f32, sources per batch)``
    on the host, the blocks in order."""
    dev = ref.dev
    ref.bind(inputs.saddr, inputs.q8, inputs.len8)
    p_s = torch.zeros(max_batch, dtype=torch.int64, device=dev)
    ts_s = torch.zeros(max_batch, dtype=torch.int64, device=dev)
    n_s = torch.zeros((), dtype=torch.int64, device=dev)
    keys = torch.full((n_records,), INVALID_KEY, dtype=torch.int64,
                      device=dev)
    untils = torch.zeros(n_records, dtype=torch.float32, device=dev)
    srcs = torch.zeros(n_batches, dtype=torch.int64, device=dev)
    def step():
        return ref.step(p_s, ts_s, n_s, t0_ns)

    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()                      # every lane masked: changes nothing
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()

        def step():   # noqa: F811 — the captured step
            graph.replay()
            return out
    off = 0
    for j, (p, ts) in enumerate(batches):
        n = p.shape[0]
        p_s[:n].copy_(p)
        ts_s[:n].copy_(ts)
        n_s.fill_(n)
        k, u, ns = step()
        keys[off:off + n].copy_(k[:n])
        untils[off:off + n].copy_(u[:n])
        srcs[j].copy_(ns)
        off += n
    keep = keys != INVALID_KEY
    return (keys[keep].cpu().numpy().astype(np.uint32),
            untils[keep].cpu().numpy().astype(np.float32),
            srcs.cpu().numpy())


def compare(program: dict, reference: dict) -> dict:
    """``{check: {"value": disagreements, "limit": 0}}`` of the
    program's outputs against the reference's: the counters, the blocks
    in order (source and expiry bits), and the table's rows (key and
    every state bit)."""
    off = sum(abs(int(program["counters"][k]) - int(reference["counters"][k]))
              for k in STAT_NAMES)
    pk, pu = program["blocks"]
    rk, ru = reference["blocks"]
    m = min(len(pk), len(rk))
    blocks = (abs(len(pk) - len(rk))
              + int(np.count_nonzero((pk[:m] != rk[:m])
                                     | (pu[:m].view(np.uint32)
                                        != ru[:m].view(np.uint32)))))
    tk, ts = program["table"]
    qk, qs = reference["table"]
    if tk.shape != qk.shape:
        rows = max(len(tk), len(qk))
    else:
        rows = int(np.count_nonzero(
            (tk != qk)
            | (ts.view(np.uint32) != qs.view(np.uint32)).any(axis=1)))
    vals = {"counters_off": off, "blocks_off": blocks,
            "table_rows_off": rows}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in vals.items()}
