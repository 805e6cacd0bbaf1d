"""The device-resident drain ring: R staged slots of C micro-batches each
in one dispatch.

Counterpart of ``flowsentryx_tpu/fused/device_loop.py``.  Every other
dispatch mode pushes ONE group to the device per host round trip; the
ring hands it a whole staging ring of arena slices.  One round::

    slots (R device buffers, uploaded one by one on a copy stream while
           the PREVIOUS round computes: the double-buffered H2D)
      └─ R slots of the megastep                (ops/fused.py)
           └─ C chunks of the fused step

carries the table and stats across all R*C batches and emits ONE merged
``[2K+4]`` verdict wire PER SLOT (:func:`~..ops.fused
.merge_verdict_wires`, the megastep's fold applied once per slot), so
the sink harvests a round as one ``[R, 2K+4]`` buffer.

What changes from the reference, and why:

* **The loop.**  The reference's deep ``lax.scan`` over slots and chunks
  traces the step once.  Here the loop is plain torch over
  :func:`~..ops.fused.wrap_megastep`; on the card :class:`~..ops.graph
  .StepGraph` captures the R*C steps unrolled into one CUDA graph, whose
  replay is the round's one dispatch (a graph launch costs in proportion
  to its nodes: R*C steps of ~420).  A device-side loop over the slots
  (one captured slot body under a conditional ``while`` node) is not
  exposed by torch's graph API.
* **The slots.**  The reference passes R separately uploaded slot arrays
  and stacks them on the device.  The loop here takes them the same way
  (``*slots``); the captured round reads them from its static ``[R, C,
  B+1, words]`` input, which the engine fills by a device-side copy
  from each slot's upload buffer once that upload's event has fired.
* **In place**, as every step of the port: the table and stats are
  updated in place and returned.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from flowsentryx_tpu_torch.ops import fused


class RingOutput(NamedTuple):
    """One round's outputs.  ``wire`` is the round's whole steady-state
    readback, one merged verdict wire per slot; ``block_key`` and
    ``block_until`` exist as the overflow fallback (a slot whose merged
    wire overflowed makes the sink fetch the whole round's arrays)."""

    wire: Any         # [R, 2K+4] int32: one merged verdict wire per slot
    block_key: Any    # [R, C, B] int32 overflow fallback (stays on device)
    block_until: Any  # [R, C, B] f32
    verdict: Any      # [R, C, B] uint8 (parity and debugging)
    now: Any          # [] f32: the round's device clock, the max of its
    #                   slots' (each slot's rides its wire)


def ring_round_batches(ring_depth: int, n_chunks: int) -> int:
    """Micro-batches consumed by one round."""
    return int(ring_depth) * int(n_chunks)


def wrap_device_loop(base: Callable[..., tuple], ring_depth: int,
                     n_chunks: int):
    """``loop(table, stats, params, *slots) -> (table, stats,
    RingOutput)`` over exactly ``ring_depth`` slot arguments, each a
    ``[n_chunks, B+1, words]`` staged wire group, ``base`` the fused step.
    The ring and chunk guards and the per-slot wire fold live here once
    (the reference's ``wrap_megastep`` discipline)."""
    if ring_depth < 1:
        raise ValueError(f"ring_depth must be >= 1, got {ring_depth}")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    mega = fused.wrap_megastep(base, n_chunks)

    def loop(table, stats, params, *slots):
        if len(slots) != ring_depth:
            raise ValueError(
                f"device loop compiled for a {ring_depth}-slot ring, got "
                f"{len(slots)} slots (any other count would silently "
                "recompile)")
        for r, raws in enumerate(slots):
            if raws.shape[0] != n_chunks:
                raise ValueError(
                    f"device loop compiled for {n_chunks}-chunk slots, "
                    f"slot {r} is [{raws.shape[0]}, ...]")
        outs = [mega(table, stats, params, raws)[2] for raws in slots]
        return table, stats, RingOutput(
            wire=torch.stack([o.wire for o in outs]),
            block_key=torch.stack([o.block_key for o in outs]),
            block_until=torch.stack([o.block_until for o in outs]),
            verdict=torch.stack([o.verdict for o in outs]),
            now=torch.stack([o.now for o in outs]).max(),
        )

    return loop


def make_compact_device_loop(cfg, classify_batch, ring_depth: int,
                             n_chunks: int, **quant):
    """Single-device drain ring over the compact16 wire (``**quant``: the
    wire quantizer's kwargs).  The compact verdict wire is REQUIRED:
    without it every slot's readback would be the full ``[C, B]`` block
    arrays, and the ring would multiply the D2H traffic instead of
    amortizing it."""
    if cfg.batch.verdict_k < 1:
        raise ValueError(
            "the device loop needs the compact verdict wire "
            "(batch.verdict_k >= 1): its steady-state readback is one "
            "[ring, 2K+4] buffer per round")
    return wrap_device_loop(
        fused.make_compact_step(cfg, classify_batch, **quant),
        ring_depth, n_chunks)


def make_sharded_compact_device_loop(cfg, classify_batch, mesh,
                                     ring_depth: int, n_chunks: int,
                                     **quant):
    """The drain ring over the IP-hash-sharded compact16 step
    (:mod:`..parallel.step`): every chunk of every slot runs the whole
    owner-routed step, so a round equals its slots run as sequential
    sharded megasteps.  Needs the compact verdict wire, as the
    single-shard ring does."""
    from flowsentryx_tpu_torch.parallel import step as pstep

    if cfg.batch.verdict_k < 1:
        raise ValueError(
            "the device loop needs the compact verdict wire "
            "(batch.verdict_k >= 1): its steady-state readback is one "
            "[ring, 2K+4] buffer per round")
    return wrap_device_loop(
        pstep.make_sharded_compact_step(cfg, classify_batch, mesh, **quant),
        ring_depth, n_chunks)


# ---------------------------------------------------------------------------
# ring-depth autotuning (serve --device-loop auto)
# ---------------------------------------------------------------------------

def choose_ring_depth(measurements: list[dict],
                      knee_fraction: float = 0.9) -> tuple[int, dict]:
    """Pick a ring depth from short calibration-drain measurements: the
    policy half of ``--device-loop auto`` (the drive half is
    :func:`~..engine.engine.calibrate_ring_depth`).

    Each measurement is one candidate depth's
    ``EngineReport.dispatch["device_loop"]`` summary: ``{"ring",
    "overlap_fraction", "rounds", "ring_occupancy"}``.  The SHALLOWEST
    candidate whose ``overlap_fraction`` reaches ``knee_fraction`` of the
    best observed wins; candidates that never completed a full round
    (``rounds == 0``) measured nothing and are skipped.  With no round
    fired, or no overlap anywhere, the shallowest candidate is returned
    with the reason recorded (a shallow ring is the safe default, never
    a refusal)."""
    detail: dict = {"candidates": measurements,
                    "knee_fraction": knee_fraction}
    fired = [m for m in measurements if m.get("rounds", 0) >= 1]
    if not fired:
        depth = min(m["ring"] for m in measurements)
        detail["reason"] = ("no candidate completed a full round "
                            "during calibration; defaulting shallow")
        return depth, detail
    best = max(m.get("overlap_fraction", 0.0) for m in fired)
    detail["best_overlap"] = best
    if best <= 0.0:
        depth = min(m["ring"] for m in fired)
        detail["reason"] = "no H2D overlap measured at any depth"
        return depth, detail
    # non-empty by construction: the best candidate clears its own knee
    eligible = [m for m in fired
                if m.get("overlap_fraction", 0.0)
                >= min(knee_fraction, 1.0) * best]
    m = min(eligible, key=lambda m: m["ring"])
    detail["reason"] = (
        f"shallowest depth within {knee_fraction:.0%} of the "
        f"best measured overlap ({best})")
    return m["ring"], detail
