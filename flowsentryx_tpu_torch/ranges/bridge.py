"""The cross-lane interval-containment proof: BPF verifier ⊇ served lane.

Counterpart of ``flowsentryx_tpu/ranges/bridge.py``.  The distilled
kernel scorer (``bpf/progs.py fn_ml_score``) and the served int8 lane
(:func:`~flowsentryx_tpu_torch.models.logreg.classify_batch_int8_matmul`,
whose accumulator the card's ``score_int8`` computes) compute the same
weighted rank sum.  ``fsx distill --emulate`` proves them equal
concretely (the bytecode emulator over a corpus); this module is the
static bridge: for a distill artifact,

* the BPF verifier's ``umin/umax`` at the scorer's MAC accumulate
  instructions and at the band-select exit (read through the
  observational probe API, :func:`~flowsentryx_tpu_torch.bpf.verifier
  .check_program` ``probes=``) must **contain**
* the served lane's accumulator interval (:func:`acc_interval`: the
  range prover over the lane's traced aten graph, the artifact's exact
  values seeding the parameter leaves), mapped into the kernel's
  raw-``Σ w·q`` domain (the zero point folded the way the distiller
  folds it) and into u64 two's complement.

A containment failure means one lane's emission or staging drifted —
the scorer packs registers differently, the lane's accumulator changed,
the verifier lost range precision where the proof needs it — caught
with no kernel and no execution, before the concrete emulator runs.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from flowsentryx_tpu_torch.core import wire as schema

U64 = (1 << 64) - 1


def locate_probe_sites(prog: Any) -> dict:
    """Find the MAC accumulates and the band-select exit in the
    assembled scorer (``bpf/progs.build_ml_scorer``) by instruction
    pattern, not by hard-coded offsets — re-emission may shift
    indices, never shapes:

    * MAC: ``r6 += r4`` (ALU64 ADD X, dst=6, src=4) — one per feature;
      probed one slot later, where r6 holds the partial sum.
    * band: the ``exit`` directly following ``r0 -= r1`` (the
      branch-free band-select tail); probed at the exit, where r0
      holds the band code.
    """
    from flowsentryx_tpu_torch.bpf import isa

    mac_after: list[int] = []
    band_exit = None
    add_r6 = isa.BPF_ALU64 | isa.BPF_ADD | isa.BPF_X
    sub_r0 = isa.BPF_ALU64 | isa.BPF_SUB | isa.BPF_X
    exit_op = isa.BPF_JMP | isa.BPF_EXIT
    for i, ins in enumerate(prog.insns):
        if ins.op == add_r6 and ins.dst == 6 and ins.src == 4:
            mac_after.append(i + 1)
        if (ins.op == exit_op and i > 0
                and prog.insns[i - 1].op == sub_r0
                and prog.insns[i - 1].dst == 0):
            band_exit = i
    if len(mac_after) != schema.NUM_FEATURES or band_exit is None:
        raise ValueError(
            f"fn_ml_score shape drift: found {len(mac_after)} MAC "
            f"accumulates (want {schema.NUM_FEATURES}) and band exit "
            f"{band_exit} — the containment bridge's instruction "
            "patterns no longer match the emitted scorer")
    return {"mac_after": mac_after, "band_exit": band_exit}


def _twos_complement_segments(lo: int, hi: int) -> list[tuple]:
    """A signed interval as u64 two's-complement segment(s)."""
    if lo >= 0:
        return [(lo, hi)]
    if hi < 0:
        return [(lo + (1 << 64), hi + (1 << 64))]
    return [(0, hi), (lo + (1 << 64), U64)]


def _contained(lo: int, hi: int, umin: int, umax: int) -> bool:
    return all(umin <= s0 and s1 <= umax
               for s0, s1 in _twos_complement_segments(lo, hi))


def acc_interval(params: Any) -> tuple:
    """The served int8 lane's accumulator interval, derived from its
    traced aten graph by the range prover: the artifact's exact values
    seed the parameter leaves and the features are unconstrained floats.
    The accumulator is the ``sum`` that
    :func:`~flowsentryx_tpu_torch.models.logreg.int8_acc` lowers to
    (``Σ w·(q - zp)`` in int32, the zero-point-folded domain), traced at
    one row so that each feature keeps its own weight's interval.
    Returns ``(lo, hi)``."""
    import torch

    from flowsentryx_tpu_torch.audit import graph
    from flowsentryx_tpu_torch.models import logreg
    from flowsentryx_tpu_torch.ranges import interval as iv
    from flowsentryx_tpu_torch.ranges import prover

    params = type(params)(*(t.detach().cpu() for t in params))
    x = torch.zeros((1, schema.NUM_FEATURES), dtype=torch.float32)
    trace, _ = graph.trace_call(logreg.classify_batch_int8_matmul,
                                (params, x), ("params",), ("out",))
    seeds = {f"params.{k}": iv.const_of(getattr(params, k).numpy())
             for k in params._fields}
    seeds["raw"] = iv.float_top()
    an = prover.analyze(
        trace, seeds,
        collect=lambda n: ("acc" if n.op.startswith("aten.sum")
                           and n.frames and n.frames[0][1] == "int8_acc"
                           else None))
    if an.findings:
        raise ValueError(
            "range prover found escapes in the int8 classifier lane: "
            + "; ".join(str(f) for f in an.findings))
    if "acc" not in an.collected:
        raise ValueError("no sum in int8_acc's traced graph — the "
                         "lane's accumulator changed form; retarget the "
                         "bridge's collect hook")
    lo, hi = an.collected["acc"]
    return int(lo), int(hi)


def closed_form_interval(params: Any) -> tuple:
    """The accumulator interval computed from the artifact alone: per
    feature the min and max of ``w_i·(q - zp)`` over ``q ∈ [0, 255]``,
    summed — what :func:`acc_interval` must equal."""
    w = np.asarray(params.w_int8.cpu(), np.int64)
    zp = int(params.in_zp)
    ends = np.stack([w * (0 - zp), w * (255 - zp)])
    return int(ends.min(axis=0).sum()), int(ends.max(axis=0).sum())


def containment_proof(params: Any, budget: int = 2_000_000,
                      prog: Any = None) -> dict:
    """Run both sides and check containment (module docstring).

    Returns the JSON-able proof record; ``ok`` is True iff the full
    kernel-domain accumulator interval is contained in the verifier's
    range at the FINAL MAC accumulate and the lane's band set {PASS,
    ESCALATE, DROP} is contained at the band-select exit.  ``prog``
    replaces the emitted scorer (a planted drift in the tests)."""
    import time

    t0 = time.perf_counter()
    from flowsentryx_tpu_torch.bpf import progs, verifier

    prog = prog if prog is not None else progs.build_ml_scorer()
    sites = locate_probe_sites(prog)
    probes = {i: 6 for i in sites["mac_after"]}
    probes[sites["band_exit"]] = 0
    # entry_main=False: fn_ml_score is a local-call target in the
    # shipped programs (r1-r4 carry the packed features as scalars)
    rep = verifier.check_program(prog, name="fsx_ml_scorer",
                                 budget=budget, probes=probes,
                                 entry_main=False)

    acc = acc_interval(params)
    w_sum = int(np.asarray(params.w_int8.cpu(), np.int64).sum())
    in_zp = int(params.in_zp)
    # kernel domain: s = Σ w·q = acc_jax + zp·Σw (the distiller's fold)
    acc_lo = acc[0] + in_zp * w_sum
    acc_hi = acc[1] + in_zp * w_sum

    final_mac = sites["mac_after"][-1]
    mac_probe = rep.probes.get(final_mac)
    band_probe = rep.probes.get(sites["band_exit"])
    mac_ok = (mac_probe is not None and mac_probe["hits"] > 0
              and _contained(acc_lo, acc_hi,
                             mac_probe["umin"], mac_probe["umax"]))
    bands = (int(schema.ML_BAND_PASS), int(schema.ML_BAND_DROP))
    band_ok = (band_probe is not None and band_probe["hits"] > 0
               and _contained(bands[0], bands[1],
                              band_probe["umin"], band_probe["umax"]))
    return {
        "ok": bool(mac_ok and band_ok),
        "acc_zp_folded": [acc[0], acc[1]],
        "closed_form": list(closed_form_interval(params)),
        "kernel_acc": [acc_lo, acc_hi],
        "lane_bands": list(bands),
        "mac_sites": sites["mac_after"],
        "band_exit": sites["band_exit"],
        "bpf_final_mac": mac_probe,
        "bpf_band": band_probe,
        "bpf_mac_all": {str(i): rep.probes.get(i)
                        for i in sites["mac_after"]},
        "mac_contained": bool(mac_ok),
        "band_contained": bool(band_ok),
        "seconds": round(time.perf_counter() - t0, 3),
    }
