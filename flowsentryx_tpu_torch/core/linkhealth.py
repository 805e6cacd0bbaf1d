"""What a healthy benchmark window is, for the card's host link.

The port's counterpart of ``flowsentryx_tpu/core/linkhealth.py``: one
source of truth for the thresholds that ``scripts/torch_link_probe.py``
applies to label its own line and that ``fsx bench`` records in
``healthy_link_criteria``, so a run's recorded criteria are the ones
that gated it.  The rule is the reference's; the numbers are the card's.

Derivation: six probes in a row on a quiet NVIDIA H100 80GB HBM3 at a
700.00 W power limit (``nvidia-smi --query-gpu=name,power.limit``),
torch 2.11.0+cu128, each ``scripts/torch_link_probe.py --force-e2e``
(``scripts/torch_cluster_bench_phase.py --probes 6``: the fed loop ran
in every probe): the captured step 0.886-0.892 ms, one pinned 8 MB copy
22,184-33,304 MB/s, the copy-fed loop 18.32-18.44 M records/s, a trivial
launch 0.023-0.053 ms.  The thresholds keep a margin from the worst of
the six: the step at 1.5x its slowest (1.34 ms: a card capped below its
maximum power runs slower under load), H2D at half its least (11,000
MB/s; the fed loop runs from half that), the fed loop at 0.8x its
least (14.6 M records/s, 20 % headroom, as the reference keeps over its
go/no-go).  Every probe of those runs reads ``healthy``.

No torch import here: the bench's parent process and its tests read
these numbers without loading it.
"""

#: Max acceptable device-resident captured step time (ms, B=16,384, a
#: 2^16-row table).
HEALTHY_STEP_MS = 1.34
#: Min acceptable host -> card bandwidth of one 8 MB pinned copy (MB/s).
HEALTHY_H2D_MBPS = 11000.0
#: Go/no-go: min rate of the copy-fed step loop (M records/s).
HEALTHY_E2E_MPPS = 14.6


def classify(step_ms: float | None, h2d_mbps: float | None,
             e2e_mpps: float | None) -> str:
    """``healthy`` / ``degraded`` from probe measurements; the fed loop
    decides when present (it composes both axes)."""
    if e2e_mpps is not None:
        return "healthy" if e2e_mpps >= HEALTHY_E2E_MPPS else "degraded"
    if step_ms is None or h2d_mbps is None:
        return "degraded"
    ok = step_ms <= HEALTHY_STEP_MS and h2d_mbps >= HEALTHY_H2D_MBPS
    return "healthy" if ok else "degraded"


def criteria() -> dict:
    """The machine-readable block a bench line embeds."""
    return {
        "probe_e2e_mpps_min": HEALTHY_E2E_MPPS,
        "probe_step_ms_max": HEALTHY_STEP_MS,
        "h2d_mbps_min": HEALTHY_H2D_MBPS,
        "probe": "scripts/torch_link_probe.py (captured compact16 step, "
                 "copy-fed loop)",
    }
