"""The table of peaks the rooflines are counted against: NVIDIA's data
sheet figures, by the name ``torch.cuda.get_device_name`` gives."""

from __future__ import annotations

#: HBM bandwidth, bytes/s.  H100 SXM5 80 GB (HBM3): 3.35 TB/s.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(run) -> float | None:
    """The run's card's HBM bandwidth, or None off the card or for a card
    the table does not name."""
    if run.device_kind is None:
        return None
    return HBM_BYTES_PER_S.get(run.device_kind)
