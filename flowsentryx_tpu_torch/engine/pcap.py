"""pcap ingestion: capture files → flow records with streaming features.

Counterpart of ``flowsentryx_tpu/engine/pcap.py`` (a copy; numpy and the
standard library only), behind ``python -m flowsentryx_tpu_torch.cli
pcap``.

SURVEY.md §4/§7.2 name pcap replay (CICDDoS2019 ships as captures) as
the end-to-end test vehicle.  This module turns a classic-pcap file
into ``FLOW_RECORD_DTYPE`` arrays by running the SAME pipeline the
kernel runs per packet — parse (kern/parsing.h semantics: Eth →
IPv4/IPv6 fold → TCP/UDP/ICMP) and the streaming per-flow feature
estimators (kern/fsx_kern.c extract_features, integer arithmetic
mirrored exactly, including the emit gating) — so an offline replay
exercises byte-identical records to a live NIC run.

Pure stdlib + numpy; classic pcap only (both byte orders, µs and ns
timestamp variants).  pcapng is out of scope — `tcpdump -w` and
CICDDoS2019's captures are classic pcap.

Outputs feed three consumers:
* ``fsxd --replay FILE`` (raw ``fsx_flow_record`` structs),
* :class:`~flowsentryx_tpu_torch.engine.sources.ArraySource` → ``Engine``,
* the training pipeline (records → features/labels).
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Iterator

import numpy as np

from flowsentryx_tpu_torch.core import wire as schema

_MAGIC_US_LE = 0xA1B2C3D4
_MAGIC_NS_LE = 0xA1B23C4D

ETH_P_IP, ETH_P_IPV6 = 0x0800, 0x86DD
P_ICMP, P_TCP, P_UDP, P_ICMPV6 = 1, 6, 17, 58
TCP_SYN = 0x02


def read_pcap(path: str | Path) -> Iterator[tuple[int, bytes, int]]:
    """Yield ``(ts_ns, captured_bytes, original_len)`` per packet of a
    classic pcap.  ``original_len`` is the on-wire length — under a
    snaplen the captured bytes are a truncated prefix."""
    with open(path, "rb") as f:
        hdr = f.read(24)
        if len(hdr) < 24:
            raise ValueError(f"{path}: not a pcap (truncated header)")
        magic = struct.unpack("<I", hdr[:4])[0]
        if magic in (_MAGIC_US_LE, _MAGIC_NS_LE):
            endian = "<"
        elif struct.unpack(">I", hdr[:4])[0] in (_MAGIC_US_LE, _MAGIC_NS_LE):
            endian = ">"
            magic = struct.unpack(">I", hdr[:4])[0]
        else:
            raise ValueError(f"{path}: unknown pcap magic {hdr[:4]!r} "
                             "(pcapng is not supported; use classic pcap)")
        ts_scale = 1_000 if magic == _MAGIC_NS_LE else 1
        # header: magic, vmaj, vmin, thiszone, sigfigs, snaplen, linktype
        linktype = struct.unpack(endian + "I", hdr[20:24])[0]
        if linktype != 1:  # LINKTYPE_ETHERNET
            raise ValueError(f"{path}: linktype {linktype} != ethernet")
        rec = struct.Struct(endian + "IIII")
        while True:
            rh = f.read(16)
            if len(rh) < 16:
                return
            ts_s, ts_frac, incl, orig = rec.unpack(rh)
            data = f.read(incl)
            if len(data) < incl:
                return
            # µs-format fraction scales ×1000 to ns; ns-format ×1
            yield ts_s * 1_000_000_000 + ts_frac * (
                1_000 if ts_scale == 1 else 1
            ), data, orig


def parse_frame(data: bytes) -> tuple[int, int, int, int, int] | None:
    """(saddr_fold, dport, l4_proto, flags, pkt_len) — kern/parsing.h
    semantics — or None for non-IP / truncated frames."""
    if len(data) < 14:
        return None
    eth_proto = (data[12] << 8) | data[13]
    flags = 0
    if eth_proto == ETH_P_IP:
        if len(data) < 34:
            return None
        ihl = (data[14] & 0x0F) * 4
        if ihl < 20 or len(data) < 14 + ihl:
            return None
        proto = data[23]
        # the kernel reads the wire saddr as a native LE u32 load
        saddr = struct.unpack("<I", data[26:30])[0]
        l4_off = 14 + ihl
    elif eth_proto == ETH_P_IPV6:
        if len(data) < 54:
            return None
        proto = data[20]
        w = struct.unpack("<4I", data[22:38])
        saddr = w[0] ^ w[1] ^ w[2] ^ w[3]  # fsx_fold_ip6
        l4_off = 54
        flags |= schema.FLAG_IPV6
        # bounded extension-header walk (kern/parsing.h twin): L4
        # classification must not be evadable via a hop-by-hop/routing/
        # dstopts prefix.  FRAGMENT (44) stops the walk — a non-first
        # fragment has no L4 header.
        for _ in range(4):  # FSX_IPV6_EXT_WALK_DEPTH
            if proto not in (0, 43, 60):
                break
            if len(data) < l4_off + 8:
                return None  # truncated ext header -> drop
            proto = data[l4_off]
            l4_off += (data[l4_off + 1] + 1) * 8
    else:
        return None

    dport = 0
    if proto == P_TCP:
        flags |= schema.FLAG_TCP
        if len(data) >= l4_off + 14:
            dport = (data[l4_off + 2] << 8) | data[l4_off + 3]
            if data[l4_off + 13] & TCP_SYN:
                flags |= schema.FLAG_TCP_SYN
    elif proto == P_UDP:
        flags |= schema.FLAG_UDP
        if len(data) >= l4_off + 4:
            dport = (data[l4_off + 2] << 8) | data[l4_off + 3]
    elif proto in (P_ICMP, P_ICMPV6):
        flags |= schema.FLAG_ICMP
    return saddr, dport, proto, flags, len(data)


class FlowTracker:
    """Python mirror of the kernel's per-flow streaming estimators
    (kern/fsx_kern.c extract_features — same integer arithmetic, same
    IAT clamp, same emit gating; cross-checked against the live kernel
    by tests/test_bpf.py's _derive_mirror)."""

    _IAT_CLAMP_US = 1 << 21

    def __init__(self, emit_all: bool = False):
        self.flows: dict[int, dict] = {}
        self.emit_all = emit_all

    def update(self, saddr: int, dport: int, ts_ns: int,
               pkt_len: int) -> list[int] | None:
        """Feed one packet; returns the 8 features when a record is due
        (every packet while the flow is young, then every 16th)."""
        fkey = (saddr ^ (((dport >> 8) | ((dport & 0xFF) << 8)) << 16)) \
            & 0xFFFFFFFF
        fs = self.flows.get(fkey)
        if fs is None:
            fs = dict(pkt_count=0, byte_sum=0, byte_sq_sum=0,
                      first_ts_ns=ts_ns, last_ts_ns=0, iat_sum_ns=0,
                      iat_sq_sum_us2=0, iat_max_ns=0, dst_port=dport)
            self.flows[fkey] = fs
        if fs["pkt_count"] > 0 and ts_ns > fs["last_ts_ns"]:
            iat = ts_ns - fs["last_ts_ns"]
            iat_us = min(iat // 1000, self._IAT_CLAMP_US)
            fs["iat_sum_ns"] += iat
            fs["iat_sq_sum_us2"] += iat_us * iat_us
            if iat > fs["iat_max_ns"]:
                fs["iat_max_ns"] = iat
        fs["pkt_count"] += 1
        fs["byte_sum"] += pkt_len
        fs["byte_sq_sum"] += pkt_len * pkt_len
        fs["last_ts_ns"] = ts_ns

        n = fs["pkt_count"]
        if not self.emit_all and n > 16 and (n & 15):
            return None
        return derive_features(fs)


def derive_features(fs: dict) -> list[int]:
    """The kernel's eight integer features of one flow from its
    ``fsx_flow_stats`` value (field names of
    ``wire.FLOW_STATS_FIELDS``), as ``extract_features`` derives them."""
    n = fs["pkt_count"]
    sat = lambda x: min(x, 0xFFFFFFFF)  # noqa: E731
    mean = fs["byte_sum"] // n
    var = max(fs["byte_sq_sum"] // n
              - (mean * mean & ((1 << 64) - 1)), 0)
    iat_n = max(n - 1, 1)
    iat_mean_us = (fs["iat_sum_ns"] // iat_n) // 1000
    # the kernel squares in u64 (wraps past 2^32 us means — ~71 min
    # idle gaps); mirror the wrap or long-idle flows diverge
    iat_mean_sq = (iat_mean_us * iat_mean_us) & ((1 << 64) - 1)
    iat_var = max(fs["iat_sq_sum_us2"] // iat_n - iat_mean_sq, 0)
    # flow-age slots 3/4 (schema.FEATURE_NAMES): duration in ms and
    # rate in pps*1000, same integer identities as the kernel
    dur_ns = fs["last_ts_ns"] - fs["first_ts_ns"]
    dur_us = dur_ns // 1000
    pps_x1000 = (n * 1_000_000_000) // dur_us if dur_us else 0
    return [
        fs["dst_port"], sat(mean), math.isqrt(var),
        sat(dur_ns // 1_000_000), sat(pps_x1000), sat(iat_mean_us),
        math.isqrt(iat_var),
        sat(min(fs["iat_max_ns"] // 1000, 0xFFFFFFFF)),
    ]


def pcap_to_records(path: str | Path, emit_all: bool = False,
                    limit: int | None = None,
                    tracker: FlowTracker | None = None) -> np.ndarray:
    """Convert a capture into a ``FLOW_RECORD_DTYPE`` array.

    Snaplen-truncated captures: byte features use the ORIGINAL on-wire
    length (what the NIC would have counted), headers parse from the
    captured prefix; frames whose headers were cut off are dropped with
    a warning (they cannot be attributed to a flow).  Pass a
    ``tracker`` to inspect per-flow state (e.g. flow counts) after."""
    import sys

    if tracker is None:
        tracker = FlowTracker(emit_all=emit_all)
    rows: list[tuple] = []
    dropped_truncated = 0
    for ts_ns, frame, orig in read_pcap(path):
        parsed = parse_frame(frame)
        if parsed is None:
            if orig > len(frame) and orig >= 14:
                dropped_truncated += 1  # headers cut off by snaplen
            continue
        saddr, dport, proto, flags, _caplen = parsed
        feat = tracker.update(saddr, dport, ts_ns, orig)
        if feat is None:
            continue
        rows.append((ts_ns, saddr, orig, proto, flags, feat))
        if limit is not None and len(rows) >= limit:
            break
    if dropped_truncated:
        print(
            f"fsx pcap: WARNING: {dropped_truncated} frames dropped — "
            "snaplen truncated their L3/L4 headers; recapture with a "
            "larger -s for complete flow attribution",
            file=sys.stderr,
        )
    out = np.zeros(len(rows), dtype=schema.FLOW_RECORD_DTYPE)
    for i, (ts_ns, saddr, plen, proto, flags, feat) in enumerate(rows):
        out[i] = (ts_ns, saddr, min(plen, 0xFFFF), proto, flags, feat)
    return out
