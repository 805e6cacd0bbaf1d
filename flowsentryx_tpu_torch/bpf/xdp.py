"""Driving a loaded fast path with crafted frames through
``BPF_PROG_TEST_RUN``: a deployment's maps, pins and counters, the
frame builders, and the kernel tier's band leg.

The port's own addition (the reference keeps these helpers in its
tests): ``chip_smoke.py``'s ``bpf_plane`` phase and the tests share
them.  :func:`ml_band_leg` runs young flows through an ``ml`` program
carrying a distilled model and reads, per scored packet, the band the
kernel chose (from the counters it moved) and the eight features it
scored (derived from the flow's ``fsx_flow_stats`` value exactly as the
kernel derives them, :func:`~flowsentryx_tpu_torch.engine.pcap
.derive_features`), so that the kernel's bands can be held to the
emulator's, the plan's and the card's on the same features.

Everything here makes ``bpf(2)`` calls: callers check
:func:`~.loader.bpf_available` first.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from flowsentryx_tpu_torch.bpf import loader, progs
from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.engine.pcap import derive_features

XDP_DROP, XDP_PASS = 1, 2
ZERO_KEY = struct.pack("<I", 0)
#: Small maps: a deployment-size LRU map preallocates ~100 MB of kernel
#: memory.
SMALL = progs.MapSizes(max_track_ips=1024, ring_bytes=1 << 14)

_FS_FMT = "<" + "".join({"u64": "Q", "u16": "H"}[t]
                        for _, t in wire.FLOW_STATS_FIELDS)
_FS_NAMES = [n for n, _ in wire.FLOW_STATS_FIELDS]
_ST_NAMES = [n for n, _ in wire.KERNEL_STATS_FIELDS]


def eth(proto: int = 0x0800) -> bytes:
    return b"\x02" * 6 + b"\x04" * 6 + struct.pack(">H", proto)


def ip4_pkt(saddr: int, proto: int = 17, dport: int = 53, plen: int = 100,
            tcp_flags: int = 0) -> bytes:
    """An Ethernet/IPv4 frame of ``plen`` bytes.  ``saddr`` is written
    little-endian, which is how the program's 32-bit load reads it, so
    its map key is ``struct.pack("<I", saddr)``."""
    hdr = bytes([0x45, 0]) + struct.pack(">H", plen - 14)
    hdr += b"\x00" * 4 + bytes([64, proto]) + b"\x00\x00"
    hdr += struct.pack("<I", saddr) + b"\x01\x02\x03\x04"
    if proto == 6:
        l4 = struct.pack(">HH", 1234, dport) + b"\x00" * 9 + \
            bytes([tcp_flags]) + b"\x00" * 6
    elif proto == 17:
        l4 = struct.pack(">HHHH", 1234, dport, plen - 34, 0)
    else:
        l4 = b"\x00" * 8
    pkt = eth() + hdr + l4
    return pkt + b"X" * max(0, plen - len(pkt))


def ip6_pkt(words: tuple[int, int, int, int], nexthdr: int = 17,
            dport: int = 443, plen: int = 120) -> bytes:
    """An Ethernet/IPv6 frame; ``words`` are the source's four 32-bit
    words as the program loads them (the exact v6 key is their
    little-endian bytes)."""
    hdr = b"\x60\x00\x00\x00" + struct.pack(">H", plen - 54) + \
        bytes([nexthdr, 64])
    hdr += b"".join(struct.pack("<I", w) for w in words) + b"\xaa" * 16
    l4 = struct.pack(">HHHH", 1234, dport, plen - 54, 0)
    pkt = eth(0x86DD) + hdr + l4
    return pkt + b"X" * max(0, plen - len(pkt))


def flow_key(saddr: int, dport: int) -> int:
    """The kernel's flow key: ``saddr ^ (network-order dport << 16)``."""
    return (saddr ^ (socket.htons(dport) << 16)) & 0xFFFFFFFF


class Deployment:
    """One program loaded through the kernel verifier with its own maps
    (:func:`~.progs.load`), optionally pinned under a bpffs directory
    the way ``fsxd --bpf --pin DIR`` pins them."""

    def __init__(self, sizes: progs.MapSizes = SMALL, compact: bool = False,
                 ml: bool = False):
        self.fd, self.maps = progs.load(sizes, compact=compact, ml=ml)
        self.pin_dir: str | None = None

    def push_config(self, cfg) -> None:
        """A config (``FsxConfig``) into the config map, and its rules."""
        self.maps["config_map"].update(ZERO_KEY, cfg.pack_kernel_config())
        for key, action in cfg.rule_entries():
            self.maps["rule_map"].update(struct.pack("<I", key),
                                         struct.pack("<Q", action))

    def push_model(self, blob: bytes) -> None:
        self.maps["ml_model_map"].update(ZERO_KEY, blob)

    def run(self, pkt: bytes) -> int:
        return loader.prog_test_run(self.fd, pkt)[0]

    def stats(self) -> dict[str, int]:
        tot = [0] * len(_ST_NAMES)
        fmt = f"<{len(_ST_NAMES)}Q"
        for v in self.maps["stats_map"].lookup_percpu(ZERO_KEY):
            for i, x in enumerate(struct.unpack(fmt, v)):
                tot[i] += x
        return dict(zip(_ST_NAMES, tot))

    def flow_stats(self, fkey: int) -> dict | None:
        raw = self.maps["flow_stats_map"].lookup(struct.pack("<I", fkey))
        if raw is None:
            return None
        size = struct.calcsize(_FS_FMT)
        return dict(zip(_FS_NAMES, struct.unpack(_FS_FMT, raw[:size])))

    def pin(self, pin_dir: str) -> None:
        """Pin every map as ``pin_dir/<name>`` (the directory is made
        here and must not exist)."""
        os.makedirs(pin_dir)
        self.pin_dir = pin_dir
        for name, m in self.maps.items():
            m.pin(f"{pin_dir}/{name}")

    def close(self) -> None:
        """Unpin (when pinned) and close every fd."""
        if self.pin_dir is not None:
            for name in self.maps:
                try:
                    os.unlink(f"{self.pin_dir}/{name}")
                except FileNotFoundError:
                    pass
            os.rmdir(self.pin_dir)
            self.pin_dir = None
        for m in self.maps.values():
            m.close()
        os.close(self.fd)


def bpffs_dir(tag: str) -> str | None:
    """A fresh per-process pin directory under ``/sys/fs/bpf`` (its path
    only; :meth:`Deployment.pin` makes it), or None when bpffs is not
    mounted there writable.  Nothing is mounted here."""
    root = "/sys/fs/bpf"
    if not (os.path.isdir(root) and os.access(root, os.W_OK)):
        return None
    return f"{root}/fsx_port_{tag}_{os.getpid()}"


def ml_band_leg(dep: Deployment, n_flows: int = 256, seed: int = 0,
                max_pkts: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Young flows through an ``ml`` deployment that carries a model:
    returns ``(feats [N, 8] u32, bands [N] u8)``, one row per scored
    packet, the band read from the counters the packet moved
    (``ml_pass`` PASS, ``ml_escalated`` ESCALATE, ``dropped_ml`` DROP)
    and the features derived from the flow's stats after it.  A flow
    stops at its DROP (its source is blacklisted from then on).  The
    limiter must be configured out of the way by the caller."""
    rng = np.random.default_rng(seed)
    feats, bands = [], []
    ports = np.array([22, 53, 80, 123, 443, 3389, 8080, 50000, 65535])
    for i in range(n_flows):
        saddr = 0x0A000000 + (seed << 16) + i
        if i % 8 == 7:
            # a paced flood: small equal UDP datagrams 4 ms apart, the
            # shape the shipped model drops once the flow has lasted
            dport, proto, base, jitter, gap_ns = 53, 17, 60, 0, 4_000_000
            n_pkts = max_pkts
        else:
            dport = int(rng.choice(ports))
            proto = 6 if rng.random() < 0.6 else 17
            base = int(rng.integers(60, 1500))
            jitter = 40 if rng.random() < 0.5 else 0
            gap_ns = 0
            n_pkts = int(rng.integers(1, max_pkts + 1))
        for _ in range(n_pkts):
            plen = int(np.clip(base + rng.integers(-jitter, jitter + 1),
                               60, 1500))
            if gap_ns:
                # spin, not sleep: the gaps' spread is an IAT feature
                until = time.monotonic_ns() + gap_ns
                while time.monotonic_ns() < until:
                    pass
            before = dep.stats()
            dep.run(ip4_pkt(saddr, proto=proto, dport=dport, plen=plen,
                            tcp_flags=0x02 if proto == 6 else 0))
            after = dep.stats()
            moved = {k: after[k] - before[k] for k in after}
            if moved["ml_pass"]:
                band = wire.ML_BAND_PASS
            elif moved["ml_escalated"]:
                band = wire.ML_BAND_ESCALATE
            elif moved["dropped_ml"]:
                band = wire.ML_BAND_DROP
            else:
                continue   # not scored (blacklisted or not yet due)
            feats.append(derive_features(dep.flow_stats(
                flow_key(saddr, dport))))
            bands.append(band)
            if band == wire.ML_BAND_DROP:
                break
    return (np.asarray(feats, np.uint64).astype(np.uint32).reshape(-1, 8),
            np.asarray(bands, np.uint8))
