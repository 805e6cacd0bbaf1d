"""The port's pcap ingestion and ``cli pcap`` against the JAX package's.

Classic captures built here with ``struct`` (nothing downloaded): IPv4
UDP, TCP SYN and ICMP flows, IPv6 with extension-header chains and a
fragment, ARP, frames cut short by the snap length or inside their
headers, both byte orders and both timestamp units.
``pcap_to_records`` (gated and ``emit_all``, with a limit) and
``parse_frame`` (every prefix of every frame) are byte-equal across the
packages; ``cli pcap`` writes the reference's record file and summary,
and ``serve --records`` on the CPU gives the reference engine's stats.
"""

import json
import struct

import numpy as np
import pytest

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine import pcap as jpcap
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import wire
from flowsentryx_tpu_torch.engine import pcap


def eth(proto=0x0800):
    return b"\x02" * 6 + b"\x04" * 6 + struct.pack(">H", proto)


def ip4(saddr, proto, l4, plen):
    hdr = bytes([0x45, 0]) + struct.pack(">H", plen - 14) + b"\x00" * 4
    hdr += bytes([64, proto]) + b"\x00\x00" + struct.pack("<I", saddr)
    hdr += b"\x01\x02\x03\x04"
    p = eth() + hdr + l4
    return p + b"X" * max(0, plen - len(p))


def udp4(saddr, dport=53, plen=100):
    return ip4(saddr, 17, struct.pack(">HHHH", 1234, dport, plen - 34, 0),
               plen)


def syn4(saddr, dport=80, plen=74):
    return ip4(saddr, 6, struct.pack(">HH", 1234, dport) + b"\x00" * 9
               + b"\x02" + b"\x00" * 6, plen)


def icmp4(saddr, plen=98):
    return ip4(saddr, 1, b"\x08\x00" + b"\x00" * 6, plen)


def v6(words, first, body, plen):
    hdr = b"\x60\x00\x00\x00" + struct.pack(">H", plen - 54) + bytes(
        [first, 64])
    hdr += b"".join(struct.pack("<I", w) for w in words) + b"\xaa" * 16
    p = eth(0x86DD) + hdr + body
    return p + b"X" * max(0, plen - len(p))


def udp6(words, dport=443, plen=120):
    return v6(words, 17, struct.pack(">HHHH", 1234, dport, plen - 54, 0),
              plen)


def tcp6_ext(words, chain=((0, 0), (43, 1)), dport=443, plen=160):
    """A v6 TCP SYN behind a chain of ``(proto, hdr_ext_len)`` headers."""
    body = b""
    for i, (_, elen) in enumerate(chain):
        nxt = chain[i + 1][0] if i + 1 < len(chain) else 6
        body += bytes([nxt, elen]) + b"\x00" * ((elen + 1) * 8 - 2)
    body += struct.pack(">HH", 1234, dport) + b"\x00" * 9 + b"\x02" \
        + b"\x00" * 6
    return v6(words, chain[0][0] if chain else 6, body, plen)


def frames(seed=4, n=600):
    """A mixed capture: a few flows of every kind, interleaved."""
    rng = np.random.default_rng(seed)
    kinds = [
        lambda i: udp4(0x0A000000 + int(rng.integers(0, 12)),
                       plen=int(rng.integers(60, 1500))),
        lambda i: syn4(0x0B000000 + int(rng.integers(0, 6)),
                       dport=int(rng.integers(1, 1 << 16))),
        lambda i: icmp4(0x0C000000 + int(rng.integers(0, 3))),
        lambda i: udp6(tuple(int(w) for w in rng.integers(0, 1 << 32, 4)),
                       plen=int(rng.integers(80, 1400))),
        lambda i: tcp6_ext((5, 6, 7, int(rng.integers(0, 4)))),
        lambda i: tcp6_ext((9, 9, 9, 9), chain=((44, 0),)),   # fragment
        lambda i: tcp6_ext((1, 2, 3, 4), chain=((0, 0), (60, 2), (43, 0))),
        lambda i: eth(0x0806) + b"\x00" * 28,                  # ARP
    ]
    return [kinds[int(rng.integers(0, len(kinds)))](i) for i in range(n)]


def write_pcap(path, frs, *, endian="<", nanos=False, snap=65535,
               dt_us=37, cut=()):
    """Classic pcap; frames whose index is in ``cut`` are captured to 20
    bytes (headers cut off), every frame to at most ``snap``."""
    magic = 0xA1B23C4D if nanos else 0xA1B2C3D4
    blob = struct.pack(endian + "IHHiIII", magic, 2, 4, 0, 0, snap, 1)
    for i, f in enumerate(frs):
        frac = i * dt_us * (1000 if nanos else 1)
        sec, frac = 1000 + frac // (10**9 if nanos else 10**6), \
            frac % (10**9 if nanos else 10**6)
        cap = f[:20] if i in cut else f[:snap]
        blob += struct.pack(endian + "IIII", sec, frac, len(cap), len(f))
        blob += cap
    path.write_bytes(blob)
    return path


CAPTURES = {
    "le_us": dict(),
    "be_us": dict(endian=">"),
    "le_ns": dict(nanos=True),
    "snaplen_96": dict(snap=96),
    "headers_cut": dict(cut=set(range(3, 600, 7))),
}


@pytest.mark.parametrize("emit_all", [False, True])
@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_pcap_to_records_byte_equal(tmp_path, capsys, name, emit_all):
    p = write_pcap(tmp_path / f"{name}.pcap", frames(), **CAPTURES[name])
    got = pcap.pcap_to_records(p, emit_all=emit_all)
    err = capsys.readouterr().err
    want = jpcap.pcap_to_records(p, emit_all=emit_all)
    assert got.dtype == wire.FLOW_RECORD_DTYPE == want.dtype
    assert len(got) > 100
    assert got.tobytes() == want.tobytes()
    assert capsys.readouterr().err == err        # the same warnings
    lim = pcap.pcap_to_records(p, emit_all=emit_all, limit=57)
    assert lim.tobytes() == jpcap.pcap_to_records(
        p, emit_all=emit_all, limit=57).tobytes()
    assert len(lim) == 57


def test_parse_frame_equal_on_every_prefix():
    for f in frames(n=120) + [tcp6_ext((1, 1, 1, 1))]:
        for n in range(len(f) + 1):
            assert pcap.parse_frame(f[:n]) == jpcap.parse_frame(f[:n])


def test_bad_captures_refused_alike(tmp_path):
    for blob in (b"\x00" * 10, b"\x0a\x0d\x0d\x0a" + b"\x00" * 20):
        p = tmp_path / "bad.pcap"
        p.write_bytes(blob)
        with pytest.raises(ValueError) as e:
            pcap.pcap_to_records(p)
        with pytest.raises(ValueError) as je:
            jpcap.pcap_to_records(p)
        assert str(e.value) == str(je.value)


def test_cli_pcap_then_serve_records_matches_reference(tmp_path, capsys):
    """``cli pcap`` writes the reference verb's file and summary; the
    port's ``serve --records`` of it on the CPU gives the reference
    engine's stats over the same records."""
    p = write_pcap(tmp_path / "c.pcap", frames(n=1500, seed=9))
    out, jout = tmp_path / "rec.bin", tmp_path / "jrec.bin"
    assert cli.main(["pcap", str(p), str(out)]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert jcli.main(["pcap", str(p), str(jout)]) == 0
    jmeta = json.loads(capsys.readouterr().out)
    assert out.read_bytes() == jout.read_bytes()
    assert {k: v for k, v in meta.items() if k != "out"} == {
        k: v for k, v in jmeta.items() if k != "out"}
    assert meta["packets_emitted"] > 256
    conf = tmp_path / "fsx.json"
    conf.write_text(json.dumps({"batch": {"max_batch": 256},
                                "table": {"capacity": 4096, "salt": 7}}))
    rc = cli.main(["serve", "--device", "cpu", "--records", str(out),
                   "--config", str(conf), "--no-sink-thread", "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = np.frombuffer(out.read_bytes(), wire.FLOW_RECORD_DTYPE)
    jcfg = jconfig.FsxConfig(table=jconfig.TableConfig(capacity=4096, salt=7),
                             batch=jconfig.BatchConfig(max_batch=256))
    jr = JEngine(jcfg, JArraySource(rec.copy()), JCollectSink(),
                 sink_thread=False).run()
    assert rep["records"] == jr.records == len(rec)
    assert rep["stats"] == jr.stats
