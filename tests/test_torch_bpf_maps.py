"""The eBPF plane against the real kernel: the port's programs loaded
through the kernel verifier and run over crafted frames with
``BPF_PROG_TEST_RUN`` beside the reference's, the kernel tier's bands
held to the plan, both packages' emulators and the served lane, and
every pinned-map verb's output against the reference's on the same maps.

Skipped, with the reason, where ``bpf(2)`` is not permitted or bpffs is
not mounted writable at ``/sys/fs/bpf`` (nothing is mounted here).  Maps
are pinned only under a per-process directory
(``/sys/fs/bpf/fsx_port_<tag>_<pid>``), removed afterwards.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

from flowsentryx_tpu_torch.bpf import loader, xdp

pytestmark = pytest.mark.skipif(
    not loader.bpf_available(), reason="bpf(2) not permitted here")

from flowsentryx_tpu import cli as rcli  # noqa: E402
from flowsentryx_tpu.bpf import progs as rprogs  # noqa: E402
from flowsentryx_tpu.core import config as rconfig  # noqa: E402
from flowsentryx_tpu.distill import emulate as remulate  # noqa: E402
from flowsentryx_tpu_torch import cli  # noqa: E402
from flowsentryx_tpu_torch.bpf import blacklist  # noqa: E402
from flowsentryx_tpu_torch.core import wire  # noqa: E402
from flowsentryx_tpu_torch.core.config import (  # noqa: E402
    FsxConfig, LimiterConfig, RuleConfig,
)
from flowsentryx_tpu_torch.distill import emulate, parity, plan  # noqa: E402
from flowsentryx_tpu_torch.models import logreg  # noqa: E402

ART = "artifacts/logreg_int8.npz"
LIMITS = dict(pps_threshold=4, window_s=10.0, block_s=30.0)
RULES = (RuleConfig(proto="udp", dport=9999),)
OPEN = dict(pps_threshold=1e12, bps_threshold=1e15)


@pytest.fixture(autouse=True)
def _no_static_pass(monkeypatch, tmp_path):
    # the static verifier is held in test_torch_verifier*.py; here the
    # kernel's verifier is the one that loads.  The config lock goes
    # under tmp_path.
    monkeypatch.setenv("FSX_SKIP_STATIC_VERIFY", "1")
    monkeypatch.setenv("FSX_LOCK_DIR", str(tmp_path / "lock"))


class _RefDeployment(xdp.Deployment):
    """The reference's program and maps, driven by the same helpers."""

    def __init__(self, compact: bool = False):
        fd, maps = rprogs.load(rprogs.MapSizes(max_track_ips=1024,
                                               ring_bytes=1 << 14),
                               compact=compact)
        self.fd, self.maps, self.pin_dir = fd, maps, None


def _flood(dep) -> list[int]:
    """The same frames, in the same order, for both deployments."""
    rvs = []
    for i in range(3):                       # quiet flows
        for _ in range(3):
            rvs.append(dep.run(xdp.ip4_pkt(0x0C000001 + i, dport=80 + i,
                                           plen=100 + 50 * i)))
    for _ in range(8):                       # over the 4 pps limit
        rvs.append(dep.run(xdp.ip4_pkt(0x0C0000AA, proto=6, dport=443,
                                       plen=64, tcp_flags=0x02)))
    rvs.append(dep.run(xdp.ip4_pkt(0x0C0000BB, dport=9999)))   # rule
    rvs.append(dep.run(xdp.ip4_pkt(0x0C0000CC, proto=1)))      # icmp
    for _ in range(6):                       # a v6 flood, exact blacklist
        rvs.append(dep.run(xdp.ip6_pkt((0x20010DB8, 0, 0, 0xDDDD0001))))
    return rvs


def _stable_records(ring) -> list[tuple]:
    """Emitted raw48 records less their time-derived fields (timestamp,
    duration, rate and the IAT slots)."""
    recs = ring.read()
    arr = np.frombuffer(b"".join(recs), dtype=wire.FLOW_RECORD_DTYPE)
    return [(int(r["saddr"]), int(r["pkt_len"]), int(r["ip_proto"]),
             int(r["flags"]), tuple(int(x) for x in r["feat"][:3]))
            for r in arr]


def test_xdp_test_run_legs_equal_reference():
    cfg = FsxConfig(limiter=LimiterConfig(**LIMITS), rules=RULES)
    rcfg = rconfig.FsxConfig.from_json(cfg.to_json())
    out = []
    for dep, c in ((xdp.Deployment(), cfg), (_RefDeployment(), rcfg)):
        try:
            ring = loader.RingbufReader(dep.maps["feature_ring"])
            dep.push_config(c)
            rvs = _flood(dep)
            out.append((rvs, dep.stats(), _stable_records(ring),
                        sorted(dep.maps["blacklist_map"].keys()),
                        sorted(dep.maps["blacklist_v6"].keys())))
        finally:
            dep.close()
    assert out[0] == out[1]
    rvs, stats = out[0][:2]
    assert rvs.count(xdp.XDP_DROP) >= 3 and stats["dropped_rule"] == 1
    assert stats["dropped_rate"] > 0 and len(out[0][4]) == 1


@pytest.mark.parametrize("compact", [False, True], ids=["ml_raw48",
                                                        "ml_compact16"])
def test_kernel_tier_bands_equal_plan_emulators_and_served_lane(compact):
    """The distilled model pushed into a live ``ml`` program: on every
    scored packet of a crafted flood the kernel's band equals the plan's,
    both packages' emulators' and the served lane's, on the features
    the kernel scored."""
    tp = logreg.load_params(ART)
    p = plan.compile_plan(tp)
    blob = plan.pack_blob(p)
    dep = xdp.Deployment(compact=compact, ml=True)
    try:
        dep.push_config(FsxConfig(limiter=LimiterConfig(**OPEN)))
        dep.push_model(blob)
        feats, bands = xdp.ml_band_leg(dep, n_flows=96, seed=3)
    finally:
        dep.close()
    assert len(bands) > 200
    assert set(np.unique(bands)) == {0, 1, 2}
    np.testing.assert_array_equal(bands, p.bands(feats))
    np.testing.assert_array_equal(bands, emulate.emulate_scorer(blob, feats))
    np.testing.assert_array_equal(bands,
                                  remulate.emulate_scorer(blob, feats))
    np.testing.assert_array_equal(bands, parity.served_bands(tp, p, feats))


# -- the pinned-map verbs --------------------------------------------------------


@pytest.fixture(scope="module")
def pinned():
    """An ``ml`` deployment that has seen traffic, its maps pinned."""
    pin = xdp.bpffs_dir("maps")
    if pin is None:
        pytest.skip("bpffs is not mounted writable at /sys/fs/bpf")
    mp = pytest.MonkeyPatch()
    mp.setenv("FSX_SKIP_STATIC_VERIFY", "1")
    dep = xdp.Deployment(ml=True)
    try:
        dep.pin(pin)
        dep.push_config(FsxConfig(limiter=LimiterConfig(**LIMITS),
                                  rules=RULES))
        _flood(dep)
        yield dep
    finally:
        dep.close()
        mp.undo()


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            print(e.code, file=err)
    return rc, out.getvalue(), err.getvalue()


def _both(argv) -> tuple:
    return _run(cli.main, argv), _run(rcli.main, argv)


def _strip(obj, keys=("ts", "remaining_s", "blocked_s")):
    if isinstance(obj, dict):
        return {k: _strip(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_strip(v, keys) for v in obj]
    return obj


def test_status_pin_equals_reference(pinned, tmp_path):
    argv = ["status", "--pin", pinned.pin_dir,
            "--feature-ring", str(tmp_path / "f"),
            "--verdict-ring", str(tmp_path / "v")]
    mine, ref = _both(argv)
    assert mine == ref
    kern = json.loads(mine[1])["kernel"]
    assert kern["stats"]["dropped_rule"] == 1
    assert kern["blacklist_entries"] == 2


def test_monitor_pin_and_kernel_alerts_equal_reference(pinned):
    argv = ["monitor", "--pin", pinned.pin_dir, "--count", "2",
            "--interval", "0", "--alert-blacklist", "2",
            "--alert-drop-pps", "1e12"]
    (rc, out, err), (rrc, rout, rerr) = _both(argv)
    assert rc == rrc == 0 and err == rerr
    recs = [json.loads(ln) for ln in out.splitlines()]
    assert [_strip(r) for r in recs] == \
        [_strip(json.loads(ln)) for ln in rout.splitlines()]
    assert recs[0]["alerts"] == ["blacklist size 2 >= 2"]
    assert set(recs[1]["per_s"]) == {n for n, _ in wire.KERNEL_STATS_FIELDS}
    assert "fsx monitor: ALERT blacklist size 2 >= 2" in err


def test_top_equals_reference(pinned):
    (rc, out, _), (rrc, rout, _) = _both(["top", "--pin", pinned.pin_dir,
                                           "--json"])
    assert rc == rrc == 0
    mine, ref = json.loads(out), json.loads(rout)
    assert _strip(mine) == _strip(ref)
    assert len(mine["flows"]) == 6 and mine["n_blocked"] == 2
    pkts = [f["pkts"] for f in mine["flows"]]
    assert pkts == sorted(pkts, reverse=True) and sum(pkts) >= 14
    for a, b in zip(mine["flows"], ref["flows"]):
        assert abs(a["blocked_s"] - b["blocked_s"]) <= 0.2
    (rc, out, _), (_, rout, _) = _both(["top", "--pin", pinned.pin_dir,
                                        "-n", "2"])
    assert rc == 0
    assert out.splitlines()[0] == rout.splitlines()[0]
    assert out.splitlines()[-1] == rout.splitlines()[-1] == \
        "2 flow(s) shown; 2 source(s) blacklisted"


def test_block_blacklist_unblock_equal_reference(pinned):
    pin = pinned.pin_dir
    for main, ip in ((cli.main, "192.0.2.7"), (rcli.main, "192.0.2.8"),
                     (cli.main, "2001:db8::7")):
        rc, out, _ = _run(main, ["block", ip, "--ttl", "45", "--pin", pin])
        assert rc == 0 and json.loads(out)["blocked"] == ip
    (rc, out, _), (rrc, rout, _) = _both(["blacklist", "--pin", pin,
                                           "--json"])
    assert rc == rrc == 0
    mine, ref = json.loads(out), json.loads(rout)
    assert _strip(mine) == _strip(ref)
    got = {e.get("v4") or e.get("addr") for e in mine["entries"]}
    assert {"192.0.2.7", "192.0.2.8", "2001:db8::7"} <= got
    (_, text, _), (_, rtext, _) = _both(["blacklist", "--pin", pin])
    assert text.splitlines()[0] == rtext.splitlines()[0]
    assert text.splitlines()[-1] == rtext.splitlines()[-1] == "5 entries"
    # each package unblocks what the other blocked
    assert _run(rcli.main, ["unblock", "192.0.2.7", "--pin", pin])[0] == 0
    for ip in ("192.0.2.8", "2001:db8::7"):
        rc, out, _ = _run(cli.main, ["unblock", ip, "--pin", pin])
        assert rc == 0 and json.loads(out) == {"unblocked": ip,
                                               "was_present": True}
    assert _both(["unblock", "192.0.2.7", "--pin", pin])[0][0] == 1
    m = blacklist.open_map(pin)
    try:
        assert len(blacklist.entries(m)) == 1   # the rate-limited source
    finally:
        m.close()


def test_rules_and_config_equal_reference(pinned):
    pin = pinned.pin_dir
    mine, ref = _both(["rules", "--pin", pin, "--json"])
    assert mine == ref and json.loads(mine[1])["entries"] == [
        {"proto": "udp", "dport": 9999, "action": "drop"}]
    assert _run(cli.main, ["rules", "--pin", pin, "--add", "tcp:22"])[0] == 0
    mine, ref = _both(["rules", "--pin", pin])
    assert mine == ref and mine[1].splitlines()[-1] == "2 rules"
    mine, ref = _both(["config", "--pin", pin])
    assert mine == ref
    assert json.loads(mine[1])["kernel_config"]["rule_count"] == 2
    assert _run(rcli.main, ["rules", "--pin", pin, "--remove",
                            "tcp:22"])[0] == 0
    rc, out, _ = _run(cli.main, ["config", "--pin", pin, "--set",
                                 "pps_threshold=5000", "--set",
                                 "window_s=2", "--set",
                                 "limiter_kind=token"])
    assert rc == 0
    shown = json.loads(out)["kernel_config"]
    assert shown["pps_threshold"] == 5000 and shown["window_ns"] == 2 * 10**9
    assert shown["limiter_kind"] == 2 and shown["rule_count"] == 1
    mine, ref = _both(["config", "--pin", pin])
    assert mine == ref and json.loads(mine[1])["kernel_config"] == shown
    # the refusals, as the reference words them
    for argv in (["--set", "hash_salt=1"], ["--set", "pps_threshold"],
                 ["--set", "window_s=0"], ["--pack"]):
        mine, ref = _both(["config", "--pin", pin, *argv])
        assert mine == ref and mine[0] == 1


def test_distill_pin_pushes_the_blob_as_the_reference_does(pinned,
                                                          tmp_path):
    pin = pinned.pin_dir
    m = pinned.maps["ml_model_map"]
    rc, out, _ = _run(cli.main, ["distill", ART, "--pin", pin, "--json",
                                 "--device", "cpu", "--blob",
                                 str(tmp_path / "b.bin")])
    assert rc == 0 and json.loads(out)["pushed"] == pin
    mine = m.lookup(xdp.ZERO_KEY)
    assert mine == (tmp_path / "b.bin").read_bytes()
    m.update(xdp.ZERO_KEY, b"\x00" * wire.ML_MODEL_SIZE)
    assert _run(rcli.main, ["distill", ART, "--pin", pin, "--json"])[0] == 0
    assert m.lookup(xdp.ZERO_KEY) == mine
    # no pinned map there: rc 1 and the live model is untouched
    m.update(xdp.ZERO_KEY, b"\x00" * wire.ML_MODEL_SIZE)
    rc, _, err = _run(cli.main, ["distill", ART, "--pin", pin + "_nope",
                                 "--device", "cpu"])
    assert rc == 1 and "cannot push the model blob" in err
    assert m.lookup(xdp.ZERO_KEY) == b"\x00" * wire.ML_MODEL_SIZE


def test_distill_pin_refused_when_a_check_fails(pinned, monkeypatch):
    from flowsentryx_tpu_torch.distill import parity as port_parity

    m = pinned.maps["ml_model_map"]
    m.update(xdp.ZERO_KEY, b"\x00" * wire.ML_MODEL_SIZE)
    real = port_parity.emulate_check
    monkeypatch.setattr(port_parity, "emulate_check",
                        lambda *a, **k: dict(real(*a, **k), ok=False))
    rc, _, err = _run(cli.main, ["distill", ART, "--pin", pinned.pin_dir,
                                 "--emulate", "--emulate-n", "600",
                                 "--device", "cpu"])
    assert rc == 1 and "refusing --pin: checks failed" in err
    assert m.lookup(xdp.ZERO_KEY) == b"\x00" * wire.ML_MODEL_SIZE


def test_verbs_fail_cleanly_without_pinned_maps(tmp_path):
    nowhere = str(tmp_path / "no_pin")
    mine, ref = _both(["top", "--pin", nowhere])
    assert mine == ref and mine[0] == 1
    mine, ref = _both(["status", "--pin", nowhere, "--feature-ring",
                       str(tmp_path / "f"), "--verdict-ring",
                       str(tmp_path / "v")])
    assert mine == ref
    assert "error" in json.loads(mine[1])["kernel"]["stats"]
    mine, ref = _both(["config", "--pin", nowhere])
    assert mine[0] == ref[0] == 1
