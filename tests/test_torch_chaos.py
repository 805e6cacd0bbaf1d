"""The port's chaos campaign (``flowsentryx_tpu_torch/chaos/`` and ``cli
chaos``) against the JAX package's, on the CPU.

* the fault registry equals the reference's, and ``cli chaos --list``
  prints it byte for byte without importing torch;
* each injector draws the same offsets, bytes and stamps from the same
  seed, and each sealed-slot fault leaves the same slot bytes on either
  package's ``SealedBatchQueue``;
* both packages' ``_tiny_snapshot`` files are the same bytes (bar the
  zip members' timestamps), so ``flip_bytes`` flips the same offsets;
* each of the eighteen scenario functions (the six network ones on
  loopback UDP pairs of the port's planes), given a fresh
  ``default_rng(seed)``, gives the reference's fault name, invariant
  names and verdicts and seeded fields — the slot scenario also the same
  ``records``, injections and sink blacklist, the port's engine on
  ``device="cpu"``, the handoff child shipping with the port's
  ``ship_rows``;
* the six plants are caught by their invariants and their controls hold
  (``conservation_removed`` and ``dup_suppression_removed`` with the
  reference's detail);
* ``cli chaos --quick --device cpu --json`` (the port's
  ``run_campaign(seed=17, quick=True, device="cpu")``) exits 0, is
  ``ok``, runs every fault and plant the reference runs (no
  ``not_ported`` key), keeps the reference's artifact keys, and its
  seeded fields — and the generator's state where the engine fleet draws
  its traffic seed — equal the reference's
  ``run_campaign(seed=17, quick=True)``.

Every compared field is exact: no tolerance.
"""

import contextlib
import io
import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.chaos import campaign as jcampaign
from flowsentryx_tpu.chaos import faults as jfaults
from flowsentryx_tpu.engine import shm as jshm
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.chaos import campaign, faults
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.engine import shm

REPO = Path(__file__).resolve().parents[1]
SEED = 17

#: The faults whose scenarios the port runs: every one of the registry
#: (the single-host ten, the six network faults, the elastic fleet's three).
PORTED_FAULTS = ("engine_kill", "crash_loop", "ckpt_bitflip", "ckpt_truncate",
                 "shm_bad_magic", "shm_seq_gap", "poison_batch",
                 "gossip_stall_flood", "clock_jump", "sink_wedge",
                 "net_partition", "net_heal", "net_reorder", "net_duplicate",
                 "net_loss_burst", "net_stale_epoch",
                 "handoff_kill_midship", "layout_flip_lost",
                 "adopt_half_dead")
NET_FAULTS = PORTED_FAULTS[10:16]

#: Per scenario, the result fields a seed fixes (timings excluded).
SEEDED = {"ckpt_truncate": ("truncate_fraction",),
          "ckpt_bitflip": ("flip_offsets",),
          "engine_kill": ("kill_at_s",),
          "crash_loop": ("restarts",),
          "handoff_kill_midship": ("kill_after_slots",),
          "layout_flip_lost": ("to_gen",),
          "net_reorder": ("delivered_seqs",),
          "net_loss_burst": ("burst_index",),
          "net_stale_epoch": ("injected_skew_s",),
          "shm_bad_magic+poison_batch+shm_seq_gap": ("records", "injections")}


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _verdicts(res: dict) -> list:
    return [(i["name"], i["ok"]) for i in res["invariants"]]


def _assert_same_scenario(got: dict, want: dict) -> None:
    assert got["fault"] == want["fault"]
    assert got["fault_class"] == want["fault_class"]
    assert _verdicts(got) == _verdicts(want)
    assert got["ok"] and want["ok"], (got, want)
    for k in SEEDED.get(got["fault"], ()):
        assert got[k] == want[k], k


@contextlib.contextmanager
def _fleet_rng_probe(mod, states: list):
    """Record the generator's state where ``mod.run_campaign`` builds its
    engine fleet (the traffic seed is the next draw)."""
    real = mod.build_engine_fleet

    def probe(tmp, rng, *a, **kw):
        states.append(rng.bit_generator.state)
        return real(tmp, rng, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "build_engine_fleet", probe)
        yield


@pytest.fixture(scope="module")
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# registry and injectors
# ---------------------------------------------------------------------------

def test_fault_registry_equals_reference():
    assert faults.FAULTS == jfaults.FAULTS
    assert list(faults.FAULTS) == list(jfaults.FAULTS)
    assert set(PORTED_FAULTS) == set(faults.FAULTS)
    assert not hasattr(campaign, "NOT_PORTED")


def test_chaos_list_is_the_reference_list_without_torch():
    rc, want, _ = _run(jcli.main, ["chaos", "--list"])
    assert rc == 0
    code = ("import sys\n"
            "from flowsentryx_tpu_torch import cli\n"
            "rc = cli.main(['chaos', '--list'])\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == want


@pytest.mark.parametrize("seed", [0, 17, 2 ** 31 + 5])
def test_flip_and_truncate_equal_reference(tmp_path, seed):
    data = np.random.default_rng(seed + 1).integers(
        0, 256, 4099, dtype=np.uint8).tobytes()
    got, want = tmp_path / "port.bin", tmp_path / "ref.bin"
    got.write_bytes(data)
    want.write_bytes(data)
    assert (faults.flip_bytes(got, np.random.default_rng(seed))
            == jfaults.flip_bytes(want, np.random.default_rng(seed)))
    assert got.read_bytes() == want.read_bytes() != data
    frac = float(np.random.default_rng(seed).random())
    assert faults.truncate_file(got, frac) == jfaults.truncate_file(want,
                                                                    frac)
    assert got.read_bytes() == want.read_bytes()
    got.write_bytes(data[:8])
    with pytest.raises(ValueError, match="too small"):
        faults.flip_bytes(got, np.random.default_rng(seed))


@pytest.mark.parametrize("seed", [0, 17, 123456])
def test_kill_delay_and_jumped_stamps_equal_reference(seed):
    assert (faults.pick_kill_delay_s(np.random.default_rng(seed))
            == jfaults.pick_kill_delay_s(np.random.default_rng(seed)))
    assert (faults.jumped_stamps(np.random.default_rng(seed), 64)
            == jfaults.jumped_stamps(np.random.default_rng(seed), 64))


def _sealed_queue(mod, path, words, n):
    q = mod.SealedBatchQueue.create(path, 8, words)
    for i in range(n):
        assert q.produce_batch(
            np.arange(words, dtype=np.uint32) + 100 * i, seq=i + 1,
            n_records=64, wire_id=1, seal_ns=10 ** 9 + i, fill_dur_us=3 * i)
    return q


@pytest.mark.parametrize("kind", ["bad_magic", "seq_gap", "poison"])
@pytest.mark.parametrize("slot_back", [0, 1, 3])
def test_slot_faults_equal_reference(tmp_path, kind, slot_back):
    """The same fault on each package's queue (the producer consumed two
    slots first, so the tail is not at cell 0) leaves the same cells."""
    max_batch, words_per_record = 64, 4
    words = 8 + (max_batch + 1) * words_per_record
    qs = []
    for mod, name in ((shm, "port"), (jshm, "ref")):
        q = _sealed_queue(mod, tmp_path / name, words, 6)
        q.consume_batch()
        q.consume_batch()
        qs.append(q)
    infos = []
    for q, fmod in zip(qs, (faults, jfaults)):
        if kind == "poison":
            infos.append(fmod.poison_sealed_meta(
                q, words_per_record, max_batch, slot_back=slot_back))
        else:
            infos.append(fmod.corrupt_sealed_slot(q, kind,
                                                  slot_back=slot_back))
    assert infos[0] == infos[1]
    np.testing.assert_array_equal(qs[0]._cells, qs[1]._cells)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    with pytest.raises(ValueError, match="unknown"):
        faults.corrupt_sealed_slot(qs[0], "nonsense")


def test_wait_readable_times_out_on_an_empty_queue(tmp_path):
    q = _sealed_queue(shm, tmp_path / "q", 16, 0)
    with pytest.raises(TimeoutError, match="never reached"):
        faults._wait_readable(q, 1, timeout_s=0.05)


def test_wedge_sink_wedges_until_released():
    import threading

    w = faults.WedgeSink(wedge_after=1)
    w.apply(None)                      # the first apply passes
    t = threading.Thread(target=w.apply, args=(None,), daemon=True)
    t.start()
    t.join(0.1)
    assert t.is_alive() and w.applies == 2
    w.release()
    t.join(5.0)
    assert not t.is_alive()


def test_kill_process_group():
    p = subprocess.Popen(["sleep", "30"], start_new_session=True)
    faults.kill_process_group(p.pid)
    assert p.wait(timeout=10) == -9
    faults.kill_process_group(p.pid)   # already gone: no raise


def _zip_without_times(data: bytes) -> bytes:
    """The zip's bytes with every member's DOS time and date zeroed, in
    its local headers and its central directory (``np.savez`` stamps each
    member with the wall clock)."""
    buf = bytearray(data)
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        infos = z.infolist()
        cd = z.start_dir
    for info in infos:
        o = info.header_offset
        assert buf[o:o + 4] == b"PK\x03\x04"
        buf[o + 10:o + 14] = bytes(4)
    o = cd
    for _ in infos:
        assert buf[o:o + 4] == b"PK\x01\x02"
        buf[o + 12:o + 16] = bytes(4)
        n, m, k = (int.from_bytes(buf[o + j:o + j + 2], "little")
                   for j in (28, 30, 32))
        o += 46 + n + m + k
    return bytes(buf)


@pytest.mark.parametrize("salt", [0, 0x2F1])
def test_tiny_snapshot_bytes_equal_reference(tmp_path, salt):
    got = campaign._tiny_snapshot(tmp_path / "port", salt=salt).read_bytes()
    want = jcampaign._tiny_snapshot(tmp_path / "ref", salt=salt).read_bytes()
    assert len(got) == len(want)
    assert _zip_without_times(got) == _zip_without_times(want)


# ---------------------------------------------------------------------------
# the twelve scenario functions, each from a fresh generator
# ---------------------------------------------------------------------------

def _table_and_stats(eng) -> tuple:
    """The engine's table (key, state) and stats as the reference lays
    them out: host arrays, counters as ``(lo, hi)`` u32 pairs."""
    if isinstance(eng.table, schema.IpTableState):
        key, state = schema.table_to_numpy(eng.table)
        stats = schema.stats_to_numpy(eng.stats)
    else:
        key, state = np.asarray(eng.table.key), np.asarray(eng.table.state)
        stats = {k: np.asarray(v) for k, v in eng.stats._asdict().items()}
    return key, state, {k: v.tolist() for k, v in stats.items()}


def _scenarios(mod, tmp: Path, engine_kw: dict) -> dict:
    """Every ported scenario of ``mod`` with a fresh ``default_rng(SEED)``;
    the engine-side three share one engine, in the campaign's order."""
    def rng():
        return np.random.default_rng(SEED)

    out = {
        "ckpt_truncate": mod.scenario_ckpt_truncate(tmp, rng()),
        "ckpt_bitflip": mod.scenario_ckpt_bitflip(tmp, rng()),
        "engine_kill": mod.scenario_engine_kill(tmp, rng()),
        "crash_loop": mod.scenario_crash_loop(tmp, rng()),
        "gossip_stall_flood": mod.scenario_gossip_stall_flood(tmp, rng()),
        "clock_jump": mod.scenario_clock_jump(rng()),
        **{f: getattr(mod, f"scenario_{f}")(tmp, rng()) for f in NET_FAULTS},
        "handoff_kill_midship": mod.scenario_handoff_kill_midship(
            tmp, rng()),
        "layout_flip_lost": mod.scenario_layout_flip_lost(tmp, rng()),
        "adopt_half_dead": mod.scenario_adopt_half_dead(tmp, rng()),
    }
    eng, src, sink, recs = mod.build_engine_fleet(tmp, rng(), 64 * 6,
                                                  **engine_kw)
    try:
        out["slot_corruption"] = mod.scenario_slot_corruption(
            eng, src, recs, rng(), tmp)
        out["blacklist"] = dict(sink.blocked)
        out["table"] = _table_and_stats(eng)
        out["ckpt_fallback"] = mod.scenario_ckpt_fallback(eng, tmp, rng())
        out["watchdog"] = mod.scenario_watchdog(eng, rng())
    finally:
        src.close()
    return out


@pytest.fixture(scope="module")
def scenario_pairs(tmp_path_factory, two_threads):
    got = _scenarios(campaign, tmp_path_factory.mktemp("port_scen"),
                     {"device": "cpu"})
    want = _scenarios(jcampaign, tmp_path_factory.mktemp("ref_scen"), {})
    return got, want


@pytest.mark.parametrize("name", [
    "ckpt_truncate", "ckpt_bitflip", "engine_kill", "crash_loop",
    "gossip_stall_flood", "clock_jump", "handoff_kill_midship",
    "layout_flip_lost", "adopt_half_dead", "slot_corruption",
    "ckpt_fallback", "watchdog", *NET_FAULTS])
def test_scenario_equals_reference(scenario_pairs, name):
    got, want = scenario_pairs
    _assert_same_scenario(got[name], want[name])
    if name == "clock_jump":      # pure arithmetic: the details agree too
        assert ([i["detail"] for i in got[name]["invariants"]]
                == [i["detail"] for i in want[name]["invariants"]])


def test_slot_scenario_state_equals_reference(scenario_pairs):
    """After the corrupted drain: the sink's blacklist (keys and untils),
    the whole table and the stats equal the reference engine's."""
    got, want = scenario_pairs
    assert got["slot_corruption"]["records"]["served"] > 0
    assert got["blacklist"] == want["blacklist"]
    (gk, gs, gst), (wk, ws, wst) = got["table"], want["table"]
    assert (gk != 0).sum() > 0
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))
    assert gst == wst


# ---------------------------------------------------------------------------
# planted regressions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plant", ["split_atomicity", "crc_skipped",
                                   "backoff_removed",
                                   "conservation_removed",
                                   "dup_suppression_removed",
                                   "epoch_rebase_skipped"])
def test_plant_is_caught(tmp_path, plant):
    fn = getattr(campaign, f"plant_{plant}")
    res = (fn() if plant == "split_atomicity"
           else fn(tmp_path, np.random.default_rng(SEED)))
    assert res["plant"] == plant
    assert res["caught"] and res["ok"], res
    assert res.get("control_holds", True)
    ref = {"split_atomicity": "sink_crash_atomicity",
           "crc_skipped": "corrupt_ckpt_refused",
           "backoff_removed": "crash_loop_parks",
           "conservation_removed": "handoff_rows_conserved",
           "dup_suppression_removed": "no_double_apply",
           "epoch_rebase_skipped": "epoch_rebase_exact"}
    assert res["caught_by"] == ref[plant]
    if plant in ("conservation_removed", "dup_suppression_removed"):
        # the same rows and flipped word, the same double apply, as the
        # reference's
        (tmp_path / "ref").mkdir()
        want = getattr(jcampaign, f"plant_{plant}")(
            tmp_path / "ref", np.random.default_rng(SEED))
        assert res["detail"] == want["detail"]
        assert set(res) == set(want)


# ---------------------------------------------------------------------------
# the campaign, through the CLI, against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_campaign(tmp_path_factory):
    states: list = []
    with _fleet_rng_probe(jcampaign, states):
        rep = jcampaign.run_campaign(
            seed=SEED, quick=True, workdir=tmp_path_factory.mktemp("ref_c"))
    return rep, states


@pytest.fixture(scope="module")
def port_campaign(tmp_path_factory, two_threads):
    states: list = []
    work = tmp_path_factory.mktemp("port_c")
    with _fleet_rng_probe(campaign, states):
        rc, out, err = _run(cli.main, [
            "chaos", "--quick", "--device", "cpu", "--json",
            "--workdir", str(work / "w"), "--out", str(work / "a.json")])
    return rc, out, err, states, work


def test_cli_chaos_quick_json_exits_zero(port_campaign):
    rc, out, err, _, work = port_campaign
    assert rc == 0, err
    rep = json.loads(out)
    assert rep["ok"] and rep["seed"] == SEED and rep["quick"] is True
    assert rep["device"] == "cpu"
    assert json.loads((work / "a.json").read_text()) == rep


def test_campaign_names_what_it_does_not_run(port_campaign, ref_campaign):
    """Nothing: the campaign runs every fault and plant the reference's
    runs, in its order, and its artifact has no ``not_ported`` key."""
    rep = json.loads(port_campaign[1])
    ref, _ = ref_campaign
    assert ref["ok"]
    assert "not_ported" not in rep
    ran = {f for r in rep["faults"] for f in r["fault"].split("+")}
    assert ran - {"ckpt_fallback"} == set(PORTED_FAULTS) == set(
        faults.FAULTS)
    assert [r["fault"] for r in rep["faults"]] == [
        r["fault"] for r in ref["faults"]]
    assert [p["plant"] for p in rep["planted_regressions"]] == [
        p["plant"] for p in ref["planted_regressions"]]


def test_campaign_keeps_the_reference_artifact_keys(port_campaign,
                                                    ref_campaign):
    rep = json.loads(port_campaign[1])
    ref, _ = ref_campaign
    assert set(rep) - set(ref) == {"device"}
    assert set(ref) <= set(rep)
    assert rep["registry"] == ref["registry"]
    for got in rep["faults"]:
        want = next(r for r in ref["faults"] if r["fault"] == got["fault"])
        assert set(want) <= set(got)
    for got in rep["planted_regressions"]:
        want = next(p for p in ref["planted_regressions"]
                    if p["plant"] == got["plant"])
        assert set(got) == set(want)


def test_campaign_seeded_fields_equal_reference(port_campaign, ref_campaign):
    rep = json.loads(port_campaign[1])
    ref, _ = ref_campaign
    names = [r["fault"] for r in rep["faults"]]
    assert names == [r["fault"] for r in ref["faults"] if r["fault"] in names]
    for got in rep["faults"]:
        want = next(r for r in ref["faults"] if r["fault"] == got["fault"])
        _assert_same_scenario(got, want)
    for got in rep["planted_regressions"]:
        want = next(p for p in ref["planted_regressions"]
                    if p["plant"] == got["plant"])
        assert (got["caught"], got["ok"]) == (want["caught"], want["ok"])


def test_campaign_draws_the_fleet_seed_where_the_reference_does(
        port_campaign, ref_campaign):
    """Every scenario draws what the reference's draws, so the engine
    fleet's traffic (and every later draw) is the reference campaign's."""
    [got] = port_campaign[3]
    [want] = ref_campaign[1]
    assert got == want


def test_cli_chaos_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(cli.main, ["chaos", "--quick"])
    assert rc == 1 and not out
    assert "no CUDA device" in err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign.run_campaign(quick=True)
