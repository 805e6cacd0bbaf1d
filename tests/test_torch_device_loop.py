"""The port's drain ring (``Engine(device_loop=N)``, ``fused/device_loop``)
against the JAX reference, byte for byte.

The ring loop against the reference's jitted one (table, stats, every
stacked output, one merged wire per slot); the per-slot wires against
sequential top-rung megasteps (the oracle of the reference's
``TestDeviceLoop``); the ring engine against the reference's ring engine
on one seeded stream (stats, blacklist with untils, table, dispatch
shapes), with the wire overflowing inside a round, under ``slo_us``,
behind a simulated kernel tier, fed by a sealed-batch worker, and with
a live model swap between rounds;
``device_loop=0`` as today's path; ``choose_ring_depth`` and
``ring_safe_slots`` against the reference's; every constructor and CLI
refusal in the reference's words.  B = 256 (128 for the loop itself),
capacity 2^12; torch at 2 threads.  Tolerance: byte-equal everywhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine.arena import DispatchArena as JDispatchArena
from flowsentryx_tpu.engine.sources import ArraySource as JArraySource
from flowsentryx_tpu.engine.traffic import Scenario as JScenario
from flowsentryx_tpu.engine.traffic import TrafficGen as JTrafficGen
from flowsentryx_tpu.engine.traffic import TrafficSpec as JTrafficSpec
from flowsentryx_tpu.fused import device_loop as jdl
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.engine import (
    ArraySource, CollectSink, Engine, NullSink, TrafficSource, TrafficSpec,
)
from flowsentryx_tpu_torch.engine.arena import DispatchArena
from flowsentryx_tpu_torch.engine.engine import calibrate_ring_depth
from flowsentryx_tpu_torch.fused import device_loop as dl
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused

from test_torch_megastep import _assert_same_result, _cfgs


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _recs(n_batches, batch=256, seed=11, n_attack=32):
    return JTrafficGen(JTrafficSpec(
        scenario=JScenario.UDP_FLOOD_MULTI, rate_pps=1e7,
        n_attack_ips=n_attack, attack_fraction=0.8, seed=seed)
    ).next_records(batch * n_batches)


def _pair(recs, verdict_k=64, **kw):
    """The reference's engine and the port's on the same stream and
    config (cap 2^12, pps 200), single-threaded sinks."""
    jcfg, tcfg = _cfgs(1 << 12, 256, verdict_k, pps=200.0,
                       readback_depth=4)
    jsink, tsink = JCollectSink(), CollectSink()
    je = JEngine(jcfg, JArraySource(recs.copy()), jsink,
                 sink_thread=False, **kw)
    te = Engine(tcfg, ArraySource(recs.copy()), tsink, device="cpu",
                sink_thread=False, **kw)
    return (je, jsink), (te, tsink)


# ---------------------------------------------------------------------------
# the loop itself
# ---------------------------------------------------------------------------


def _ring_batches(rng, r, c, b, quant, round_i):
    slots = []
    for s in range(r):
        raws = []
        for i in range(c):
            n = b - (i % 3) * 17
            buf = np.zeros(n, dtype=jschema.FLOW_RECORD_DTYPE)
            buf["saddr"] = rng.integers(1, 24, n).astype(np.uint32)
            buf["pkt_len"] = rng.integers(64, 1500, n)
            buf["ts_ns"] = (((round_i * r + s) * c + i) * b
                            + np.arange(n)) * 50_000
            buf["feat"] = rng.integers(0, 1 << 22, (n, 8))
            raws.append(jschema.encode_compact(buf, b, t0_ns=0, **quant))
        slots.append(np.stack(raws))
    return slots


@pytest.mark.parametrize("r,c,verdict_k", [(2, 2, 64), (3, 2, 2)])
def test_device_loop_matches_reference_loop(r, c, verdict_k):
    """Two rounds of R slots of C random compact16 batches through the
    port's loop and the reference's jitted one (cap 2^10, B=128): table
    and stats after each round, the per-slot wires, the stacked block
    arrays and verdicts and the round clock, byte for byte; and the
    per-slot wires equal those of sequential top-rung megasteps over the
    same slots.  At K=2 slot wires overflow."""
    b, cap = 128, 1 << 10
    jcfg, tcfg = _cfgs(cap, b, verdict_k, pps=20.0)
    jp, tp = jlogreg.golden_params(), logreg.golden_params()
    quant = jschema.wire_quant_for(jp)
    jloop = jdl.make_compact_device_loop(
        jcfg, jget_model(jcfg.model.name).classify_batch, r, c,
        donate=False, **quant)
    classify = get_model(tcfg.model.name).classify_batch
    tloop = dl.make_compact_device_loop(tcfg, classify, r, c, **quant)
    mega = fused.make_compact_megastep(tcfg, classify, c, **quant)
    rng = np.random.default_rng(5 + r + verdict_k)
    jt, js = jschema.make_table(cap), jschema.make_stats()
    tt, ts = schema.make_table(cap), schema.make_stats()
    mt, ms = schema.make_table(cap), schema.make_stats()
    overflowed = 0
    for round_i in range(2):
        slots = _ring_batches(rng, r, c, b, quant, round_i)
        jt, js, jo = jloop(jt, js, jp, *map(jnp.asarray, slots))
        tt, ts, to = tloop(tt, ts, tp, *map(schema.wire_to_tensor, slots))
        assert to.wire.shape == (r, 2 * verdict_k + 4)
        for f in ("wire", "block_key", "verdict"):
            np.testing.assert_array_equal(
                getattr(to, f).numpy().view(np.uint8),
                np.asarray(getattr(jo, f)).view(np.uint8), err_msg=f)
        for f in ("block_until", "now"):
            np.testing.assert_array_equal(
                getattr(to, f).numpy().view(np.uint32),
                np.asarray(getattr(jo, f)).view(np.uint32), err_msg=f)
        for s, raws in enumerate(slots):
            mt, ms, mo = mega(mt, ms, tp, schema.wire_to_tensor(raws))
            np.testing.assert_array_equal(mo.wire.numpy(),
                                          to.wire[s].numpy())
        key, state = schema.table_to_numpy(tt)
        np.testing.assert_array_equal(key, np.asarray(jt.key))
        np.testing.assert_array_equal(state.view(np.uint32),
                                      np.asarray(jt.state).view(np.uint32))
        ref = schema.stats_to_numpy(ts)
        for f in jschema.GlobalStats._fields:
            np.testing.assert_array_equal(ref[f], np.asarray(getattr(js, f)))
        overflowed += int(np.asarray(jo.wire)[:, 2 * verdict_k + 1].sum())
    assert ts.to_dict()["dropped_rate"] > 0
    assert (overflowed > 0) == (verdict_k == 2)


def test_device_loop_guards_match_reference():
    _, tcfg = _cfgs(1 << 10, 128, 64)
    classify = get_model("logreg_int8").classify_batch
    loop = dl.make_compact_device_loop(tcfg, classify, 2, 4)
    t, s, p = schema.make_table(1 << 10), schema.make_stats(), \
        logreg.golden_params()
    one = torch.zeros(4, 129, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="2-slot ring, got 1 slots"):
        loop(t, s, p, one)
    with pytest.raises(ValueError, match="4-chunk slots, slot 1"):
        loop(t, s, p, one, torch.zeros(3, 129, 4, dtype=torch.int32))
    for bad in (dict(ring_depth=0, n_chunks=1),
                dict(ring_depth=1, n_chunks=0)):
        with pytest.raises(ValueError) as te:
            dl.wrap_device_loop(None, **bad)
        with pytest.raises(ValueError) as je:
            jdl.wrap_device_loop(None, donate_argnums=(), **bad)
        assert str(te.value) == str(je.value)
    jcfg0, tcfg0 = _cfgs(1 << 10, 128, 0)
    with pytest.raises(ValueError) as te:
        dl.make_compact_device_loop(tcfg0, classify, 2, 4)
    with pytest.raises(ValueError) as je:
        jdl.make_compact_device_loop(jcfg0, None, 2, 4)
    assert str(te.value) == str(je.value)
    assert dl.ring_round_batches(3, 8) == jdl.ring_round_batches(3, 8) == 24


# ---------------------------------------------------------------------------
# the engine's ring mode against the reference's
# ---------------------------------------------------------------------------


def test_engine_device_loop_matches_reference_engine():
    """``Engine(device_loop=2, mega_n="auto")`` on 38 batches (2 rounds
    of 16, then the ladder): stats, blacklist with untils, table and the
    dispatch shapes equal the reference's ring engine; the ring fired
    full rounds and the report carries the reference's block."""
    recs = _recs(38)
    (je, jsink), (te, tsink) = _pair(recs, mega_n="auto", device_loop=2)
    jr, tr = je.run(), te.run()
    _assert_same_result(je, jsink, jr, te, tsink, tr)
    d, jd = tr.dispatch, jr.dispatch
    assert d["mode"] == jd["mode"] == "device_loop"
    assert d["group_hist"] == jd["group_hist"]
    hist = {int(g): n for g, n in d["group_hist"].items()}
    assert hist.get(16, 0) >= 2
    assert sum(g * n for g, n in hist.items()) == tr.batches == 38
    t_dl, j_dl = d["device_loop"], jd["device_loop"]
    for k in ("ring", "chunks_per_slot", "batches_per_round", "rounds",
              "steps_per_round", "partial_slot_flushes", "ring_occupancy"):
        assert t_dl[k] == j_dl[k], k
    assert set(t_dl["h2d"]) == set(j_dl["h2d"])
    assert t_dl["h2d"]["puts"] == j_dl["h2d"]["puts"] >= 2 * t_dl["rounds"]
    assert 0.0 <= t_dl["h2d"]["overlap_fraction"] <= 1.0
    assert te.readback_depth == je.readback_depth == 16
    assert d["arena"]["slots"] == je._arena.slots


def test_device_loop_zero_is_todays_path():
    recs = _recs(6)
    (je, _), (te, tsink) = _pair(recs, mega_n="auto", device_loop=0)
    tr = te.run()
    assert te.ring == 0 and te.ring_step is None
    assert tr.dispatch["mode"] == "adaptive"
    assert tr.dispatch["device_loop"] is None
    e = Engine(te.cfg, ArraySource(recs.copy()), CollectSink(),
               device="cpu", sink_thread=False, mega_n="auto")
    r = e.run()
    assert r.stats == tr.stats and e.sink.blocked == tsink.blocked
    assert r.dispatch["group_hist"] == tr.dispatch["group_hist"]


def test_device_loop_overflow_inside_round():
    """``verdict_k=2``, ``mega_n=4``, ring 2: the slot wires overflow
    inside rounds and the sink falls back to the round's block arrays;
    equal to the reference's ring engine and to the port's singles."""
    recs = _recs(20, seed=7, n_attack=8)
    (je, jsink), (te, tsink) = _pair(recs, verdict_k=2, mega_n=4,
                                     device_loop=2)
    jr, tr = je.run(), te.run()
    _assert_same_result(je, jsink, jr, te, tsink, tr)
    assert len(tsink.blocked) > 2
    assert tr.readback["fallback_sinks"] >= 1
    assert tr.dispatch["device_loop"]["rounds"] >= 1
    e1 = Engine(te.cfg, ArraySource(recs.copy()), CollectSink(),
                device="cpu", sink_thread=False)
    r1 = e1.run()
    assert r1.stats == tr.stats and e1.sink.blocked == tsink.blocked


def test_device_loop_under_slo_matches_reference_results():
    """A 20 ms budget with the ring: ``warm()`` seeds the negated round
    key (``round16``) and the floor; grouping only changes dispatch
    granularity, so stats, blacklist and table equal the reference's
    budgeted ring engine."""
    recs = _recs(36, seed=19)
    (je, jsink), (te, tsink) = _pair(recs, mega_n="auto", device_loop=2,
                                     slo_us=20_000)
    je.warm()
    te.warm()
    assert -16 in te._rung_ewma_s and te._round_floor_s[-16] > 0
    jr, tr = je.run(), te.run()
    _assert_same_result(je, jsink, jr, te, tsink, tr)
    ew = tr.dispatch["slo"]["rung_ewma_ms"]
    assert set(ew) == set(jr.dispatch["slo"]["rung_ewma_ms"])
    assert "round16" in ew


class _DropMostTier:
    """Deterministic stand-in for the simulated kernel tier: drops ~3/4
    of records in the kernel, escalates the rest."""

    def __init__(self):
        self.seen = self.kept = 0

    def filter(self, records):
        self.seen += len(records)
        out = records[records["saddr"] % 4 == 0]
        self.kept += len(out)
        return out

    def report(self):
        return {"kernel_drops": self.seen - self.kept,
                "escalated": self.kept}


def test_device_loop_behind_kernel_tier_matches_reference():
    """Escalated records arriving in ring-sized bursts: the tier sees
    every record once, and the verdicts, stats and escalation block
    equal the reference's ring engine behind the same tier (deadline
    flush off on both: a filtering tier fills batches over several
    polls); the filtered flood still fills rounds."""
    recs = _recs(40, seed=23)
    jt, tt = _DropMostTier(), _DropMostTier()
    (je, jsink), (te, tsink) = _pair(recs, mega_n=4, device_loop=2)
    je.kernel_tier, te.kernel_tier = jt, tt
    je.batcher.flush_due = lambda: False
    te.batcher.flush_due = lambda: False
    jr, tr = je.run(), te.run()
    assert tt.seen == jt.seen == len(recs) and tt.kept == jt.kept
    assert tr.escalation["kernel_drops"] == jr.escalation["kernel_drops"]
    assert tr.escalation["escalated"] == jr.escalation["escalated"]
    assert tr.stats == jr.stats and tsink.blocked == jsink.blocked
    assert tr.dispatch["group_hist"] == jr.dispatch["group_hist"]
    assert tr.dispatch["device_loop"]["rounds"] >= 1


def test_sealed_ring_matches_inline_reference(tmp_path):
    """The production shape: one sealed worker -> arena staging -> the
    ring (``mega_n=4, device_loop=2``), equal to the reference's inline
    singles engine on the same records, one host copy per batch, full
    rounds fired."""
    from test_torch_ingest import ARTIFACT, _digest, _engine_cfgs, _flood
    from test_torch_ingest import serve_sealed

    jcfg, tcfg = _engine_cfgs()
    rec = _flood(256 * 16, seed=5)
    rep, sink, e = serve_sealed("port", str(tmp_path / "r"), rec, 1, tcfg,
                                logreg.load_params(ARTIFACT), mega_n=4,
                                device_loop=2)
    je = JEngine(jcfg, JArraySource(rec.copy()), JCollectSink(),
                 params=jlogreg.load_params(ARTIFACT), sink_thread=False)
    jr = je.run()
    e0 = Engine(tcfg, ArraySource(rec.copy()), CollectSink(),
                params=logreg.load_params(ARTIFACT), device="cpu")
    e0.run()
    assert rep.records == jr.records == len(rec)
    assert rep.stats == jr.stats and sink.blocked == je.sink.blocked
    assert _digest(e) == _digest(e0)
    d = rep.dispatch
    assert d["host_copies_per_batch"] == 1.0
    assert d["staged_batches"] == rep.batches == 16
    assert d["device_loop"]["rounds"] >= 1


def test_hot_swap_between_rounds_matches_reference():
    """A swap after 16 batches (one round) of a depth-2 ring lands
    between two rounds: the rest of the stream scores with the new
    model, equal to the reference's ring engine swapped at the same
    point (``logreg_int8.npz``, then a derived artifact with its input
    observer)."""
    from test_torch_hotswap import _jlogreg, derived_int8
    from test_torch_megastep import ARTIFACT

    recs = _recs(40, seed=29)
    jcfg, tcfg = _cfgs(1 << 12, 256, 64, pps=200.0, readback_depth=4)
    h = derived_int8()
    je = JEngine(jcfg, JArraySource(recs.copy()), JCollectSink(),
                 params=jlogreg.load_params(ARTIFACT), sink_thread=False,
                 mega_n="auto", device_loop=2)
    te = Engine(tcfg, ArraySource(recs.copy()), CollectSink(),
                params=logreg.load_params(ARTIFACT), device="cpu",
                sink_thread=False, mega_n="auto", device_loop=2)
    for e, new in ((je, _jlogreg(h)), (te, logreg.params_from_numpy(h))):
        e.run(max_batches=16)
        e.hot_swap(new)
    jr, tr = je.run(), te.run()
    _assert_same_result(je, je.sink, jr, te, te.sink, tr)
    assert te._swap_at == [16]
    assert tr.dispatch["device_loop"]["rounds"] >= 1


# ---------------------------------------------------------------------------
# pure policy, geometry and refusals
# ---------------------------------------------------------------------------


def _m(ring, overlap, rounds=4):
    return {"ring": ring, "overlap_fraction": overlap, "rounds": rounds,
            "ring_occupancy": 1.0}


@pytest.mark.parametrize("ms", [
    [_m(2, 0.85), _m(4, 0.9), _m(8, 0.91)],
    [_m(2, 0.3), _m(4, 0.88), _m(8, 0.9)],
    [_m(2, 0.0, rounds=0), _m(4, 0.0, rounds=0)],
    [_m(2, 0.0), _m(4, 0.0), _m(8, 0.0)],
    [_m(2, 0.9, rounds=0), _m(4, 0.7)],
    [_m(4, 0.5), _m(2, 0.5), _m(8, 0.6)],
])
def test_choose_ring_depth_matches_reference(ms):
    assert dl.choose_ring_depth(ms) == jdl.choose_ring_depth(ms)


def test_ring_safe_slots_and_engine_geometry():
    for depth, ring in ((8, 1), (8, 2), (16, 4), (0, 3)):
        assert (DispatchArena.ring_safe_slots(depth, ring)
                == JDispatchArena.ring_safe_slots(depth, ring))
    with pytest.raises(ValueError, match="ring"):
        DispatchArena.ring_safe_slots(8, 0)
    (je, _), (te, _) = _pair(_recs(2), mega_n=4, device_loop=3)
    # the default depth rose to one round (3x4); slots = 12 + 3 + 1
    assert te.readback_depth == je.readback_depth == 12
    assert te._arena.slots == je._arena.slots == 16


@pytest.mark.parametrize("cfg_k,kw", [
    (64, dict(device_loop=2)),
    (64, dict(mega_n=4, device_loop=-1)),
    (0, dict(mega_n=4, device_loop=2)),
    (64, dict(mega_n=4, device_loop=2, readback_depth=4)),
])
def test_engine_refusals_in_reference_words(cfg_k, kw):
    jcfg, tcfg = _cfgs(1 << 12, 256, cfg_k)
    with pytest.raises(ValueError) as je:
        JEngine(jcfg, JArraySource(_recs(1)), JCollectSink(), **kw)
    with pytest.raises(ValueError) as te:
        Engine(tcfg, TrafficSource(TrafficSpec(), total=256), NullSink(),
               device="cpu", **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("argv", [
    ["--device-loop", "-1"],
    ["--device-loop", "2"],
    ["--device-loop", "auto"],
    ["--device-loop", "2", "--mega", "4", "--verdict-k", "0"],
    ["--tiered-warm"],
    ["--device-loop", "x"],
])
def test_cli_refusals_in_reference_words(argv, capsys):
    """``serve``'s pre-boot refusals: exit 1 (argparse's 2 for a bad
    value) with the reference's message after its prefix."""
    try:
        jrc = jcli.main(["serve", *argv])
    except SystemExit as e:
        jrc = e.code
    jerr = capsys.readouterr().err
    try:
        trc = cli.main(["serve", "--device", "cpu", *argv])
    except SystemExit as e:
        trc = e.code
    terr = capsys.readouterr().err
    assert trc == jrc and trc in (1, 2)
    if trc == 1:
        assert terr.strip().removeprefix("serve: ") == \
            jerr.strip().removeprefix("fsx serve: ")
    else:
        assert "--device-loop takes an integer or 'auto'" in terr


def test_calibrate_ring_depth_measures_real_rings():
    """The drive half of ``--device-loop auto`` on the CPU: each
    candidate drained a real ring (rounds fired, overlap measured) and
    the pick is the policy's over those measurements."""
    _, tcfg = _cfgs(1 << 12, 128, 64, pps=200.0)
    depth, detail = calibrate_ring_depth(tcfg, candidates=(1, 2),
                                         batches=40, device="cpu")
    cands = detail["candidates"]
    assert [m["ring"] for m in cands] == [1, 2]
    assert all(m["rounds"] >= 1 for m in cands)
    assert depth == dl.choose_ring_depth(cands)[0]
    assert detail["calibration_batches"] == 40 and detail["reason"]
