"""The seed-driven chaos campaign: real stack in, verdicts out.

Counterpart of ``flowsentryx_tpu/chaos/campaign.py`` over the port's own
objects: a serving :class:`~flowsentryx_tpu_torch.engine.engine.Engine`
(on the card unless ``device="cpu"``), a live
:class:`~flowsentryx_tpu_torch.ingest.sharded.ShardedIngest` worker
fleet over real shm rings, the :class:`~flowsentryx_tpu_torch.cluster
.supervisor.ClusterSupervisor` with real child processes and real
:class:`~flowsentryx_tpu_torch.cluster.gossip.GossipPlane` mailbox pairs
— judged by the named invariants of :mod:`.invariants`.  One engine is
built per campaign and shared across the engine-side scenarios (on the
card its graphs are captured once); they are ordered so each leaves the
engine in the state the next needs, ending with the watchdog wedge that
deliberately fails it.

The campaign runs every fault of the registry: the thirteen single-host
ones (the elastic fleet's handoff, layout-flip and adopt faults among
them) and the six network faults of the multi-host gossip leg, on
loopback UDP pairs of real planes whose epochs lie 250 s apart; and the
reference's six PLANTED regressions (split-atomicity crash accounting,
CRC-less checkpoint loads, no-backoff respawn, duplicate suppression
removed, the epoch rebase skipped, handoff staging without its SEAL
check), each of which PASSES only when its named invariant FAILS under
it.  The scenarios draw from the generator in the reference's order, so
one ``--seed`` gives the same traffic, offsets and kill schedule here as
in the reference's campaign.

Determinism: every random choice flows from one
``numpy.random.default_rng(seed)``; wall-clock only bounds waits.
"""

from __future__ import annotations

import contextlib
import io
import json
import time
from pathlib import Path

import numpy as np

from flowsentryx_tpu_torch.chaos import faults
from flowsentryx_tpu_torch.chaos.invariants import all_ok, check

#: Bound (seconds) inside which a killed rank must be re-serving (its
#: next generation heartbeating) — generous against CI throttling, yet
#: three orders of magnitude under "an operator noticed".
RECOVERY_BOUND_S = 15.0

def _scenario(name: str, invs: list, **extra) -> dict:
    cls, desc = faults.FAULTS[name]
    return {
        "fault": name,
        "fault_class": cls,
        "description": desc,
        "ok": all_ok(invs),
        "invariants": [r.to_json() for r in invs],
        **extra,
    }


# ---------------------------------------------------------------------------
# supervisor scenarios (stub ranks: the real supervision protocol in ms)
# ---------------------------------------------------------------------------

def scenario_engine_kill(tmp: Path, rng: np.random.Generator) -> dict:
    """SIGKILL a supervised rank mid-serve at a seeded point; the
    crash-fail-open contract must hold: respawn from checkpoint within
    the bound, survivor untouched, aggregation counting each rank's
    latest generation once."""
    from flowsentryx_tpu_torch.cluster.mailbox import (
        StatusBlock, status_path,
    )
    from flowsentryx_tpu_torch.cluster.runner import stub_engine_main
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor

    ck = tmp / "kill_ck_r1.npz"
    ck.write_bytes(b"stub flow memory")
    kill_at = faults.pick_kill_delay_s(rng)
    sup = ClusterSupervisor(
        tmp / "kill_cl",
        [{"stub_serve_s": 2.0, "workers": 1},
         {"stub_serve_s": 2.0, "checkpoint": str(ck), "workers": 1}],
        entry=stub_engine_main)
    sup.boot()
    st1 = StatusBlock(status_path(tmp / "kill_cl", 1))
    t0 = time.monotonic()
    killed_t = None
    recovered_t = None
    hbeat_floor = 0
    deadline = t0 + 30.0
    try:
        while time.monotonic() < deadline:
            sup.poll()
            hb = st1.ctl_get("c_hbeat")
            if killed_t is None:
                if hb and time.monotonic() - t0 >= kill_at:
                    hbeat_floor = hb
                    sup.kill(1)
                    killed_t = time.monotonic()
            elif (st1.ctl_get("c_gen") == 1 and hb > hbeat_floor):
                recovered_t = time.monotonic()
                break
            time.sleep(0.02)
        sup.run()  # serve the remainder to completion
    finally:
        sup.close()
    agg = sup.aggregate()
    recovery_s = (recovered_t - killed_t) if recovered_t else None
    invs = [
        check("recovery_within_bound",
              recovery_s is not None and recovery_s < RECOVERY_BOUND_S,
              f"kill->gen1-heartbeat {recovery_s!r}s "
              f"(bound {RECOVERY_BOUND_S}s, incl. backoff)"),
        check("fail_open_holds",
              agg["failed_ranks"] == [] and agg["restarts"] == [0, 1],
              f"restarts={agg['restarts']} failed={agg['failed_ranks']}"),
        check("counters_conserved",
              len({(r["rank"], r["gen"]) for r in agg["reports"]})
              == len(agg["reports"])
              and any(r["rank"] == 1 and r["gen"] == 1
                      and r.get("restored") == str(ck)
                      for r in agg["reports"]),
              "latest-gen dedup held and gen-1 restored its checkpoint"),
    ]
    return _scenario("engine_kill", invs, kill_at_s=round(kill_at, 3),
                     recovery_s=(round(recovery_s, 3)
                                 if recovery_s else None))


def scenario_crash_loop(tmp: Path, rng: np.random.Generator,
                        *, window_s: float = 60.0,
                        backoff_s: float = 0.05,
                        max_restarts: int = 2,
                        name: str = "crash_loop") -> dict:
    """A rank that dies instantly EVERY generation: the crash-loop
    discipline must back off exponentially and park it as failed
    within the sliding-window budget — instead of respawning in ms with
    the budget gone before a human reads line one.  The
    ``backoff_removed`` plant re-runs this with the window disabled and
    must see ``crash_loop_parks`` FAIL."""
    del rng  # the crash schedule is "always, immediately" by design
    from flowsentryx_tpu_torch.cluster.runner import stub_engine_main
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor

    sup = ClusterSupervisor(
        tmp / f"{name}_cl",
        [{"stub_serve_s": 3.0, "workers": 1},
         {"stub_serve_s": 30.0, "stub_crash_after_s": 0.0,
          "stub_crash_every_gen": True, "workers": 1}],
        entry=stub_engine_main,
        max_restarts=max_restarts,
        restart_backoff_s=backoff_s,
        restart_window_s=window_s)
    sup.boot()
    deadline = time.monotonic() + 20.0
    stderr = io.StringIO()
    try:
        with contextlib.redirect_stderr(stderr):
            while (1 not in sup._failed
                   and sup.restarts[1] <= max_restarts + 2
                   and time.monotonic() < deadline):
                sup.poll()
                time.sleep(0.01)
    finally:
        sup.close()
    deaths = sup._death_times[1]
    gaps = [round(b - a, 4) for a, b in zip(deaths, deaths[1:])]
    # death k+1 happens >= the backoff delay after death k (the stub
    # dies instantly, so the inter-death gap IS the respawn delay);
    # 0.7x slack absorbs scheduler jitter without hiding a no-backoff
    # regression (which respawns in ~10 ms)
    expected = [min(backoff_s * (2 ** k), 5.0)
                for k in range(len(gaps))]
    spacing_ok = all(g >= 0.7 * e for g, e in zip(gaps, expected))
    parked_announced = "PARKED as failed" in stderr.getvalue()
    parked = (1 in sup._failed and sup.restarts[1] == max_restarts
              and parked_announced)
    invs = [
        check("crash_loop_parks", parked,
              f"restarts={sup.restarts[1]} (budget {max_restarts}), "
              f"failed={sorted(sup._failed)}, span "
              f"announced={parked_announced}"),
        check("respawn_backoff_spacing",
              spacing_ok and len(gaps) >= 1,
              f"inter-death gaps {gaps}s vs backoff ladder "
              f"{expected}s"),
        check("fail_open_holds", 0 not in sup._failed,
              "rank 0 never entered failed"),
    ]
    return _scenario("crash_loop", invs, inter_death_gaps_s=gaps,
                     restarts=sup.restarts[1])


# ---------------------------------------------------------------------------
# checkpoint scenarios
# ---------------------------------------------------------------------------

def _tiny_snapshot(tmp: Path, name: str = "tiny_snap",
                   salt: int = 0) -> Path:
    """An empty 256-row snapshot, written through the port's
    ``save_state``: the same bytes as the reference's (bar the zip
    members' timestamps), so :func:`~.faults.flip_bytes` draws the same
    offsets from the same seed."""
    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.engine import checkpoint as ckpt

    tmp.mkdir(parents=True, exist_ok=True)
    return ckpt.save_state(tmp / name, schema.make_table(256),
                           schema.make_stats(), t0_ns=12345,
                           hash_salt=salt)


def scenario_ckpt_truncate(tmp: Path, rng: np.random.Generator) -> dict:
    """Truncated and zero-length checkpoints must raise the NAMED
    error through the pre-boot validation path, never a raw
    struct/IndexError out of ``peek_header``."""
    from flowsentryx_tpu_torch.engine import checkpoint as ckpt

    path = _tiny_snapshot(tmp, "snap_truncate")
    frac = float(0.2 + 0.6 * rng.random())
    faults.truncate_file(path, frac)
    named_trunc, err_trunc = False, ""
    try:
        ckpt.peek_header(path)
    except ckpt.CheckpointCorrupt as e:
        named_trunc, err_trunc = True, str(e)
    except Exception as e:  # noqa: BLE001 — the raw-leak regression
        err_trunc = f"RAW {type(e).__name__}: {e}"
    faults.truncate_file(path, 0.0)
    named_empty, err_empty = False, ""
    try:
        ckpt.peek_header(path)
    except ckpt.CheckpointCorrupt as e:
        named_empty, err_empty = True, str(e)
    except Exception as e:  # noqa: BLE001
        err_empty = f"RAW {type(e).__name__}: {e}"
    load_refused = False
    try:
        ckpt.load_checkpoint(path)
    except ckpt.CheckpointCorrupt:
        load_refused = True
    except ValueError:
        pass
    invs = [
        check("corrupt_ckpt_refused",
              named_trunc and named_empty and load_refused,
              f"truncated->({err_trunc!r}) empty->({err_empty!r})"),
    ]
    return _scenario("ckpt_truncate", invs,
                     truncate_fraction=round(frac, 3))


def scenario_ckpt_bitflip(tmp: Path, rng: np.random.Generator) -> dict:
    """Two corruption legs: raw byte flips (structural/zlib refusal)
    and a CLEAN-DECODE splice — valid zip, wrong bytes — that only the
    folded CRC32 can catch.  Both must refuse with the named error."""
    from flowsentryx_tpu_torch.engine import checkpoint as ckpt

    # leg 1: raw flips
    p1 = _tiny_snapshot(tmp, "snap_flip")
    offs = faults.flip_bytes(p1, rng)
    raw_refused = False
    try:
        ckpt.load_checkpoint(p1)
    except ckpt.CheckpointCorrupt:
        raw_refused = True
    # leg 2: clean splice — re-encode with one flipped value but the
    # ORIGINAL stored CRC (a valid zip whose contents lie)
    p2 = _tiny_snapshot(tmp, "snap_splice")
    with np.load(p2) as z:
        data = {k: np.array(z[k]) for k in z.files}
    data["table_key"] = data["table_key"].copy()
    data["table_key"][int(rng.integers(0, len(data["table_key"])))] ^= 1
    np.savez_compressed(p2, **data)
    crc_refused, crc_msg = False, ""
    try:
        ckpt.load_checkpoint(p2)
    except ckpt.CheckpointCorrupt as e:
        crc_refused, crc_msg = True, str(e)
    invs = [
        check("corrupt_ckpt_refused", raw_refused and crc_refused,
              f"raw-flip refused={raw_refused} (offsets {offs[:4]}...), "
              f"clean-splice refused={crc_refused}"),
        check("no_silent_verdict_loss",
              "CRC32" in crc_msg or "integrity" in crc_msg,
              f"the clean splice was caught BY the CRC leg: {crc_msg!r}"),
    ]
    return _scenario("ckpt_bitflip", invs, flip_offsets=offs)


def scenario_ckpt_fallback(engine, tmp: Path,
                           rng: np.random.Generator) -> dict:
    """REAL-engine restore fallback: corrupt the live checkpoint of a
    serving engine (clean splice, so the CRC is what refuses) and
    restore — the engine must fall back to the retained ``.prev``
    generation, loudly, with the restored table provably that
    generation's.  The restore copies into the engine's own tensors, so
    graphs captured on the card keep reading the table they hold."""
    from flowsentryx_tpu_torch.core import schema
    from flowsentryx_tpu_torch.engine import checkpoint as ckpt

    path = tmp / "eng_ck.npz"
    engine.checkpoint(path)          # generation A (becomes .prev)
    engine.checkpoint(path)          # generation B (rotates A out)
    prev = ckpt.prev_path(path)
    prev_key = ckpt.load_checkpoint(prev).key
    with np.load(path) as z:
        data = {k: np.array(z[k]) for k in z.files}
    data["stats_allowed"] = data["stats_allowed"].copy()
    data["stats_allowed"][0] ^= 0xFFFF
    np.savez_compressed(path, **data)
    stderr = io.StringIO()
    with contextlib.redirect_stderr(stderr):
        info = engine.restore(path)
    restored_key = schema.table_to_numpy(engine.table)[0]
    direct_refused = False
    try:
        ckpt.load_checkpoint(path)
    except ckpt.CheckpointCorrupt:
        direct_refused = True
    invs = [
        check("corrupt_ckpt_refused", direct_refused,
              "the spliced checkpoint cannot be loaded directly"),
        check("ckpt_fallback_to_prev",
              info.get("fallback_from") == str(path)
              and np.array_equal(np.sort(restored_key),
                                 np.sort(prev_key))
              and "REFUSED" in stderr.getvalue(),
              f"fallback_from={info.get('fallback_from')!r}, table == "
              ".prev generation, announced on stderr"),
        check("health_degraded_reasons",
              engine._restore_fallbacks >= 1,
              f"restore_fallbacks={engine._restore_fallbacks} feeds "
              "the DEGRADED ladder"),
    ]
    del rng
    out = _scenario("ckpt_bitflip", invs)
    out["fault"] = "ckpt_fallback"
    out["description"] = ("the ckpt_bitflip fault exercised through "
                          "the REAL engine's restore path: corrupt "
                          "live checkpoint -> loud .prev fallback")
    return out


# ---------------------------------------------------------------------------
# real engine + sharded ingest: slot corruption / poison / watchdog
# ---------------------------------------------------------------------------

def _engine_cfg(max_batch: int = 64):
    import dataclasses

    from flowsentryx_tpu_torch.core.config import FsxConfig

    cfg = FsxConfig()
    return dataclasses.replace(
        cfg,
        batch=dataclasses.replace(cfg.batch, max_batch=max_batch,
                                  deadline_us=2000),
        table=dataclasses.replace(cfg.table, capacity=1 << 12),
    )


def build_engine_fleet(tmp: Path, rng: np.random.Generator,
                       n_records: int, device=None):
    """One real serving engine on ``device`` (None: the card) over a
    real 1-worker sealed-ingest fleet, with ``n_records`` of seeded
    traffic already in the shard ring.  Shared by the engine-side
    scenarios (one engine, one capture, per campaign)."""
    from flowsentryx_tpu_torch.core import wire
    from flowsentryx_tpu_torch.engine import CollectSink, Engine
    from flowsentryx_tpu_torch.engine.shm import ShmRing
    from flowsentryx_tpu_torch.engine.traffic import (
        Scenario, TrafficGen, TrafficSpec,
    )
    from flowsentryx_tpu_torch.ingest import ShardedIngest

    recs = TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, rate_pps=1e6,
        n_attack_ips=8, n_benign_ips=24, attack_fraction=0.8,
        seed=int(rng.integers(0, 1 << 31)),
    )).next_records(n_records)
    base = str(tmp / "chaos_fring")
    ring = ShmRing.create(wire.shard_ring_path(base, 0, 1), 1 << 13,
                          wire.FLOW_RECORD_DTYPE)
    assert ring.produce(recs) == len(recs)
    src = ShardedIngest(base, 1, queue_slots=16, precompact=False,
                        t0_grace_s=0.2,
                        quarantine_dir=str(tmp / "quarantine"))
    sink = CollectSink()
    eng = Engine(_engine_cfg(), src, sink, readback_depth=4,
                 sink_thread=True, device=device)
    return eng, src, sink, recs


def scenario_slot_corruption(eng, src, recs,
                             rng: np.random.Generator,
                             tmp: Path) -> dict:
    """Corrupt three SEALED shm slots in place — bad wire-id magic, a
    forward seq jump, and a well-formed-but-poisoned metadata row
    (n_records past max_batch, outside the RANGE_* encoder contracts) —
    then drain through the REAL engine.  The drain must survive, every
    loss must be counted, and the health ladder must read DEGRADED with
    exactly these reasons.  ``tmp`` holds the ingest's quarantine
    spool."""
    del rng
    # resolve the t0 handshake (the workers buffer, unsealed, until
    # the engine publishes the agreed epoch)
    deadline = time.monotonic() + 30.0
    while src.t0_ns is None:
        src.poll_batches(0)
        if time.monotonic() > deadline:
            raise TimeoutError("ingest t0 handshake did not resolve")
        time.sleep(0.01)
    q = src._queues[0]
    faults._wait_readable(q, 4)
    # true record count of the bad-magic slot, read BEFORE corrupting:
    # the conservation invariant needs it (its header is untrusted
    # after)
    from flowsentryx_tpu_torch.core import wire

    t = int(q._tail[0])
    bad_n_true = int(q._cells[t & (q.slots - 1)][
        wire.BATCHQ_N_RECORDS_WORD])
    inj = [
        faults.corrupt_sealed_slot(q, "bad_magic", slot_back=0),
        faults.poison_sealed_meta(
            q, words_per_record=src._payload_shape[1],
            max_batch=src._max_batch, slot_back=1),
        faults.corrupt_sealed_slot(q, "seq_gap", slot_back=3),
    ]
    src.request_stop()
    stderr = io.StringIO()
    with contextlib.redirect_stderr(stderr):
        rep = eng.run()
    stats = rep.ingest
    served = rep.records
    quarantined = stats["quarantined_records"]
    conserved = served + quarantined + bad_n_true == len(recs)
    dumps = list((tmp / "quarantine").glob("quarantine_*.npy"))
    reasons = set(rep.health["reasons"])
    invs = [
        check("bad_slot_skipped_counted",
              stats["bad_wire_slots"] == 1
              and "REFUSED" in stderr.getvalue(),
              f"bad_wire_slots={stats['bad_wire_slots']}, announced"),
        check("poison_quarantined",
              stats["quarantined_batches"] == 1 and len(dumps) == 1,
              f"quarantined={stats['quarantined_batches']}, "
              f"spooled={len(dumps)} file(s) in {tmp / 'quarantine'}"),
        check("seq_gap_counted",
              sum(w["seq_gaps"]
                  for w in stats["workers"].values()) >= 1,
              "the seq jump surfaced in the gap counters"),
        check("no_silent_verdict_loss", conserved,
              f"{len(recs)} produced == {served} served + "
              f"{quarantined} quarantined + {bad_n_true} in the "
              "bad-magic slot"),
        check("fail_open_holds",
              not stats["crashed"] and stats["dead_workers"] == [],
              "the drain worker survived all three corruptions"),
        check("health_degraded_reasons",
              rep.health["state"] == "degraded"
              and any(r.startswith("bad_wire_slots:") for r in reasons)
              and any(r.startswith("quarantined_batches:")
                      for r in reasons)
              and any(r.startswith("ingest_seq_gaps:")
                      for r in reasons),
              f"health={rep.health['state']} reasons={sorted(reasons)}"),
    ]
    out = _scenario("shm_bad_magic", invs, injections=inj,
                    records={"produced": len(recs), "served": served,
                             "quarantined": quarantined,
                             "bad_slot": bad_n_true})
    out["fault"] = "shm_bad_magic+poison_batch+shm_seq_gap"
    return out


def scenario_watchdog(eng, rng: np.random.Generator) -> dict:
    """Wedge the verdict sink forever with batches in flight: the
    dispatch watchdog must dump per-thread stacks, count a soft trip,
    and fail the drain with the named error within 2x its stall bound
    — never hang.  Runs LAST: it deliberately leaves the engine
    failed (the wedged worker is released and abandoned); nothing may
    serve on that engine afterwards."""
    del rng
    from flowsentryx_tpu_torch.engine.sources import ArraySource
    from flowsentryx_tpu_torch.engine.traffic import (
        Scenario, TrafficGen, TrafficSpec,
    )
    from flowsentryx_tpu_torch.engine.watchdog import (
        DispatchWatchdog, WatchdogStall,
    )

    recs = TrafficGen(TrafficSpec(
        scenario=Scenario.UDP_FLOOD_MULTI, seed=7)).next_records(256)
    wedge = faults.WedgeSink()
    stall_s = 0.4
    eng.reset_stream(ArraySource(recs), sink=wedge)
    eng._watchdog = DispatchWatchdog(stall_s)  # quiescent swap
    stderr = io.StringIO()
    t0 = time.monotonic()
    raised = None
    try:
        with contextlib.redirect_stderr(stderr):
            eng.run(max_seconds=30.0)
    except WatchdogStall as e:
        raised = e
    elapsed = time.monotonic() - t0
    wedge.release()  # let the abandoned worker drain and exit
    err = stderr.getvalue()
    invs = [
        check("watchdog_trips_within_bound",
              raised is not None and elapsed < 10 * stall_s,
              f"WatchdogStall in {elapsed:.2f}s "
              f"(stall bound {stall_s}s): {raised}"),
        check("no_silent_verdict_loss",
              "per-thread stacks" in err
              and "fsx-sink" in err,
              "the stack dump names the wedged sink thread — the "
              "diagnostic an operator needs, automated"),
        check("health_degraded_reasons",
              eng._watchdog.trips >= 1 and eng._watchdog.tripped,
              f"soft trips={eng._watchdog.trips}, hard tripped — the "
              "FAILED rung of the ladder"),
    ]
    return _scenario("sink_wedge", invs,
                     elapsed_s=round(elapsed, 3))


# ---------------------------------------------------------------------------
# gossip + clock scenarios
# ---------------------------------------------------------------------------

def scenario_gossip_stall_flood(tmp: Path,
                                rng: np.random.Generator) -> dict:
    """Flood a 4-slot pair mailbox while the peer's merge tick is
    stalled: the publisher must drop-and-count without ever blocking
    the sink path, and once the peer resumes, every wire that WAS
    delivered must merge last-wins — drops + merges accounting every
    publish."""
    from flowsentryx_tpu_torch.cluster import gossip as gplane
    from flowsentryx_tpu_torch.engine.writeback import BlacklistUpdate

    d = tmp / "gossip_cl"
    k_max, slots = 8, 4
    gplane.create_plane(d, 2, k_max=k_max, slots=slots)
    a = gplane.GossipPlane(d, 0, 2)
    b = gplane.GossipPlane(d, 1, 2)

    def update(n, base):
        keys = (base + np.arange(n)).astype(np.uint32)
        untils = (10.0 + 0.25 * np.arange(n)).astype(np.float32)
        return BlacklistUpdate(key=keys, until_s=untils)

    t0 = time.perf_counter()
    a.publish(update(40, 1000), now=1.0)   # 5 wires; peer stalled
    a.publish(update(40, 2000), now=2.0)   # 5 more into a full box
    publish_wall = time.perf_counter() - t0
    b.tick(force=True)                      # peer resumes: merges 4
    a.publish(update(8, 3000), now=3.0)    # 1 wire; lands after gap
    b.tick(force=True)
    ra, rb = a.report(), b.report()
    # expected delivered set: the first `slots` wires of round 1
    # (32 keys) + the round-3 wire (8 keys), last-wins
    expected = {}
    for upd in (update(40, 1000), ):
        ks = np.asarray(upd.key, np.uint32)[:slots * k_max]
        us = np.asarray(upd.until_s, np.float32)[:slots * k_max]
        expected.update(zip(ks.tolist(),
                            us.view(np.uint32).tolist()))
    u3 = update(8, 3000)
    expected.update(zip(np.asarray(u3.key, np.uint32).tolist(),
                        np.asarray(u3.until_s, np.float32)
                        .view(np.uint32).tolist()))
    del rng
    invs = [
        check("gossip_drop_counted_never_blocks",
              ra["tx_dropped"] == 6 and ra["tx_wires"] == 5
              and publish_wall < 0.5,
              f"11 wires published: {ra['tx_wires']} delivered, "
              f"{ra['tx_dropped']} dropped; flood publish wall "
              f"{publish_wall * 1e3:.1f} ms"),
        check("counters_conserved",
              ra["tx_wires"] + ra["tx_dropped"] == 11
              and rb["rx_wires"] == ra["tx_wires"],
              "drops + merges account every publish"),
        check("seq_gap_counted", rb["rx_seq_gaps"] >= 1,
              f"rx_seq_gaps={rb['rx_seq_gaps']} (the dropped wires' "
              "hole in the sequence space)"),
        check("gossip_delivered_converges",
              rb["merged_digest"] == gplane.map_digest(expected),
              f"merged digest {rb['merged_digest']} == last-wins of "
              f"the {len(expected)} delivered sources"),
    ]
    return _scenario("gossip_stall_flood", invs)


def scenario_clock_jump(rng: np.random.Generator) -> dict:
    """Feed the latency plane stage intervals derived from a clock
    that jumped backwards: negatives must be counted (the stamp-
    monotonicity gauge), percentiles must stay finite and ordered,
    and nothing may raise."""
    from flowsentryx_tpu_torch.engine.metrics import LatencyRecorder

    stamps = faults.jumped_stamps(rng, 64)
    lat = LatencyRecorder()
    neg_expected = 0
    for i in range(1, len(stamps)):
        dt = stamps[i] - stamps[i - 1]
        if dt < 0:
            neg_expected += 1
        lat.record(total_s=dt, staged_s=dt / 2, upload_s=0.0,
                   compute_s=dt / 4, sink_s=dt / 4, n=4)
    d = lat.to_dict()
    sv = d["seal_to_verdict"]
    pcts = [sv.get(k) for k in ("p50", "p90", "p99")]
    finite = all(p is not None and np.isfinite(p) and p >= 0
                 for p in pcts)
    ordered = pcts == sorted(pcts)
    invs = [
        check("clock_jump_counted_finite",
              d["negatives"] > 0 and finite and ordered,
              f"negatives={d['negatives']} (>= 1 injected jump, "
              f"{neg_expected} negative deltas), percentiles "
              f"{pcts} finite+ordered"),
        check("no_silent_verdict_loss",
              sv["n"] == 63 * 4,
              f"every record accounted: n={sv['n']}"),
    ]
    return _scenario("clock_jump", invs)


# ---------------------------------------------------------------------------
# network scenarios: the multi-host gossip leg (cluster/transport.py)
# ---------------------------------------------------------------------------

#: Host B's epoch predates host A's by this much in every pair below, so
#: every cross-host merge goes through the tx-epoch -> rx-epoch rebase (a
#: zero delta would pass with the rebase deleted; the
#: ``epoch_rebase_skipped`` plant shows the delta has teeth).
NET_EPOCH_DELTA_S = 250.0


class _CountSink:
    """A collecting sink that also counts what it applied:
    ``no_double_apply`` needs how many verdicts were APPLIED, not just
    the last-wins map."""

    def __init__(self):
        self.blocked: dict[int, float] = {}
        self.applies = 0
        self.applied_keys = 0

    def apply(self, update) -> None:
        self.applies += 1
        self.applied_keys += len(update.key)
        self.blocked.update(zip(update.key.tolist(),
                                update.until_s.tolist()))


def _net_pair(tmp: Path, name: str, k_max: int = 8,
              resync_s: float = 1000.0, **mbx_kw):
    """Two one-engine loopback 'hosts': real GossipPlanes over a real UDP
    NetMailbox pair, epochs NET_EPOCH_DELTA_S apart.  ``resync_s`` is
    inert by default, so a scenario sees exactly the packets it injects;
    the heal and loss scenarios turn it down."""
    from flowsentryx_tpu_torch.cluster import gossip as gplane
    from flowsentryx_tpu_torch.cluster.transport import NetMailbox

    mono = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
    wall = time.time_ns()
    d_ns = int(NET_EPOCH_DELTA_S * 1e9)
    na = NetMailbox(0, 0, mono, wall, k_max=k_max,
                    resync_interval_s=resync_s, **mbx_kw)
    nb = NetMailbox(1, 0, mono - d_ns, wall - d_ns, k_max=k_max,
                    resync_interval_s=resync_s, **mbx_kw)
    na.add_peer((1, 0), nb.addr)
    nb.add_peer((0, 0), na.addr)
    planes = []
    for h, net in ((0, na), (1, nb)):
        d = tmp / f"{name}_h{h}"
        gplane.create_plane(d, 1, k_max=k_max, net=True)
        planes.append(gplane.GossipPlane(
            d, 0, 1, sink=_CountSink(), merge_interval_s=0.0, net=net))
    return planes[0], planes[1]


def _local_now(plane) -> float:
    return (time.clock_gettime_ns(time.CLOCK_MONOTONIC)
            - plane.net.t0_ns) * 1e-9


def _nupd(plane, base: int, n: int):
    """One publisher-local update: keys ``base..base+n``, untils 10 s out
    on the PUBLISHER's clock (so ~10 s out on the receiver's, rebased)."""
    from flowsentryx_tpu_torch.engine.writeback import BlacklistUpdate

    ln = _local_now(plane)
    return BlacklistUpdate(
        key=(base + np.arange(n)).astype(np.uint32),
        until_s=(ln + 10.0 + 0.25 * np.arange(n)).astype(np.float32))


def _mk_wire(keys, untils, k: int, now: float = 0.0) -> np.ndarray:
    """One raw [2K+4] wire, its ``now`` word stamped in the SENDER's
    epoch (a zero ``now`` from an offset peer is the lying-epoch shape
    the skew bound refuses, so honest wires must stamp it)."""
    w = np.zeros(2 * k + 4, np.uint32)
    keys = np.asarray(keys, np.uint32)
    untils = np.asarray(untils, np.float32)
    w[:len(keys)] = keys
    w[k:k + len(untils)] = untils.view(np.uint32)
    w[2 * k] = len(keys)
    w[2 * k + 3] = np.float32(now).view(np.uint32)
    return w


def _digests(a, b) -> tuple[str, str]:
    from flowsentryx_tpu_torch.cluster.transport import map_digest

    return map_digest(a.net.net_map), map_digest(b.net.net_map)


def _close_pair(a, b) -> None:
    a.net.close()
    b.net.close()


def scenario_net_partition(tmp: Path, rng: np.random.Generator) -> dict:
    """Cut the wire between two converged hosts mid-publish: the
    publisher must not block (a partitioned peer is a mailbox that
    drops, not a coordinator that stalls), and what was delivered before
    the cut stays converged."""
    del rng
    a, b = _net_pair(tmp, "net_part")
    try:
        a.publish(_nupd(a, 1000, 12), now=_local_now(a))
        deadline = time.monotonic() + 5.0
        while (_digests(a, b)[0] != _digests(a, b)[1]
               or not b.net.net_map):
            a.tick(force=True)
            b.tick(force=True)
            if time.monotonic() > deadline:
                break
            time.sleep(0.005)
        pre_a, pre_b = _digests(a, b)
        pre_applied = b.sink.applied_keys
        chaos = faults.NetChaos(a.net)
        chaos.partition()
        t0 = time.perf_counter()
        a.publish(_nupd(a, 2000, 20), now=_local_now(a))
        for _ in range(5):
            a.tick(force=True)
            b.tick(force=True)
        cut_wall = time.perf_counter() - t0
        post_a, post_b = _digests(a, b)
        chaos.uninstall()
        invs = [
            check("net_partition_fail_open",
                  cut_wall < 0.5 and chaos.dropped >= 3
                  and b.sink.applied_keys == pre_applied,
                  f"publish+5 ticks into the cut took "
                  f"{cut_wall * 1e3:.1f} ms, {chaos.dropped} "
                  "datagram(s) eaten, nothing leaked through"),
            check("gossip_delivered_converges",
                  pre_a == pre_b and post_b == pre_b,
                  f"pre-cut digests converged ({pre_b}) and B's view "
                  "is untouched by the cut"),
            check("fail_open_holds",
                  post_a != pre_a and len(a.net.net_map) == 32,
                  "A kept publishing into its own map during the "
                  "cut (serving never waited on the network)"),
        ]
        return _scenario("net_partition", invs,
                         cut_wall_ms=round(cut_wall * 1e3, 2))
    finally:
        _close_pair(a, b)


def scenario_net_heal(tmp: Path, rng: np.random.Generator) -> dict:
    """Publish INTO a partition (every wire lost), then heal: the
    anti-entropy resync must bring the canonical digests together
    within a bounded number of gossip ticks, with no retransmit protocol
    and no operator."""
    del rng
    a, b = _net_pair(tmp, "net_heal", resync_s=0.05)
    try:
        chaos = faults.NetChaos(a.net)
        chaos.partition()
        a.publish(_nupd(a, 3000, 12), now=_local_now(a))
        for _ in range(3):
            a.tick(force=True)
            b.tick(force=True)
        lost = chaos.dropped
        da, db = _digests(a, b)
        in_cut_ok = da != db and not b.net.net_map
        chaos.heal()
        ticks = None
        for i in range(80):
            a.tick(force=True)
            b.tick(force=True)
            da, db = _digests(a, b)
            if da == db and b.net.net_map:
                ticks = i + 1
                break
            time.sleep(0.01)
        chaos.uninstall()
        invs = [
            check("net_heal_converges",
                  ticks is not None and ticks <= 60
                  and len(b.net.net_map) == 12,
                  f"digests re-converged ({db}) {ticks} tick(s) after "
                  f"heal; {lost} wire(s) had been eaten by the cut"),
            check("net_loss_accounted", lost >= 1 and in_cut_ok,
                  f"{lost} datagram(s) provably lost in the cut, B "
                  "empty until heal"),
        ]
        return _scenario("net_heal", invs, ticks_to_converge=ticks)
    finally:
        _close_pair(a, b)


def scenario_net_reorder(tmp: Path, rng: np.random.Generator) -> dict:
    """Two legs.  (1) Reordered datagrams deliver in per-peer sequence
    order through the bounded buffer.  (2) Packets sent one at a time
    around a hole that never fills must never grow the buffer past its
    window: the overflow evicts and counts instead of stalling."""
    del rng
    from flowsentryx_tpu_torch.cluster import transport
    from flowsentryx_tpu_torch.core import wire

    window = 4
    a, b = _net_pair(tmp, "net_reorder", reorder_window=window)
    try:
        # leg 1: 8 wires flushed in reversed chunks of 4
        chaos = faults.NetChaos(b.net)
        chaos.reorder(depth=4)
        ln = _local_now(b)
        for j in range(8):
            b.net.queue_tx(
                _mk_wire([5000 + j], [ln + 10.0 + j], 8, now=ln), 1)
            b.net.pump()
        chaos.uninstall()
        time.sleep(0.02)
        a.net.pump()
        got = a.net.pop_wires(64)
        seqs = [seq for _s, seq, *_ in got]
        ordered = seqs == sorted(seqs) and len(seqs) == 8
        leg1_ok = (ordered and a.net.rx_dup == 0
                   and a.net.reorder_evict == 0
                   and chaos.reordered == 8)
        # leg 2: seqs 15..10 one at a time (hole at 9): the buffer caps
        # at `window`, then concedes and counts
        buf = a.net._rx_state[(1, 0)]["buf"]
        bounded = True
        sock = transport.socket.socket(transport.socket.AF_INET,
                                       transport.socket.SOCK_DGRAM)
        try:
            for s in range(15, 9, -1):
                pkt = transport.pack_packet(
                    wire.NET_KIND_WIRE, 1, 0, s, 1, b.net.t0_wall_ns,
                    _mk_wire([6000 + s], [ln + 20.0], 8, now=ln))
                sock.sendto(pkt, a.net.addr)
                time.sleep(0.005)
                a.net.pump()
                bounded = bounded and len(buf) <= window
        finally:
            sock.close()
        invs = [
            check("net_reorder_bounded",
                  leg1_ok and bounded and a.net.reorder_evict >= 1
                  and a.net.rx_gap >= 1,
                  f"8 reordered wires delivered as seqs {seqs}; "
                  f"buffer stayed <= {window} under a never-filling "
                  f"hole (evictions={a.net.reorder_evict}, "
                  f"gap={a.net.rx_gap})"),
            check("seq_gap_counted", a.net.rx_gap >= 1,
                  "the conceded hole surfaced in rx_gap, not as "
                  "silence"),
        ]
        return _scenario("net_reorder", invs, delivered_seqs=seqs)
    finally:
        _close_pair(a, b)


def scenario_net_duplicate(tmp: Path, rng: np.random.Generator) -> dict:
    """Every datagram delivered twice: duplicate suppression counts and
    drops the copies, and a verdict reaches the sink exactly once (the
    ``dup_suppression_removed`` plant runs this path with the
    suppression bypassed and must see this FAIL)."""
    del rng
    a, b = _net_pair(tmp, "net_dup")
    try:
        chaos = faults.NetChaos(b.net)
        chaos.duplicate()
        b.publish(_nupd(b, 7000, 12), now=_local_now(b))
        b.tick(force=True)
        chaos.uninstall()
        time.sleep(0.02)
        a.tick(force=True)
        da, db = _digests(a, b)
        invs = [
            check("no_double_apply",
                  a.sink.applied_keys == 12 and a.net.rx_wires == 2
                  and a.net.rx_dup == 2 and chaos.duplicated == 2,
                  f"2 wires sent twice: {a.net.rx_wires} delivered, "
                  f"{a.net.rx_dup} duplicate(s) suppressed, "
                  f"{a.sink.applied_keys} verdict(s) applied (== 12 "
                  "unique)"),
            check("gossip_delivered_converges", da == db,
                  f"digests byte-identical through the duplication "
                  f"({da})"),
        ]
        return _scenario("net_duplicate", invs)
    finally:
        _close_pair(a, b)


def scenario_net_loss_burst(tmp: Path, rng: np.random.Generator) -> dict:
    """Drop a contiguous burst of wires silently: the holes are conceded
    and counted (rx_gap) within the reorder timeout so the survivors
    deliver, and the resync then closes the hole."""
    burst_at = int(rng.integers(1, 4))
    # the resync stays inert through the burst (a resync wire through the
    # chaos seam mid-burst would shift the dropped indices); the heal
    # below turns it on
    a, b = _net_pair(tmp, "net_loss", reorder_timeout_s=0.05)
    try:
        chaos = faults.NetChaos(b.net)
        chaos.drop_burst(burst_at, 3)
        ln = _local_now(b)
        for j in range(8):
            b.net.queue_tx(
                _mk_wire([8000 + j], [ln + 10.0 + j], 8, now=ln), 1)
            b.net.pump()
        time.sleep(0.02)
        a.tick(force=True)
        survivors_early = a.sink.applied_keys
        time.sleep(0.08)   # past the reorder timeout: concede the holes
        a.tick(force=True)
        gap = a.net.rx_gap
        delivered = a.net.rx_wires
        conceded_ok = (gap == 3 and delivered == 5
                       and a.net.gap_timeouts >= 1
                       and survivors_early >= 1)
        chaos.uninstall()
        # the resync closes the hole (on only now; one thread, both
        # fields the merge section's)
        for net in (a.net, b.net):
            net.resync_interval_s = 0.15
            net._next_resync = 0.0
        converged = False
        for _ in range(60):
            b.tick(force=True)
            a.tick(force=True)
            da, db = _digests(a, b)
            if da == db and len(a.net.net_map) == 8:
                converged = True
                break
            time.sleep(0.01)
        invs = [
            check("net_loss_accounted", conceded_ok,
                  f"8 sent, burst of 3 eaten at index {burst_at}: "
                  f"{delivered} delivered + {gap} conceded-and-"
                  f"counted == 8 (gap_timeouts="
                  f"{a.net.gap_timeouts})"),
            check("net_heal_converges", converged,
                  "the anti-entropy resync closed the hole "
                  f"(digest {_digests(a, b)[0]}, 8 sources)"),
        ]
        return _scenario("net_loss_burst", invs, burst_index=burst_at)
    finally:
        _close_pair(a, b)


def scenario_net_stale_epoch(tmp: Path,
                             rng: np.random.Generator) -> dict:
    """A peer publishing under a LYING epoch stamp (its pre-reboot
    t0_wall, hours stale): the rebased skew bound refuses and counts
    every wire, and still accepts a truthful wire from the same peer
    (the bound discriminates, it does not censor)."""
    skew_s = float(3600.0 + 1800.0 * rng.random())
    from flowsentryx_tpu_torch.cluster import transport
    from flowsentryx_tpu_torch.core import wire

    a, b = _net_pair(tmp, "net_stale")
    try:
        pkts = faults.stale_epoch_packets(
            1, 0, b.net.t0_wall_ns, skew_s,
            keys=[9001, 9002, 9003], untils=[10.0, 11.0, 12.0],
            k_max=8, start_seq=1)
        sock = transport.socket.socket(transport.socket.AF_INET,
                                       transport.socket.SOCK_DGRAM)
        try:
            for p in pkts:
                sock.sendto(p, a.net.addr)
            time.sleep(0.02)
            a.tick(force=True)
            refused = (a.net.epoch_skew_dropped == len(pkts)
                       and a.sink.applied_keys == 0
                       and not a.net.net_map)
            skew_seen = a.net.epoch_skew_max
            # control: a truthful wire from the same peer is accepted
            ln_b = ((time.clock_gettime_ns(time.CLOCK_MONOTONIC)
                     - b.net.t0_ns) * 1e-9)
            w = _mk_wire([9100], [ln_b + 10.0], 8)
            w[2 * 8 + 3] = np.float32(ln_b).view(np.uint32)
            sock.sendto(transport.pack_packet(
                wire.NET_KIND_WIRE, 1, 0, len(pkts) + 1, 1,
                b.net.t0_wall_ns, w), a.net.addr)
            time.sleep(0.02)
            a.tick(force=True)
        finally:
            sock.close()
        # the liar's wire `now` is its post-reboot clock (~0) while its
        # stamp predates even B's epoch, so the observed skew is the
        # injected lie PLUS the pair's epoch delta
        skew_expect = skew_s + NET_EPOCH_DELTA_S
        invs = [
            check("stale_epoch_refused",
                  refused and abs(skew_seen - skew_expect) < 60.0,
                  f"{len(pkts)} lying-epoch wire(s) refused-and-"
                  f"counted (epoch_skew_max {skew_seen:.0f}s ~ "
                  f"expected {skew_expect:.0f}s), none applied"),
            check("epoch_rebase_exact",
                  a.sink.applied_keys == 1
                  and abs((a.sink.blocked[9100]
                           + a.net.t0_wall_ns * 1e-9)
                          - (10.0 + ln_b
                             + b.net.t0_wall_ns * 1e-9)) < 0.01,
                  "the truthful control wire was accepted and its "
                  "ABSOLUTE expiry survived the rebase"),
        ]
        return _scenario("net_stale_epoch", invs,
                         injected_skew_s=round(skew_s, 1))
    finally:
        _close_pair(a, b)


# ---------------------------------------------------------------------------
# elastic-fleet scenarios: a live shard handoff under its worst interruptions
# ---------------------------------------------------------------------------

def _handoff_rows(rng: np.random.Generator, n: int):
    """``n`` occupied table rows: unique nonzero u32 keys and a full f32
    state matrix."""
    from flowsentryx_tpu_torch.core import wire

    keys = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), n,
                      replace=False).astype(np.uint32)
    states = rng.random((n, wire.NUM_TABLE_COLS)).astype(np.float32)
    return keys, states


def scenario_handoff_kill_midship(tmp: Path,
                                  rng: np.random.Generator) -> dict:
    """SIGKILL a REAL donor process mid-stream: a child ships 1000 rows
    over a real shm handoff mailbox (one slot every ~30 ms) and the
    parent kills it at a seeded point of the stream.  The recipient must
    refuse the unsealed stream (no STAGED ack, no row inserted) and the
    donor's copy must still account every row (it never stopped owning
    the span): rows in flight, nothing committed."""
    import os
    import signal
    import subprocess
    import sys

    import flowsentryx_tpu_torch
    from flowsentryx_tpu_torch.cluster import rebalance as rb

    keys, states = _handoff_rows(rng, 1000)
    rows_npz = tmp / "midship_rows.npz"
    np.savez(rows_npz, keys=keys, states=states)
    mbx_path = str(tmp / "midship.mbx")
    # 64-row slots: a 1000-row stream is ~16 slots, wide enough to kill
    # inside
    mbx = rb.HandoffMailbox.create(mbx_path, slots=64, rows_per_slot=64)
    kill_after = int(rng.integers(2, 6))
    child_src = (
        "import sys, time\n"
        "import numpy as np\n"
        "from flowsentryx_tpu_torch.cluster import rebalance as rb\n"
        "d = np.load(sys.argv[1])\n"
        "mbx = rb.HandoffMailbox(sys.argv[2])\n"
        "rb.ship_rows(mbx, d['keys'], d['states'],\n"
        "             on_slot=lambda i, n: time.sleep(0.03))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(
        Path(flowsentryx_tpu_torch.__file__).parent.parent)
    child = subprocess.Popen(
        [sys.executable, "-c", child_src, str(rows_npz), mbx_path],
        env=env)
    deadline = time.monotonic() + 30.0
    while mbx.readable() < kill_after:
        if child.poll() is not None or time.monotonic() > deadline:
            break
        time.sleep(0.005)
    child.send_signal(signal.SIGKILL)
    rc = child.wait()
    shipped = mbx.readable()
    # the recipient drains what arrived, then the stream stays quiet:
    # what an unsealed stream looks like
    recv = rb.HandoffReceiver()
    for _ in range(10):
        recv.drain(mbx)
        time.sleep(0.01)
    got_keys, _got_states = recv.rows()
    # the donor died before the flip: its copy is the post-state
    conserved = rb.rows_conserved((keys, states), [(keys, states)])
    invs = [
        check("handoff_rows_conserved",
              conserved["ok"] and not recv.done and not recv.ok,
              f"donor killed (rc={rc}) after {shipped} slot(s): "
              f"stream never sealed (done={recv.done}), the "
              f"{len(got_keys)} staged row(s) may never be inserted, "
              f"donor copy accounts {conserved['pre_rows']} == "
              f"{conserved['post_rows']} rows"),
        check("fail_open_holds",
              rc == -signal.SIGKILL and 0 < shipped < 17,
              f"the kill landed mid-stream: {shipped} of ~17 slots "
              "shipped, then silence — no crash leaked to the "
              "recipient side"),
    ]
    return _scenario("handoff_kill_midship", invs,
                     kill_after_slots=kill_after,
                     shipped_slots=int(shipped))


def scenario_layout_flip_lost(tmp: Path,
                              rng: np.random.Generator) -> dict:
    """Commit a REAL handoff through the REAL coordinator, then lose the
    layout flip to one bystander rank (it never acks the new
    generation).  The fence must NOT lift while it is missing, ticked
    repeatedly, and must lift completely on the late ack.  The harness
    plays the engines: their acks are plain status-block writes."""
    del rng
    from flowsentryx_tpu_torch.cluster import rebalance as rb
    from flowsentryx_tpu_torch.cluster.mailbox import (
        StatusBlock, status_path,
    )
    from flowsentryx_tpu_torch.cluster.runner import stub_engine_main
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.core import wire

    sup = ClusterSupervisor(
        tmp / "flip_cl",
        [{"stub_serve_s": 30.0, "workers": 1},
         {"stub_serve_s": 30.0, "workers": 1},
         {"stub_serve_s": 30.0, "workers": 1}],
        entry=stub_engine_main)
    sup.boot()
    try:
        st = [StatusBlock(status_path(tmp / "flip_cl", r))
              for r in range(3)]
        hid = sup.start_handoff([2], donor=2, recipient=0)
        to_gen = sup._handoff["to_gen"]
        fenced = (st[2].ctl_get("c_fence") == hid
                  and st[0].ctl_get("c_fence") == hid)
        # the harness plays both parties: shipped, staged
        st[2].ctl_set("c_handoff", hid * 8 + wire.HP_SHIPPED)
        st[0].ctl_set("c_handoff", hid * 8 + wire.HP_STAGED)
        sup.poll()
        committed = (sup._handoff is not None
                     and sup._handoff["phase"] == "committing"
                     and rb.ShardAssignment.load(
                         tmp / "flip_cl").generation == to_gen)
        # ranks 0 and 2 converge; rank 1's flip is lost
        st[0].ctl_set("c_layout_ack", to_gen)
        st[2].ctl_set("c_layout_ack", to_gen)
        held = True
        for _ in range(8):
            sup.poll()
            held = (held and sup._handoff is not None
                    and st[0].ctl_get("c_fence") == hid)
            time.sleep(0.01)
        # the late ack (in a fleet: the respawn's reconcile)
        st[1].ctl_set("c_layout_ack", to_gen)
        sup.poll()
        lifted = (sup._handoff is None
                  and all(s.ctl_get("c_fence") == 0 for s in st)
                  and sup.rebalance_counters["flips"] == 1
                  and not rb.handoff_json_path(tmp / "flip_cl").exists())
        owners = rb.ShardAssignment.load(tmp / "flip_cl").owners
        invs = [
            check("layout_flip_converges",
                  fenced and committed and held and lifted,
                  f"fence {hid} stamped on both parties, commit wrote "
                  f"generation {to_gen}, the fence HELD through 8 "
                  "ticks with rank 1's ack missing, and lifted "
                  "completely on the late ack"),
            check("counters_conserved",
                  owners[2] == 0 and list(owners[:2]) == [0, 1],
                  f"shard 2 reassigned to rank 0 exactly once "
                  f"(owners={list(owners)})"),
        ]
        return _scenario("layout_flip_lost", invs, to_gen=to_gen)
    finally:
        sup.close()


def scenario_adopt_half_dead(tmp: Path,
                             rng: np.random.Generator) -> dict:
    """Supervisor A boots a 2-rank stub fleet, rank 1 is SIGKILLed and A
    stops supervising.  Supervisor B boots with ``adopt=True``: its
    census must adopt rank 0 untouched (never a second consumer of a
    span a live rank drains), respawn rank 1 at gen+1 from its
    checkpoint, and run the fleet to completion with every generation
    accounted once."""
    del rng
    from flowsentryx_tpu_torch.cluster.mailbox import (
        StatusBlock, status_path,
    )
    from flowsentryx_tpu_torch.cluster.runner import stub_engine_main
    from flowsentryx_tpu_torch.cluster.supervisor import ClusterSupervisor
    from flowsentryx_tpu_torch.core import wire

    d = tmp / "adopt_cl"
    ck = tmp / "adopt_ck_r1.npz"
    ck.write_bytes(b"stub flow memory")
    # a long serve: B's stop-drain ends the scenario, so rank 0 is still
    # serving at the census
    specs = [{"stub_serve_s": 60.0, "workers": 1},
             {"stub_serve_s": 60.0, "checkpoint": str(ck), "workers": 1}]
    sup_a = ClusterSupervisor(d, specs, entry=stub_engine_main)
    sup_a.boot()
    st = [StatusBlock(status_path(d, r)) for r in range(2)]
    deadline = time.monotonic() + 60.0
    # the census judges liveness by pid AND heartbeat: wait for the first
    # tick's c_hbeat, not just SERVING
    while not all(s.ctl_get("c_state") == wire.CSTATE_SERVING
                  and s.ctl_get("c_pid") and s.ctl_get("c_hbeat")
                  for s in st):
        if time.monotonic() > deadline:
            raise TimeoutError("stub fleet never reached SERVING")
        time.sleep(0.01)
    faults.kill_process_group(sup_a._procs[1].pid)
    sup_a._procs[1].join(timeout=10.0)  # reaped: the pid is gone
    # supervisor A is now 'dead': it never polls again
    sup_b = ClusterSupervisor(d, specs, entry=stub_engine_main)
    sup_b.boot(adopt=True)
    census_ok = (sup_b._adopted == {0} and sup_b.restarts[0] == 0
                 and sup_b.restarts[1] == 1 and sup_b._gen[1] == 1)
    try:
        agg = sup_b.run(max_seconds=1.0)  # stop-drain the fleet
    finally:
        sup_b.close()
        sup_a.close()
    r1 = [r for r in agg["reports"] if r["rank"] == 1]
    invs = [
        check("adopt_no_second_consumer",
              census_ok and agg.get("adopted_ranks") == [],
              f"census adopted rank 0 untouched, respawned only the "
              f"dead rank (restarts={sup_b.restarts}); the adopted "
              "rank drained to DONE and left the live-adopted set"),
        check("recovery_within_bound",
              bool(r1) and r1[0]["gen"] == 1
              and r1[0].get("restored") == str(ck),
              f"rank 1 re-served as gen 1 restored from its "
              f"checkpoint ({r1[0].get('restored') if r1 else None})"),
        check("counters_conserved",
              agg["failed_ranks"] == []
              and len({(r['rank'], r['gen'])
                       for r in agg["reports"]})
              == len(agg["reports"]),
              f"restarts={agg['restarts']}, latest-gen dedup held"),
        check("fail_open_holds",
              st[0].ctl_get("c_gen") == 0,
              "rank 0 served start to finish as generation 0 — "
              "adoption never touched it"),
    ]
    return _scenario("adopt_half_dead", invs)


# ---------------------------------------------------------------------------
# planted regressions (negative controls: the invariant must FAIL)
# ---------------------------------------------------------------------------

def plant_split_atomicity() -> dict:
    """Re-introduce the split-complete weakness the SinkChannel's
    atomic ``complete()`` exists to prevent: decrement pending and
    record the crash under SEPARATE lock acquisitions.  A waiter
    observing between them sees (pending drained, crash unset) — the
    silent-verdict-loss window.  ``sink_crash_atomicity`` must FAIL
    under the plant and HOLD for the real protocol."""
    from flowsentryx_tpu_torch.sync.channel import SinkChannel

    # plant: the split sequence, observed at its midpoint
    chan = SinkChannel("sink thread")
    chan.submit("group", 1)
    with chan.cv:
        chan._pending -= 1
        chan.cv.notify_all()
    with chan.cv:  # a woken backpressure waiter's view, mid-split
        planted_bad = (chan._pending == 0 and chan._exc is None)
    with chan.cv:
        chan._exc = RuntimeError("worker crashed")
        chan.cv.notify_all()
    planted = check(
        "sink_crash_atomicity", not planted_bad,
        "under the split plant a waiter observed (pending drained, "
        "crash unset)")
    # control: the real atomic complete() on the same protocol object
    chan2 = SinkChannel("sink thread")
    chan2.submit("group", 1)
    chan2.complete(1, 0.0, RuntimeError("worker crashed"))
    with chan2.cv:
        control_ok = not (chan2._pending == 0 and chan2._exc is None)
    return {
        "plant": "split_atomicity",
        "reintroduces": "split crash accounting "
                        "(SinkChannel.complete's atomicity removed)",
        "caught_by": "sink_crash_atomicity",
        "caught": not planted.ok,
        "control_holds": bool(control_ok),
        "ok": (not planted.ok) and bool(control_ok),
    }


def plant_crc_skipped(tmp: Path, rng: np.random.Generator) -> dict:
    """Strip the integrity member and flip a value — the CRC-less
    format.  The file is a perfectly valid zip, so the structural
    checks pass and ``corrupt_ckpt_refused`` FAILS: exactly the silent
    load the CRC exists to prevent (pre-CRC snapshots load by
    documented choice; new writes always carry the CRC)."""
    from flowsentryx_tpu_torch.engine import checkpoint as ckpt

    p = _tiny_snapshot(tmp, "snap_plant_crc")
    with np.load(p) as z:
        data = {k: np.array(z[k]) for k in z.files
                if k != "integrity_crc32"}
    data["table_key"] = data["table_key"].copy()
    data["table_key"][int(rng.integers(0, 256))] ^= 1
    np.savez_compressed(p, **data)
    refused = False
    try:
        ckpt.load_checkpoint(p)
    except ckpt.CheckpointCorrupt:
        refused = True
    return {
        "plant": "crc_skipped",
        "reintroduces": "CRC-less checkpoint loads (the corrupt file "
                        "decompresses cleanly and loads silently)",
        "caught_by": "corrupt_ckpt_refused",
        "caught": not refused,
        "ok": not refused,
    }


def plant_backoff_removed(tmp: Path, rng: np.random.Generator) -> dict:
    """Disable the sliding window (every death sees an empty window,
    so the rank ALWAYS respawns): the crash-loop scenario's
    ``crash_loop_parks`` invariant must FAIL — the rank burns past its
    budget instead of parking."""
    res = scenario_crash_loop(tmp / "plant_backoff", rng,
                              window_s=0.0, backoff_s=0.02,
                              max_restarts=2, name="plant_backoff")
    parks = next(i for i in res["invariants"]
                 if i["name"] == "crash_loop_parks")
    return {
        "plant": "backoff_removed",
        "reintroduces": "unbounded respawn (no sliding-window budget: "
                        "a crash-looping rank never parks)",
        "caught_by": "crash_loop_parks",
        "caught": not parks["ok"],
        "ok": not parks["ok"],
        "detail": parks["detail"],
    }


def plant_dup_suppression_removed(tmp: Path,
                                  rng: np.random.Generator) -> dict:
    """Re-introduce raw datagram delivery: every received copy straight
    to the sink, no sequence suppression (``NetMailbox._accept`` called
    per COPY, the receive path with ``_rx_wire``'s discipline deleted).
    ``no_double_apply`` must FAIL under the plant and HOLD for the real
    path on the same duplicated traffic."""
    del rng
    a, b = _net_pair(tmp, "plant_dup")
    try:
        ln_b = _local_now(b)
        w = _mk_wire([9901, 9902], [ln_b + 10.0, ln_b + 11.0], 8)
        w[2 * 8 + 3] = np.float32(ln_b).view(np.uint32)
        # control: the same duplicate through the REAL receive path
        a.net._rx_wire((1, 0), 1, 2, b.net.t0_wall_ns, w.copy())
        a.net._rx_wire((1, 0), 1, 2, b.net.t0_wall_ns, w.copy())
        control_applied = sum(
            len(keys) for _s, _q, _w, keys, _u in a.net.pop_wires(16))
        control_ok = control_applied == 2 and a.net.rx_dup == 1
        # plant: suppression removed, each copy delivered
        a.net._accept((1, 0), 7, 2, b.net.t0_wall_ns, w.copy())
        a.net._accept((1, 0), 7, 2, b.net.t0_wall_ns, w.copy())
        planted_applied = sum(
            len(keys) for _s, _q, _w, keys, _u in a.net.pop_wires(16))
        caught = planted_applied > 2  # the double apply happened
        return {
            "plant": "dup_suppression_removed",
            "reintroduces": "raw datagram delivery with the per-peer "
                            "u64-seq duplicate suppression deleted "
                            "(a resent/reflected wire re-applies)",
            "caught_by": "no_double_apply",
            "caught": caught,
            "control_holds": bool(control_ok),
            "ok": caught and bool(control_ok),
            "detail": f"planted path applied {planted_applied} "
                      f"verdicts for 2 unique; real path applied "
                      f"{control_applied} with rx_dup=1",
        }
    finally:
        _close_pair(a, b)


def plant_epoch_rebase_skipped(tmp: Path,
                               rng: np.random.Generator) -> dict:
    """Re-introduce the single-host assumption across hosts: merge a
    peer's untils RAW, as if both monotonic epochs were one.  With the
    pair's NET_EPOCH_DELTA_S the planted verdict's absolute expiry is off
    by that delta, so ``epoch_rebase_exact`` must FAIL; the real
    ``_accept`` holds within f32 quantization on the same wire."""
    del rng
    a, b = _net_pair(tmp, "plant_epoch")
    try:
        ln_b = _local_now(b)
        until_b = ln_b + 10.0
        w = _mk_wire([9950], [until_b], 8)
        w[2 * 8 + 3] = np.float32(ln_b).view(np.uint32)
        abs_true = until_b + b.net.t0_wall_ns * 1e-9

        def abs_err(until_on_a: float) -> float:
            return abs((until_on_a + a.net.t0_wall_ns * 1e-9) - abs_true)

        # control: the real rebase
        a.net._rx_wire((1, 0), 1, 1, b.net.t0_wall_ns, w.copy())
        [(_, _, _, _, untils)] = a.net.pop_wires(4)
        control_err = abs_err(float(untils[0]))
        # plant: the rebase skipped, the raw f32 until read in A's epoch
        planted_err = abs_err(float(w[8:9].view(np.float32)[0]))
        caught = planted_err > 1.0
        return {
            "plant": "epoch_rebase_skipped",
            "reintroduces": "cross-host merge without the tx-epoch -> "
                            "rx-epoch rebase (the single-host "
                            "byte-identical-untils assumption applied "
                            "across hosts)",
            "caught_by": "epoch_rebase_exact",
            "caught": caught,
            "control_holds": bool(control_err < 0.01),
            "ok": caught and control_err < 0.01,
            "detail": f"planted absolute-expiry error "
                      f"{planted_err:.1f}s (~ the "
                      f"{NET_EPOCH_DELTA_S:.0f}s epoch delta); real "
                      f"rebase error {control_err * 1e3:.2f} ms",
        }
    finally:
        _close_pair(a, b)


def plant_conservation_removed(tmp: Path,
                               rng: np.random.Generator) -> dict:
    """Delete the handoff stream's verification: stage whatever arrived
    without checking the SEAL (the recipient's ``ok`` gate removed).  One
    flipped payload word in flight then inserts a row the donor never
    owned — ``handoff_rows_conserved`` must FAIL on the staged rows,
    while the real gate (``HandoffReceiver.ok``) refuses the same tamper
    through the stream CRC."""
    from flowsentryx_tpu_torch.cluster import rebalance as rb
    from flowsentryx_tpu_torch.core import wire

    keys, states = _handoff_rows(rng, 256)
    mbx = rb.HandoffMailbox.create(tmp / "plant_conserve.mbx",
                                   slots=16, rows_per_slot=64)
    rb.ship_rows(mbx, keys, states)
    # one bit flips in flight: a payload word of a published, undrained
    # ROWS cell
    word = int(rng.integers(0, 64 * rb.ROW_WORDS))
    mbx._cells[0][wire.HANDOFF_SLOT_HDR_WORDS + word] ^= 1
    recv = rb.HandoffReceiver()
    while not recv.done:
        recv.drain(mbx)
    control_ok = recv.done and not recv.ok and "CRC" in recv.detail
    # plant: the ok gate removed — the staged rows insert anyway
    conserved = rb.rows_conserved((keys, states), [recv.rows()])
    caught = not conserved["ok"]
    return {
        "plant": "conservation_removed",
        "reintroduces": "handoff staging without the SEAL "
                        "count+CRC verification (a corrupted "
                        "in-flight row inserts silently)",
        "caught_by": "handoff_rows_conserved",
        "caught": caught,
        "control_holds": bool(control_ok),
        "ok": caught and bool(control_ok),
        "detail": f"payload word {word} flipped: real receiver "
                  f"refused ({recv.detail}); unguarded staging "
                  f"broke conservation ({conserved['detail']})",
    }


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

def run_campaign(seed: int = 17, quick: bool = False,
                 workdir: str | Path | None = None,
                 out: str | Path | None = None,
                 device=None) -> dict:
    """Run every scenario + planted regression; return (and optionally
    write) the artifact: the reference's keys, each scenario's
    ``wall_s`` and the engine's ``device``.  ``quick`` trims the traffic
    volume, not the coverage.  ``device`` is the engine's: None means the card, and
    raises without one before any scenario runs."""
    import tempfile

    from flowsentryx_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    tmp = Path(workdir) if workdir else Path(
        tempfile.mkdtemp(prefix="fsx_chaos_"))
    tmp.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    results: list[dict] = []


    def run(fn, *args) -> None:
        t = time.perf_counter()
        res = fn(*args)
        res["wall_s"] = round(time.perf_counter() - t, 3)
        results.append(res)

    run(scenario_ckpt_truncate, tmp, rng)
    run(scenario_ckpt_bitflip, tmp, rng)
    run(scenario_engine_kill, tmp, rng)
    run(scenario_crash_loop, tmp, rng)
    run(scenario_gossip_stall_flood, tmp, rng)
    run(scenario_clock_jump, rng)

    # the multi-host gossip leg: loopback UDP pairs of real planes with
    # epochs 250 s apart — partition, heal, reorder, duplication, loss,
    # lying epochs
    run(scenario_net_partition, tmp, rng)
    run(scenario_net_heal, tmp, rng)
    run(scenario_net_reorder, tmp, rng)
    run(scenario_net_duplicate, tmp, rng)
    run(scenario_net_loss_burst, tmp, rng)
    run(scenario_net_stale_epoch, tmp, rng)

    # the elastic fleet: handoff, flip and adopt under interruption
    run(scenario_handoff_kill_midship, tmp, rng)
    run(scenario_layout_flip_lost, tmp, rng)
    run(scenario_adopt_half_dead, tmp, rng)

    # the real engine + fleet (one engine, three scenarios)
    n_records = 64 * (6 if quick else 24)
    eng, src, sink, recs = build_engine_fleet(tmp, rng, n_records,
                                              device=device)
    try:
        run(scenario_slot_corruption, eng, src, recs, rng, tmp)
        run(scenario_ckpt_fallback, eng, tmp, rng)
        run(scenario_watchdog, eng, rng)
    finally:
        src.close()

    planted = [
        plant_split_atomicity(),
        plant_crc_skipped(tmp, rng),
        plant_backoff_removed(tmp, rng),
        plant_dup_suppression_removed(tmp, rng),
        plant_epoch_rebase_skipped(tmp, rng),
        plant_conservation_removed(tmp, rng),
    ]

    fault_classes = sorted({r["fault_class"] for r in results})
    n_inv = sum(len(r["invariants"]) for r in results)
    ok = (all(r["ok"] for r in results)
          and all(p["ok"] for p in planted))
    artifact = {
        "seed": seed,
        "quick": bool(quick),
        "ok": ok,
        "wall_s": round(time.perf_counter() - t_start, 2),
        "fault_classes": fault_classes,
        "n_fault_classes": len(fault_classes),
        "invariants_checked": n_inv,
        "faults": results,
        "planted_regressions": planted,
        "registry": {k: {"class": c, "description": d}
                     for k, (c, d) in faults.FAULTS.items()},
        "device": str(device),
    }
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(artifact, indent=2) + "\n")
    return artifact
