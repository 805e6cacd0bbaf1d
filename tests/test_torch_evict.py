"""The port's in-step eviction sweep against the JAX reference.

The port's side of ``tests/test_table.py`` (``TestEvictionStep``,
``TestEngineEviction``) and ``tests/test_fused.py``
(``TestBatchesWrapEviction``): the evicting raw step in lockstep with
the reference's jitted one (table, stats with ``evicted``, outputs byte
for byte), the epoch against a numpy sweep composed with the sweepless
step, full-cycle coverage, blocked rows surviving, the u32 wrap of
``batches``, the warm batch as a no-op, ``mega_n="auto"`` with eviction,
and occupancy bounded under churn.  Capacity 2^12, B = 256.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core import schema as jschema
from flowsentryx_tpu.engine import ArraySource as JArraySource
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.models import get_model as jget_model
from flowsentryx_tpu.ops import fused as jfused
from flowsentryx_tpu_torch.core import config, schema
from flowsentryx_tpu_torch.core.schema import TableCol
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused

CAP, BATCH = 1 << 12, 256


def evict_cfg(ttl=2.0, every=1, cap=CAP, batch=BATCH, pkg=config, **lim):
    return pkg.FsxConfig(
        table=pkg.TableConfig(capacity=cap, stale_s=1e6, evict_ttl_s=ttl,
                              evict_every=every),
        batch=pkg.BatchConfig(max_batch=batch),
        limiter=pkg.LimiterConfig(**lim) if lim else pkg.LimiterConfig(
            pps_threshold=1e9, bps_threshold=1e18))


def mkbuf(keys, t_s, pkt_len=100):
    """Each key once at ``t_s`` seconds (1 µs apart)."""
    n = len(keys)
    buf = np.zeros(n, schema.FLOW_RECORD_DTYPE)
    buf["saddr"] = np.asarray(keys, np.uint32)
    buf["pkt_len"] = pkt_len
    buf["ts_ns"] = int(t_s * 1e9) + np.arange(n) * 1000
    buf["feat"][:, 0] = 80
    return buf


def churn_records(phases=8, per_phase=BATCH, gap_s=1.0, base=10_000):
    """Sustained churn: a fresh keyset per phase, ``gap_s`` apart."""
    return np.concatenate([
        mkbuf(base * (i + 1) + np.arange(per_phase), t_s=i * gap_s)
        for i in range(phases)])


def raw(buf):
    return schema.wire_to_tensor(schema.encode_raw(buf, BATCH, 0))


def _steps(ttl, every, **lim):
    cfg_e = evict_cfg(ttl=ttl, every=every, **lim)
    cfg_0 = dataclasses.replace(cfg_e, table=dataclasses.replace(
        cfg_e.table, evict_ttl_s=0.0))
    cls = get_model(cfg_e.model.name).classify_batch
    return (fused.make_raw_step(cfg_e, cls), fused.make_raw_step(cfg_0, cls),
            logreg.golden_params())


def _sweep_numpy(table, now, ttl):
    """The reference's host sweep: every idle, unblocked row freed."""
    k, st = schema.table_to_numpy(table)
    idle = (np.float32(now) - st[:, TableCol.LAST_SEEN]) > np.float32(ttl)
    keep = st[:, TableCol.BLOCKED_UNTIL] > np.float32(now)
    victim = (k != 0) & idle & ~keep
    out = schema.table_from_numpy(np.where(victim, 0, k),
                                  np.where(victim[:, None], 0.0, st))
    return out, int(victim.sum())


def test_evicting_raw_step_matches_reference_stream():
    """The evicting raw step and the reference's jitted one in lockstep
    over rotating keysets (``evict_every=4``, so the window rolls):
    table bytes, stats with ``evicted``, verdicts and wire after every
    batch."""
    jcfg = evict_cfg(ttl=2.5, every=4, pkg=jconfig)
    tcfg = evict_cfg(ttl=2.5, every=4)
    jstep = jfused.make_jitted_raw_step(
        jcfg, jget_model("logreg_int8").classify_batch, donate=False)
    tstep = fused.make_raw_step(tcfg, get_model("logreg_int8").classify_batch)
    jp = jget_model("logreg_int8").init()
    tp = logreg.golden_params()
    jt, js = jschema.make_table(CAP), jschema.make_stats()
    tt, ts = schema.make_table(CAP), schema.make_stats()
    for i in range(12):
        keys = 1000 * (i % 5 + 1) + np.arange(64 + 7 * i)
        r = schema.encode_raw(mkbuf(keys, t_s=0.7 * i), BATCH, 0)
        jt, js, jo = jstep(jt, js, jp, r)
        tt, ts, to = tstep(tt, ts, tp, schema.wire_to_tensor(r))
        key, state = schema.table_to_numpy(tt)
        np.testing.assert_array_equal(key, np.asarray(jt.key))
        np.testing.assert_array_equal(state.view(np.uint32),
                                      np.asarray(jt.state).view(np.uint32))
        np.testing.assert_array_equal(to.verdict.numpy(),
                                      np.asarray(jo.verdict))
        np.testing.assert_array_equal(to.wire.numpy().view(np.uint32),
                                      np.asarray(jo.wire))
        assert ts.to_dict() == {**{f: jschema.stat_value(getattr(js, f))
                                   for f in jschema.GlobalStats._fields},
                                "dropped": ts.to_dict()["dropped"]}
    assert ts.to_dict()["evicted"] > 0


def test_epoch_step_equals_reference_sweep():
    """The aging epoch == (numpy sweep o sweepless step), byte for byte."""
    ttl = 2.5
    step_e, step_0, params = _steps(ttl, every=1)
    t_e, s_e = schema.make_table(CAP), schema.make_stats()
    t_r, s_r = schema.make_table(CAP), schema.make_stats()
    total_ref = 0
    for i in range(6):
        r = raw(mkbuf(1000 * (i % 3 + 1) + np.arange(64), t_s=float(i)))
        _, _, out_e = step_e(t_e, s_e, params, r)
        t_r, n_ref = _sweep_numpy(t_r, float(out_e.now), ttl)
        total_ref += n_ref
        _, _, out_r = step_0(t_r, s_r, params, r)
        assert torch.equal(t_e.key, t_r.key)
        assert torch.equal(t_e.state.view(torch.int32),
                           t_r.state.view(torch.int32))
        assert torch.equal(out_e.verdict, out_r.verdict)
        e, rr = s_e.to_dict(), s_r.to_dict()
        assert {k: v for k, v in e.items() if k != "evicted"} == \
            {k: v for k, v in rr.items() if k != "evicted"}
    assert total_ref > 0
    assert s_e.to_dict()["evicted"] == total_ref


def test_full_cycle_sweeps_every_idle_row():
    step_e, _, params = _steps(ttl=0.5, every=4)
    t, s = schema.make_table(CAP), schema.make_stats()
    step_e(t, s, params, raw(mkbuf(8000 + np.arange(64), t_s=0.0)))
    old = set(8000 + np.arange(64))
    n_tracked = int((t.key != 0).sum())
    for i in range(1, 5):           # windows 1, 2, 3, 0: a full cycle
        step_e(t, s, params, raw(mkbuf(5000 + 100 * i + np.arange(32),
                                       t_s=5.0 + 0.1 * i)))
    keys = set(int(k) for k in schema.table_to_numpy(t)[0] if k)
    assert not keys & old
    assert s.to_dict()["evicted"] == n_tracked


def test_blocked_rows_survive_until_expiry():
    step, _, params = _steps(ttl=1.0, every=1, pps_threshold=50.0,
                             bps_threshold=1e18, block_s=10.0)
    t, s = schema.make_table(CAP), schema.make_stats()
    flood = np.zeros(100, schema.FLOW_RECORD_DTYPE)
    flood["saddr"] = 0xBEEF
    flood["pkt_len"] = 100
    flood["ts_ns"] = np.arange(100) * 1000
    step(t, s, params, raw(flood))
    assert (schema.table_to_numpy(t)[0] == 0xBEEF).any()
    step(t, s, params, raw(mkbuf([77], t_s=5.0)))      # idle, still blocked
    assert (schema.table_to_numpy(t)[0] == 0xBEEF).any()
    step(t, s, params, raw(mkbuf([78], t_s=20.0)))     # block expired
    assert not (schema.table_to_numpy(t)[0] == 0xBEEF).any()


def test_warm_batch_is_a_noop():
    step_e, _, params = _steps(ttl=0.1, every=1)
    t, s = schema.make_table(CAP), schema.make_stats()
    step_e(t, s, params, raw(mkbuf(2000 + np.arange(16), 1.0)))
    before = t.key.clone(), t.state.clone()
    step_e(t, s, params, torch.zeros(BATCH + 1, schema.RECORD_WORDS,
                                     dtype=torch.int32))
    assert torch.equal(t.key, before[0]) and torch.equal(t.state, before[1])
    assert s.to_dict()["evicted"] == 0


# -- the u32 wrap of the batches counter ---------------------------------------

WCAP, WEVERY, WTTL = 256, 8, 5.0


def _wrap_sweep(batches: int, blocked_row: int | None = None):
    """The port's and the reference's ``evict_idle_epoch`` on one full,
    idle table at a given ``batches`` count; returns both freed sets
    and counts."""
    jt = jschema.make_table(WCAP)._replace(
        key=jnp.arange(1, WCAP + 1, dtype=jnp.uint32))
    tt = schema.table_from_numpy(np.arange(1, WCAP + 1, dtype=np.uint32),
                                 np.zeros((WCAP, 12), np.float32))
    if blocked_row is not None:
        jt = jt._replace(state=jt.state.at[
            blocked_row, TableCol.BLOCKED_UNTIL].set(1e9))
        tt.state[blocked_row, TableCol.BLOCKED_UNTIL] = 1e9
    js = jschema.make_stats()._replace(batches=jnp.asarray(
        [batches & 0xFFFFFFFF, batches >> 32], jnp.uint32))
    ts = schema.make_stats()
    ts.batches.fill_(batches)
    jcfg = jconfig.TableConfig(capacity=WCAP, evict_ttl_s=WTTL,
                               evict_every=WEVERY)
    tcfg = config.TableConfig(capacity=WCAP, evict_ttl_s=WTTL,
                              evict_every=WEVERY)
    jnew, jn = jfused.evict_idle_epoch(jcfg, jt, js, jnp.float32(100.0))
    n = fused.evict_idle_epoch(tcfg, tt, ts, torch.tensor(100.0))
    key, state = schema.table_to_numpy(tt)
    np.testing.assert_array_equal(key, np.asarray(jnew.key))
    np.testing.assert_array_equal(state, np.asarray(jnew.state))
    assert int(n) == int(jn)
    return set(np.flatnonzero(key == 0).tolist()), int(n)


@pytest.mark.parametrize("batches", [
    0, 1, WEVERY - 1, (1 << 32) - 3, (1 << 32) - 2, (1 << 32) - 1, 1 << 32,
    (1 << 32) + 3, 123456789, (5 << 32) + 7])
def test_window_in_bounds_across_the_wrap(batches):
    chunk = fused.evict_window(WCAP, WEVERY)
    freed, n = _wrap_sweep(batches)
    assert n == len(freed) == chunk
    assert min(freed) >= 0 and max(freed) < WCAP
    assert max(freed) - min(freed) == chunk - 1


def test_full_cycle_coverage_holds_across_the_wrap():
    covered = set()
    start = (1 << 32) - WEVERY // 2
    for b in range(start, start + WEVERY):
        covered |= _wrap_sweep(b)[0]
    assert covered == set(range(WCAP))


def test_blacklisted_rows_survive_the_wrap_epoch():
    off = (((1 << 32) - 1) % WEVERY) * fused.evict_window(WCAP, WEVERY)
    freed, n = _wrap_sweep((1 << 32) - 1, blocked_row=off)
    assert off not in freed
    assert n == fused.evict_window(WCAP, WEVERY) - 1


def test_ragged_window_is_clamped():
    """``capacity / evict_every`` not an integer: the last window is
    clamped to the table's end, as in the reference."""
    tcfg = config.TableConfig(capacity=WCAP, evict_ttl_s=1.0, evict_every=7)
    jcfg = jconfig.TableConfig(capacity=WCAP, evict_ttl_s=1.0, evict_every=7)
    for b in range(7):
        tt = schema.table_from_numpy(np.arange(1, WCAP + 1, dtype=np.uint32),
                                     np.zeros((WCAP, 12), np.float32))
        ts = schema.make_stats()
        ts.batches.fill_(b)
        jt = jschema.make_table(WCAP)._replace(
            key=jnp.arange(1, WCAP + 1, dtype=jnp.uint32))
        js = jschema.make_stats()._replace(
            batches=jnp.asarray([b, 0], jnp.uint32))
        jnew, jn = jfused.evict_idle_epoch(jcfg, jt, js, jnp.float32(9.0))
        n = fused.evict_idle_epoch(tcfg, tt, ts, torch.tensor(9.0))
        np.testing.assert_array_equal(schema.table_to_numpy(tt)[0],
                                      np.asarray(jnew.key))
        assert int(n) == int(jn)


# -- engines --------------------------------------------------------------------


@pytest.mark.parametrize("mega_n", [0, "auto"])
def test_engine_with_eviction_matches_reference_engine(mega_n):
    """compact16 engines (golden params) with eviction on, singles and
    ``mega_n="auto"``: stats (``evicted`` included) and blacklist equal
    to the reference engine's on the same churn stream, and the port's
    auto equal to its singles (the sweep runs once per inner step)."""
    recs = churn_records(phases=6)
    jsink, tsink = JCollectSink(), CollectSink()
    jr = JEngine(evict_cfg(ttl=2.5, every=2, pkg=jconfig),
                 JArraySource(recs.copy()), jsink, sink_thread=False,
                 mega_n=mega_n).run()
    te = Engine(evict_cfg(ttl=2.5, every=2), ArraySource(recs.copy()),
                tsink, device="cpu", mega_n=mega_n)
    tr = te.run()
    assert tr.stats["evicted"] > 0
    assert tr.stats == jr.stats
    assert tsink.blocked == jsink.blocked
    assert tr.table == jr.table
    if mega_n == "auto":
        single = Engine(evict_cfg(ttl=2.5, every=2), ArraySource(recs.copy()),
                        CollectSink(), device="cpu").run()
        assert single.stats == tr.stats


def test_occupancy_bounded_under_churn():
    recs = churn_records(phases=8)
    out = {}
    for ttl in (0.0, 2.0):
        out[ttl] = Engine(evict_cfg(ttl=ttl, every=2),
                          ArraySource(recs.copy()), CollectSink(),
                          device="cpu").run()
    assert out[0.0].table["tracked"] >= 7 * BATCH
    assert out[2.0].table["tracked"] <= 4 * BATCH
    assert out[2.0].stats["evicted"] > 0
    assert out[2.0].stats["allowed"] == out[0.0].stats["allowed"]
