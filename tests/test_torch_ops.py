"""The port's table, limiter and aggregation ops against the JAX
reference, on the same numpy inputs, bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.ops import agg as jagg
from flowsentryx_tpu.ops import hashtable as jhash
from flowsentryx_tpu.ops import limiters as jlim
from flowsentryx_tpu_torch.core import config
from flowsentryx_tpu_torch.ops import agg, hashtable, limiters


def _u32(rng, n):
    edge = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                     0xFFFFFFFF, 0x9E3779B9], np.uint32)
    return np.concatenate([edge, rng.integers(0, 1 << 32, n,
                                              dtype=np.uint64)
                           .astype(np.uint32)])


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 values -> the port's int64 representation."""
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("salt", [0, 1, 0xDEADBEEF, 0xFFFFFFFF])
def test_hash_u32_bit_exact(rng, salt):
    k = _u32(rng, 20000)
    want = np.asarray(jhash.hash_u32(jnp.asarray(k), salt))
    got = hashtable.hash_u32(_t(k), salt).numpy()
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def _table(rng, cap, fill):
    key = np.zeros(cap, np.uint32)
    slots = rng.choice(cap, fill, replace=False)
    key[slots] = rng.integers(1, 1 << 16, fill)   # small pool: re-hits
    seen = rng.uniform(0, 50, cap).astype(np.float32)
    return key, seen


@pytest.mark.parametrize("probes,stale_s,salt", [(8, 30.0, 0), (3, 5.0, 77),
                                                 (1, 1e6, 0)])
def test_probe_and_assign_slots(rng, probes, stale_s, salt):
    cap = 1 << 10
    key, seen = _table(rng, cap, 700)
    q = np.concatenate([key[rng.choice(cap, 200)],
                        rng.integers(1, 1 << 16, 300)]).astype(np.uint32)
    q[q == 0] = 5
    valid = rng.random(q.shape[0]) < 0.9
    jcfg = jconfig.TableConfig(capacity=cap, probes=probes, stale_s=stale_s,
                               salt=salt)
    tcfg = config.TableConfig(capacity=cap, probes=probes, stale_s=stale_s,
                              salt=salt)
    now = np.float32(45.0)
    jt = (jnp.asarray(key), jnp.asarray(seen), jnp.asarray(q),
          jnp.asarray(valid), jnp.float32(now))
    tt = (torch.from_numpy(key.view(np.int32)), torch.from_numpy(seen),
          _t(q), torch.from_numpy(valid), torch.tensor(now))
    jp = jhash.probe_slots(*jt, jcfg)
    tp = hashtable.probe_slots(*tt, tcfg)
    for f in ("slot", "found", "usable"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    # assign_slots takes distinct representative keys
    reps = np.unique(q)
    rv = np.ones(reps.shape[0], bool)
    ja = jhash.assign_slots(jt[0], jt[1], jnp.asarray(reps), jnp.asarray(rv),
                            jt[4], jcfg)
    ta = hashtable.assign_slots(tt[0], tt[1], _t(reps), torch.from_numpy(rv),
                                tt[4], tcfg)
    for f in ("slot", "found", "inserted", "tracked"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)))


def _lim_inputs(rng, r=512):
    now = rng.uniform(0, 20, r).astype(np.float32)
    win_start = (now - rng.choice([0.1, 0.9, 1.0, 1.5, 2.0, 3.7],
                                  r)).astype(np.float32)
    cols = {
        "win_start": win_start,
        "win_pps": rng.integers(0, 3000, r).astype(np.float32),
        "win_bps": rng.uniform(0, 2e8, r).astype(np.float32),
        "prev_pps": rng.integers(0, 3000, r).astype(np.float32),
        "prev_bps": rng.uniform(0, 2e8, r).astype(np.float32),
        "tokens": rng.uniform(0, 2000, r).astype(np.float32),
        "tok_ts": (now - rng.uniform(0, 3, r)).astype(np.float32),
        "tok_bytes": rng.uniform(0, 2.5e8, r).astype(np.float32),
    }
    d_pkts = rng.integers(1, 1500, r).astype(np.float32)
    d_bytes = (d_pkts * rng.integers(8, 1500, r)).astype(np.float32)
    is_new = rng.random(r) < 0.2
    return now, cols, d_pkts, d_bytes, is_new


@pytest.mark.parametrize("kind", ["fixed_window", "sliding_window",
                                  "token_bucket"])
@pytest.mark.parametrize("byte_bucket", [True, False])
def test_limiters_bit_exact(rng, kind, byte_bucket):
    kw = dict(pps_threshold=1000.0, bps_threshold=1.25e8, window_s=1.0,
              bucket_rate_pps=700.0, bucket_burst=1500.0)
    if not byte_bucket:
        kw.update(bucket_rate_bps=0.0, bucket_burst_bytes=0.0)
    jcfg = jconfig.LimiterConfig(kind=jconfig.LimiterKind(kind), **kw)
    tcfg = config.LimiterConfig(kind=config.LimiterKind(kind), **kw)
    now, cols, d_pkts, d_bytes, is_new = _lim_inputs(rng)
    wn = ("win_start", "win_pps", "win_bps", "prev_pps", "prev_bps")
    bn = ("tokens", "tok_ts", "tok_bytes")
    # jitted, as the served step runs it: XLA fuses (and FMA-contracts)
    # the limiter arithmetic only inside a compiled graph
    want = jax.jit(lambda w, bk, dp, db, t, new: jlim.apply_limiter(
        jcfg, w, bk, dp, db, t, is_new=new))(
        jlim.WindowState(*(jnp.asarray(cols[c]) for c in wn)),
        jlim.BucketState(*(jnp.asarray(cols[c]) for c in bn)),
        jnp.asarray(d_pkts), jnp.asarray(d_bytes), jnp.asarray(now),
        jnp.asarray(is_new))
    got = limiters.apply_limiter(
        tcfg, limiters.WindowState(*(torch.from_numpy(cols[c]) for c in wn)),
        limiters.BucketState(*(torch.from_numpy(cols[c]) for c in bn)),
        torch.from_numpy(d_pkts), torch.from_numpy(d_bytes),
        torch.from_numpy(now), is_new=torch.from_numpy(is_new))
    np.testing.assert_array_equal(got.over_limit.numpy(),
                                  np.asarray(want.over_limit))
    for part in ("window", "bucket"):
        for g, w in zip(getattr(got, part), getattr(want, part)):
            np.testing.assert_array_equal(
                g.numpy().view(np.uint32),
                np.broadcast_to(np.asarray(w), g.shape).view(np.uint32))


@pytest.mark.parametrize("b", [1, 64, 512])
def test_aggregate_bit_exact(rng, b):
    key = rng.choice(np.array([0, 7, 9, 1 << 31, 0xFFFFFFFE, 0xFFFFFFFF,
                               12345], np.uint32), b)
    pkt_len = (rng.integers(8, 2048, b) * 8).astype(np.float32)
    ts = rng.uniform(0, 5, b).astype(np.float32)
    valid = rng.random(b) < 0.8
    want = jagg.aggregate(jnp.asarray(key), jnp.asarray(pkt_len),
                          jnp.asarray(ts), jnp.asarray(valid))
    got = agg.aggregate(_t(key), torch.from_numpy(pkt_len),
                        torch.from_numpy(ts), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.rep_key.numpy().astype(np.uint32),
                                  np.asarray(want.rep_key))
    for f in ("rep_pkts", "rep_bytes", "rep_ts"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().view(np.uint32),
            np.asarray(getattr(want, f)).view(np.uint32))
    np.testing.assert_array_equal(got.rep_valid.numpy(),
                                  np.asarray(want.rep_valid))
    np.testing.assert_array_equal(got.inv.numpy(), np.asarray(want.inv))


@pytest.mark.parametrize("window_s", [0.3, 3.0])
def test_sliding_window_non_power_of_two_window(rng, window_s):
    """``(now - start) / window_s`` compiles to a multiply by the float32
    reciprocal, which differs from true division for a window that is
    not a power of two.  Lanes inside an open window are placed on the
    packet threshold (the reference's estimate lands exactly on it), so a
    one-ULP error in the overlap flips ``over_limit``."""
    r = 4096
    w = np.float32(window_s)
    thr = np.float32(1e6)
    now = rng.uniform(5, 50, r).astype(np.float32)
    start = (now - rng.uniform(0.01, 0.99, r) * w).astype(np.float32)
    prev = rng.integers(100_000, 900_000, r).astype(np.float32)
    # the reference's overlap, then the count that puts its estimate on
    # the threshold: est = fma(prev, overlap, pps) == thr
    frac = np.clip((now - start) * np.float32(1 / w), 0, 1).astype(np.float32)
    p = prev.astype(np.float64) * (np.float32(1) - frac).astype(np.float64)
    pps = (thr - p).astype(np.float32)
    est = (p + pps).astype(np.float32)
    pps = np.where(est == thr, pps, np.float32(0))   # off the edge: idle
    kw = dict(pps_threshold=float(thr), bps_threshold=1e30,
              window_s=window_s)
    jcfg = jconfig.LimiterConfig(kind=jconfig.LimiterKind.SLIDING_WINDOW,
                                 **kw)
    tcfg = config.LimiterConfig(kind=config.LimiterKind.SLIDING_WINDOW, **kw)
    zeros = np.zeros(r, np.float32)
    cols = (start, pps, zeros, prev, zeros)
    want = jax.jit(lambda st, dp, db, t: jlim.sliding_window(
        jcfg, st, dp, db, t))(jlim.WindowState(*map(jnp.asarray, cols)),
                              jnp.asarray(zeros), jnp.asarray(zeros),
                              jnp.asarray(now))
    got = limiters.sliding_window(
        tcfg, limiters.WindowState(*map(torch.from_numpy, cols)),
        torch.from_numpy(zeros), torch.from_numpy(zeros),
        torch.from_numpy(now))
    assert int((pps > 0).sum()) > r // 2       # most lanes sit on the edge
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, wnt in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(wnt).view(np.uint32))
