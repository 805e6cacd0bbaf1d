"""The plain reference of the serving data plane, one micro-batch at a
time: plain PyTorch, importing nothing of the program.

A deployment's semantics, as the configuration states them
(``FsxConfig``'s sections, written out here from their definitions):

* **the wire** (compact16): each record carries its source, its eight
  features as the model's input codes, its length in units of 8 bytes
  and its arrival in µs after the batch's first record; the batch
  carries that first arrival in µs after the stream's epoch.  A
  record's time is ``base + dt`` in float32 seconds.
* **the table**: ``capacity`` rows, open addressing with ``probes``
  double-hashed candidates (MurmurHash3's finalizer); a source takes
  its own row, else the first empty one, else the first one idle for
  more than ``stale_s``; when several sources of one batch want one row,
  a source that already holds it keeps it, else the smallest address
  takes it.  A source without a row is served without state.
* **the limiter** (fixed window, sliding window or token bucket) over
  each source's packets and bytes in the batch.
* **the model**: the int8 logistic regression given by value; a record
  is malicious when its quantized probability exceeds ``threshold``.
* **the decision** per source: blocked (its block has not expired),
  over the rate (blocked ``block_s``), or malicious by the young-flow
  vote (``vote_k`` records before votes count, ``vote_m`` votes, a
  ``vote_decay_s`` half-life, or a burst; blocked ``ml_block_s``); a
  malicious record of a source that is not blocked is dropped alone.
* **the outputs**: per-verdict counters, the new blocks with their
  expiries in the order of the table's row claims, and the table.

The step never waits for the device: a replay of thousands of batches
queues them all and reads the results once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.numerics import (
    LN2, exp32, f32, fma32, murmur_fmix32, recip_mul,
)

INVALID_KEY = 0xFFFFFFFF
EMPTY_KEY = 0

# state columns of a table row
(LAST_SEEN, WIN_START, WIN_PPS, WIN_BPS, PREV_PPS, PREV_BPS, TOKENS,
 TOK_TS, TOK_BYTES, REC_SEEN, ML_VOTES, BLOCKED_UNTIL) = range(12)
N_COLS = 12

# verdict codes, and the counters they feed in this order
PASS, DROP_BLACKLIST, DROP_RATE, DROP_ML = range(4)
STAT_NAMES = ("allowed", "dropped_blacklist", "dropped_rate", "dropped_ml",
              "batches")

_US = f32(1e-6)
_TS_HI_S = f32(4294.967296)      # 2^32 µs in seconds


def quantize_inputs(feat: np.ndarray, weights: dict) -> np.ndarray:
    """Raw u32 features -> the model's uint8 input codes (the wire's
    feature bytes): ``round(x / in_scale) + in_zp`` in float32 (``x`` the
    feature, or its float32 ``log1p`` for a model trained on it), half to
    even, clamped to 0..255."""
    x = np.asarray(feat).astype(np.float32)
    if weights.get("log1p", 0):
        x = np.log1p(x)
    q = np.rint(x / np.float32(weights["in_scale"])) + int(weights["in_zp"])
    return np.clip(q, 0, 255).astype(np.uint8)


def length_units(pkt_len: np.ndarray) -> np.ndarray:
    """Packet lengths -> the wire's 8-byte units (nearest, at most
    2047)."""
    return np.minimum((np.asarray(pkt_len).astype(np.int64) + 4) >> 3, 2047)


def int_weights(weights: dict, bits: int = 8) -> np.ndarray:
    """The int8 weights, or (``bits`` < 8, the lower-precision control)
    the same weights rounded to ``bits`` bits on a scale ``2^(8-bits)``
    times coarser."""
    w = np.asarray(weights["w_int8"], np.int64)
    if bits == 8:
        return w
    step = 1 << (8 - bits)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return np.clip(np.rint(w / step), lo, hi).astype(np.int64) * step


class ReferenceFilter:
    """The whole device state of one deployment (table and counters) and
    its step.  ``cfg`` is the configuration's ``fsx`` block (the
    project's config JSON), ``weights`` the model by value;
    ``weight_bits`` < 8 serves the lower-precision control."""

    def __init__(self, cfg: dict, weights: dict, device="cpu",
                 weight_bits: int = 8):
        self.dev = d = torch.device(device)
        tab = cfg.get("table", {})
        self.capacity = int(tab.get("capacity", 1 << 20))
        self.probes = int(tab.get("probes", 8))
        self.stale_s = f32(tab.get("stale_s", 30.0))
        self.salt = int(tab.get("salt", 0))
        if tab.get("evict_ttl_s", 0.0):
            raise ValueError("the reference serves tables without eviction")
        lim = cfg.get("limiter", {})
        self.lim_kind = lim.get("kind", "fixed_window")
        self.pps_thr = f32(lim.get("pps_threshold", 1000.0))
        self.bps_thr = f32(lim.get("bps_threshold", 125e6))
        self.window_s = float(lim.get("window_s", 1.0))
        self.bucket_rate_pps = f32(lim.get("bucket_rate_pps", 1000.0))
        self.bucket_burst = f32(lim.get("bucket_burst", 2000.0))
        self.bucket_rate_bps = f32(lim.get("bucket_rate_bps", 125e6))
        self.bucket_burst_bytes = f32(lim.get("bucket_burst_bytes", 250e6))
        self.block_s = f32(lim.get("block_s", 10.0))
        mdl = cfg.get("model", {})
        if mdl.get("name", "logreg_int8") != "logreg_int8":
            raise ValueError("the reference serves the int8 logistic "
                             "regression")
        self.threshold = f32(mdl.get("threshold", 0.5))
        self.ml_block_s = f32(mdl.get("ml_block_s", 10.0))
        self.vote_k = float(mdl.get("vote_k", 4))
        self.vote_m = float(mdl.get("vote_m", 2))
        self.vote_decay_s = float(mdl.get("vote_decay_s", 60.0))
        # the model
        self.w = torch.tensor(int_weights(weights, weight_bits), device=d)
        self.in_zp = int(weights["in_zp"])
        s = np.float32(weights["in_scale"]) * np.float32(weights["w_scale"])
        self.acc_scale = torch.tensor(np.float32(s), device=d)
        self.bias = torch.tensor(np.float32(weights["bias"]), device=d)
        self.out_scale = torch.tensor(np.float32(weights["out_scale"]),
                                      device=d)
        self.out_zp = int(weights["out_zp"])
        # the quantized probability of each of the 256 output codes: the
        # logistic function in float64, rounded once to float32
        q = np.arange(256, dtype=np.float32)
        y = ((q - np.float32(self.out_zp))
             * np.float32(weights["out_scale"])).astype(np.float64)
        with np.errstate(over="ignore"):
            p = (1.0 / (1.0 + np.exp(-y))).astype(np.float32)
        prob = (np.clip(np.rint(p * np.float32(256.0)), 0, 255)
                / 256.0).astype(np.float32)
        self.malicious_code = torch.tensor(
            prob > np.float32(self.threshold), device=d)
        # the device state; row ``capacity`` takes the writes of sources
        # that hold no row, and is never read
        self.key = torch.zeros(self.capacity + 1, dtype=torch.int64, device=d)
        self.state = torch.zeros(self.capacity + 1, N_COLS,
                                 dtype=torch.float32, device=d)
        self.stats = torch.zeros(len(STAT_NAMES), dtype=torch.int64, device=d)

    # -- one micro-batch ----------------------------------------------------

    def score(self, q8: torch.Tensor) -> torch.Tensor:
        """``[n, 8]`` input codes -> ``[n]`` malicious flags.  A code's
        feature, quantized again by the model's own input quantizer, is
        the code: the accumulator is the codes' dot with the weights."""
        acc = ((q8.long() - self.in_zp) * self.w).sum(dim=1)
        y = fma32(acc.float(), self.acc_scale, self.bias)
        qy = torch.clamp(torch.round(y / self.out_scale) + self.out_zp,
                         0, 255)
        return self.malicious_code[qy.long()]

    def bind(self, saddr: torch.Tensor, q8: torch.Tensor,
             len8: torch.Tensor) -> None:
        """The record pool this filter serves from (on its device): what
        depends on a record alone is worked out once per pool record —
        its source (0.0.0.0 tracked as 255.255.255.254), the source's two
        hashes, the model's verdict, its length in bytes."""
        key = torch.where(saddr == EMPTY_KEY, 0xFFFFFFFE, saddr)
        self.p_key = key
        self.p_h1 = murmur_fmix32(key, self.salt)
        self.p_stride = murmur_fmix32(key ^ 0x9E3779B9, self.salt) | 1
        self.p_mal = self.score(q8)
        self.p_bytes = (len8 * 8).float()

    def _limit(self, rows, pkts, nbytes, ts, is_new):
        """The configured limiter over each source's batch deltas:
        ``(its window and bucket columns, over the limit)``."""
        start, wpps, wbps = (rows[:, WIN_START], rows[:, WIN_PPS],
                             rows[:, WIN_BPS])
        ppps, pbps = rows[:, PREV_PPS], rows[:, PREV_BPS]
        tok, tok_ts, tok_b = (rows[:, TOKENS], rows[:, TOK_TS],
                              rows[:, TOK_BYTES])
        if self.lim_kind == "fixed_window":
            expired = ts - start >= f32(self.window_s)
            wpps = torch.where(expired, pkts, wpps + pkts)
            wbps = torch.where(expired, nbytes, wbps + nbytes)
            start = torch.where(expired, ts, start)
            over = (wpps > self.pps_thr) | (wbps > self.bps_thr)
        elif self.lim_kind == "sliding_window":
            w, w2 = f32(self.window_s), f32(2 * self.window_s)
            el = ts - start
            one = (el >= w) & (el < w2)
            many = el >= w2
            zero = torch.zeros_like(ppps)
            ppps = torch.where(one, wpps, torch.where(many, zero, ppps))
            pbps = torch.where(one, wbps, torch.where(many, zero, pbps))
            rolled = one | many
            r = torch.fmod(ts, w)
            r = torch.where((r != 0) & (r < 0), r + w, r)
            start = torch.where(many, ts - r,
                                torch.where(one, start + w, start))
            wpps = torch.where(rolled, pkts, wpps + pkts)
            wbps = torch.where(rolled, nbytes, wbps + nbytes)
            keep = 1.0 - torch.clamp(recip_mul(ts - start, self.window_s),
                                     0.0, 1.0)
            over = ((fma32(ppps, keep, wpps) > self.pps_thr)
                    | (fma32(pbps, keep, wbps) > self.bps_thr))
        elif self.lim_kind == "token_bucket":
            el = ts - tok_ts
            tok = torch.clamp(fma32(el, self.bucket_rate_pps, tok),
                              max=self.bucket_burst)
            tok = torch.where(is_new, self.bucket_burst, tok)
            over = tok < pkts
            tok = torch.clamp(tok - pkts, min=0.0)
            if self.bucket_burst_bytes > 0:
                tok_b = torch.clamp(fma32(el, self.bucket_rate_bps, tok_b),
                                    max=self.bucket_burst_bytes)
                tok_b = torch.where(is_new, self.bucket_burst_bytes, tok_b)
                over = over | (tok_b < nbytes)
                tok_b = torch.clamp(tok_b - nbytes, min=0.0)
            tok_ts = ts.clone()
        else:
            raise ValueError(f"unknown limiter {self.lim_kind!r}")
        return (start, wpps, wbps, ppps, pbps, tok, tok_ts, tok_b), over

    def step(self, p: torch.Tensor, ts_ns: torch.Tensor,
             n_valid: torch.Tensor, t0_ns: int):
        """One batch: the pool records ``p[:n_valid]`` (``[B]`` indices;
        lanes past ``n_valid`` are ignored) arriving at ``ts_ns``
        (``[B]`` int64 ns on the stream's clock; ``n_valid`` a 0-d
        tensor).  Returns ``([B] block keys, [B] block expiries, []
        sources in the batch)``: a key is ``INVALID_KEY`` except for a
        source newly blocked, in the order of the row claims.  Nothing
        here waits for the device."""
        dev = self.dev
        n = p.shape[0]
        n_rows = self.capacity
        P = self.probes
        lane = torch.arange(n, device=dev)
        valid = lane < n_valid
        # the wire: µs after the batch's first record, and that record's
        # µs after the epoch; record times in float32 seconds
        base_ns = ts_ns[0]
        dt_us = torch.clamp(torch.div(ts_ns - base_ns, 1000,
                                      rounding_mode="floor"), 0, 0xFFFF)
        rel = torch.div(torch.clamp(base_ns - t0_ns, min=0), 1000,
                        rounding_mode="floor")
        base = fma32((rel >> 32).float(), _TS_HI_S,
                     (rel & 0xFFFFFFFF).float() * _US)
        ts = fma32(dt_us.float(), _US, base)
        now = torch.where(valid, ts, 0.0).max()
        mal = self.p_mal[p] & valid
        key = torch.where(valid, self.p_key[p], INVALID_KEY)

        # each record's candidate rows and its claim on one of them
        i = torch.arange(P, device=dev)
        cand = (self.p_h1[p][:, None]
                + i[None, :] * self.p_stride[p][:, None]) & (n_rows - 1)
        ck = self.key[cand]
        match = ck == key[:, None]
        empty = ck == EMPTY_KEY
        stale = ~match & ~empty & (
            now - self.state[cand, LAST_SEEN] > self.stale_s)
        rank = torch.where(match, i, torch.where(
            empty, P + i, torch.where(stale, 2 * P + i, 4 * P)))
        best, pick = rank.min(dim=1)
        slot = cand.gather(1, pick[:, None])[:, 0]
        found = valid & (best < P)
        usable = valid & (best < 4 * P)

        # sources in claim order: by (row, holder first, address)
        claim = torch.where(usable, slot * 2 + (~found).long(), 2 * n_rows)
        srt, order = torch.sort((claim << 32) | key, stable=True)
        k_s = srt & 0xFFFFFFFF
        c_s = srt >> 32
        head = torch.ones(n, dtype=torch.bool, device=dev)
        head[1:] = k_s[1:] != k_s[:-1]
        row_head = torch.ones_like(head)
        row_head[1:] = (c_s[1:] >> 1) != (c_s[:-1] >> 1)
        seg_s = torch.cumsum(head, 0) - 1
        seg = torch.empty_like(seg_s).scatter_(0, order, seg_s)
        # per source: index = its rank in claim order, n slots; a slot
        # holds a source when some valid record falls in it
        at = torch.full((n,), n, device=dev).scatter_reduce_(
            0, seg_s, lane, "amin").clamp(max=n - 1)
        first = order[at]
        src = key[first]
        s_slot, s_found, s_usable = slot[first], found[first], usable[first]
        winner = row_head[at]

        def per_source(v):
            return torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
                0, seg, v.double()).float()

        pkts = per_source(valid)
        n_mal = per_source(mal)
        nbytes = per_source(torch.where(valid, self.p_bytes[p], 0.0))
        t_src = torch.full((n,), -math.inf, device=dev).scatter_reduce_(
            0, seg, torch.where(valid, ts, -math.inf), "amax")
        is_src = pkts > 0
        t_src = torch.where(is_src, t_src, 0.0)

        tracked = s_usable & winner & is_src
        is_new = tracked & ~s_found
        rows = torch.where(is_new[:, None], 0.0,
                           self.state[s_slot.clamp(0, n_rows - 1)])
        blocked_until = rows[:, BLOCKED_UNTIL]
        rec_seen, votes0 = rows[:, REC_SEEN], rows[:, ML_VOTES]
        last_seen = rows[:, LAST_SEEN]

        blocked = tracked & (blocked_until > t_src)
        lim_cols, over = self._limit(rows, pkts, nbytes, t_src, is_new)
        over_rate = tracked & over & ~blocked
        hit = n_mal > 0
        fresh = torch.where(rec_seen >= self.vote_k, n_mal, 0.0)
        if self.vote_decay_s > 0:
            dt = torch.clamp(t_src - last_seen, min=0.0)
            k = f32(f32(1.0 / f32(self.vote_decay_s)) * LN2)
            votes = fma32(votes0, exp32(dt * -k), fresh)
        else:
            votes = votes0 + fresh
        votes = torch.clamp(votes, max=f32(1e6))
        burst = (pkts > self.vote_k) & (n_mal >= self.vote_m)
        vote_ok = torch.where(tracked, (votes >= self.vote_m) | burst, burst)
        over_ml = hit & vote_ok & ~blocked & ~over_rate
        ml_records = hit & ~vote_ok & ~blocked & ~over_rate
        until = torch.where(over_rate, t_src + self.block_s,
                            torch.where(over_ml, t_src + self.ml_block_s,
                                        blocked_until))
        verdict = torch.where(blocked, DROP_BLACKLIST, torch.where(
            over_rate, DROP_RATE, torch.where(over_ml, DROP_ML, PASS)))

        # the tracked sources' rows (the others write the spare row)
        new = torch.stack([t_src, *lim_cols, rec_seen + pkts,
                           torch.where(over_ml, 0.0, votes), until], dim=1)
        dst = torch.where(tracked, s_slot, n_rows)
        self.key.index_put_((dst,), src)
        self.state.index_put_((dst,), new)

        # per record: its source's verdict; a malicious record of a
        # source the vote spared is dropped alone
        rec = verdict[seg]
        rec = torch.where(ml_records[seg] & mal, DROP_ML, rec)
        codes = torch.arange(4, device=dev)
        self.stats[:4] += ((rec[:, None] == codes) & valid[:, None]).sum(0)
        self.stats[4] += (n_valid > 0).long()
        newly = over_rate | over_ml
        return (torch.where(newly, src, INVALID_KEY),
                torch.where(newly, until, 0.0), is_src.sum())

    def counters(self) -> dict:
        return dict(zip(STAT_NAMES, self.stats.tolist()))

    def table(self) -> tuple[np.ndarray, np.ndarray]:
        """``([N] uint32 keys, [N, 12] float32 state)`` on the host."""
        return (self.key[:-1].cpu().numpy().astype(np.uint32),
                self.state[:-1].cpu().numpy())
