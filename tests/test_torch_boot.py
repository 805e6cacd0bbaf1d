"""The port's boot path against the JAX reference: the staged-shape
signature, the compile cache, the tiered warm and its background fill,
the boot salt and ``EngineReport.boot``.

The signature digest equals the reference's ``signature_digest
(staging_signature(...))`` for the same config, wire, ladder, ring depth
and params.  ``CompileCache`` is held to the reference's refusal ladder
(hit, miss, corrupt blob, bad magic, version drift, foreign digest,
store failure) on stand-in blobs (no nvcc here), and ``build_all`` loads
a library from it without nvcc.  A tiered engine with its fill held
serves through the single step and the top rung only and is byte-equal
to the reference's full-warm engine (the reference's own tiered test
does not pass on this container's jax, so its full warm is the oracle);
the fill completes the ladder and the ring; ``warm()`` is refused while
a fill runs; ``run()`` joins it.  B = 128-256, capacity 2^12, torch at 2
threads.
"""

import threading

import numpy as np
import pytest
import torch

from flowsentryx_tpu import cli as jcli
from flowsentryx_tpu.core import config as jconfig
from flowsentryx_tpu.core.signature import signature_digest as jdigest
from flowsentryx_tpu.core.signature import staging_signature as jstaging
from flowsentryx_tpu.engine import CollectSink as JCollectSink
from flowsentryx_tpu.engine import Engine as JEngine
from flowsentryx_tpu.engine.sources import ArraySource as JArraySource
from flowsentryx_tpu.models import logreg as jlogreg
from flowsentryx_tpu.models import mlp as jmlp
from flowsentryx_tpu_torch import cli
from flowsentryx_tpu_torch.core import config, signature
from flowsentryx_tpu_torch.engine import ArraySource, CollectSink, Engine
from flowsentryx_tpu_torch.engine import compile_cache as cc
from flowsentryx_tpu_torch.engine.compile_cache import CompileCache
from flowsentryx_tpu_torch.models import logreg, mlp
from flowsentryx_tpu_torch.ops import kernels

from test_torch_device_loop import _recs
from test_torch_megastep import ARTIFACT, _assert_same_result, _cfgs


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the staged-shape signature
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(wire="compact16", mega_sizes=(8, 4, 2), device_loop=2,
         donate=True, params="int8"),
    dict(wire="compact16", mega_sizes=(), device_loop=0, donate=None,
         params=None),
    dict(wire="raw48", mega_sizes=(4,), device_loop=0, donate=False,
         params="mlp"),
    dict(wire="compact16", mesh_devices=8, mega_sizes=(8,), device_loop=4,
         donate=True, params="int8"),
])
def test_signature_digest_equals_reference(kw):
    """The same config (eviction knobs and a salt set), wire, ladder,
    ring depth, donation and params leaves key the same digest; the
    signature dicts are equal field by field."""
    lim = dict(pps_threshold=321.0)
    tb = dict(capacity=1 << 14, salt=0x1CE, evict_ttl_s=0.25,
              evict_every=32)
    jcfg = jconfig.FsxConfig(limiter=jconfig.LimiterConfig(**lim),
                             table=jconfig.TableConfig(**tb))
    tcfg = config.FsxConfig(limiter=config.LimiterConfig(**lim),
                            table=config.TableConfig(**tb))
    which = kw.pop("params")
    jp = tp = None
    if which == "int8":
        jp, tp = jlogreg.load_params(ARTIFACT), logreg.load_params(ARTIFACT)
    elif which == "mlp":
        import jax

        jp = jmlp.init_params(jax.random.PRNGKey(0))
        tp = mlp.MlpParams(*(t.to(torch.bfloat16)
                             for t in mlp.init_params()))
    js = jstaging(jcfg, params=jp, **kw)
    ts = signature.staging_signature(tcfg, params=tp, **kw)
    assert ts == js
    assert signature.signature_digest(ts) == jdigest(js)


def test_signature_moves_with_every_keyed_axis():
    _, tcfg = _cfgs(1 << 12, 256, 64)
    kw = dict(wire="compact16", mesh_devices=1, mega_sizes=(8, 4, 2),
              device_loop=0, params=None, donate=True)
    base = signature.signature_digest(
        signature.staging_signature(tcfg, **kw))
    for change in (dict(wire="raw48"), dict(mesh_devices=8),
                   dict(mega_sizes=(8, 4)), dict(device_loop=2),
                   dict(donate=False), dict(donate=None)):
        d = signature.signature_digest(
            signature.staging_signature(tcfg, **{**kw, **change}))
        assert d != base, change
    assert signature.params_signature(None, "logreg") == ["default",
                                                          "logreg"]
    sig = signature.params_signature(
        {"w": np.zeros((4, 2), np.float32), "b": np.zeros((2,), np.int8)},
        "logreg")
    assert sig == [["int8", [2]], ["float32", [4, 2]]]


# ---------------------------------------------------------------------------
# the compile cache, on stand-in blobs
# ---------------------------------------------------------------------------

BLOB = bytes(range(256)) * 9


def test_cache_roundtrip_hit(tmp_path):
    cache = CompileCache(tmp_path, {"k": 1})
    assert cache.load("score_int8-abc") is None and cache.misses == 1
    assert cache.store("score_int8-abc", BLOB)
    assert cache.stores == 1 and cache.path("score_int8-abc").exists()
    assert cache.load("score_int8-abc") == BLOB and cache.hits == 1
    rep = cache.report()
    assert set(rep) == {"dir", "sig_digest", "hits", "misses", "corrupt",
                        "version_drift", "stores", "store_errors"}
    assert rep["sig_digest"] == signature.signature_digest({"k": 1})[:20]


def test_cache_corrupt_blob_and_bad_magic(tmp_path, capsys):
    cache = CompileCache(tmp_path, {"k": 1})
    cache.store("v", BLOB)
    p = cache.path("v")
    raw = bytearray(p.read_bytes())
    raw[-1] ^= 0xFF                  # one blob byte: the CRC refuses
    p.write_bytes(bytes(raw))
    assert cache.load("v") is None
    assert cache.corrupt == 1 and cache.hits == 0
    assert "corrupt" in capsys.readouterr().err
    raw[0] ^= 0xFF                   # bad magic: the same refusal
    p.write_bytes(bytes(raw))
    assert cache.load("v") is None and cache.corrupt == 2


def test_cache_version_drift(tmp_path, monkeypatch, capsys):
    CompileCache(tmp_path, {"k": 1}).store("v", BLOB)
    monkeypatch.setattr(cc, "toolchain_versions", lambda: {
        "nvcc": "Build cuda_99.0", "torch": "99.0", "cuda": "99.0",
        "compute_capability": "9.0"})
    cache2 = CompileCache(tmp_path, {"k": 1})
    assert cache2.load("v") is None
    assert cache2.version_drift == 1
    assert cache2.corrupt == 0 and cache2.misses == 0
    assert "drift" in capsys.readouterr().err


def test_cache_foreign_digest_is_a_plain_miss(tmp_path):
    a = CompileCache(tmp_path, {"k": 1})
    a.store("v", BLOB)
    b = CompileCache(tmp_path, {"k": 2})
    b.path("v").write_bytes(a.path("v").read_bytes())
    assert b.load("v") is None
    assert b.misses == 1 and b.corrupt == 0


def test_cache_store_failure_is_counted(tmp_path, capsys):
    cache = CompileCache(tmp_path, {"k": 1})
    assert cache.store("v", object()) is False
    assert cache.store_errors == 1 and cache.stores == 0
    assert "failed to store" in capsys.readouterr().err


def test_build_all_loads_from_cache_without_nvcc(tmp_path, monkeypatch):
    """A cache hit writes the library where the loader looks for it and
    runs no nvcc; a miss builds with nvcc (absent here: it raises, no
    fallback), and a present library is taken as it is."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    cache = CompileCache(tmp_path / "cache", {"k": 1})
    stem = kernels._lib_path("score_int8").stem
    cache.store(stem, BLOB)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    info = kernels.build_all(["score_int8"], cache=cache)
    assert info["score_int8"]["source"] == "cache" and cache.hits == 1
    assert kernels._lib_path("score_int8").read_bytes() == BLOB
    assert kernels.build_all(["score_int8"])["score_int8"]["source"] == \
        "present"
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build_all(["table_summary"], cache=cache)
    assert cache.misses == 1


def test_boot_salt_pinned_in_cache_dir(tmp_path, capsys):
    """As the reference's ``_boot_salt``: pinned once in ``boot_salt``,
    reused silently, a malformed pin redrawn and re-pinned; without a
    cache dir a fresh odd u32 per boot."""
    d = tmp_path / "cache"
    s1 = cli._boot_salt(str(d), "serve")
    assert "pinned" in capsys.readouterr().err
    s2 = cli._boot_salt(str(d), "serve")
    assert s1 == s2 and s1 & 1 and 0 < s1 < 1 << 32
    assert capsys.readouterr().err == ""
    (d / "boot_salt").write_text("0x0\n")
    s3 = cli._boot_salt(str(d), "serve")
    assert s3 & 1 and "malformed" in capsys.readouterr().err
    assert cli._boot_salt(str(d), "serve") == s3
    assert jcli._boot_salt(str(d), "serve") == s3   # the same file format
    for s in (cli._boot_salt(None, "serve"), cli._boot_salt("", "serve")):
        assert s & 1 and 0 < s < 1 << 32


def test_serve_tiered_warm_requires_mega(capsys):
    assert cli.main(["serve", "--device", "cpu", "--tiered-warm"]) == 1
    assert "--mega" in capsys.readouterr().err


def test_cli_serve_device_loop_tiered_cache_cpu(tmp_path, capsys):
    """``serve --device-loop 2 --mega auto --tiered-warm --compile-cache
    DIR`` on the CPU: served in rounds, the boot block filled, the salt
    pinned in the cache directory."""
    import json

    rc = cli.main(["serve", "--device", "cpu", "--table-capacity", "4096",
                   "--batches", "40", "--packets", str(40 * 2048),
                   "--rate", "1e9", "--mega", "auto", "--device-loop", "2",
                   "--tiered-warm", "--compile-cache", str(tmp_path / "c"),
                   "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["dispatch"]["mode"] == "device_loop"
    assert rep["dispatch"]["device_loop"]["ring"] == 2
    boot = rep["boot"]
    assert boot["tiered"] is True and "fill_error" not in boot
    assert boot["fill_pending"] == [] and boot["fill_active"] is False
    assert boot["cache"]["dir"] == str(tmp_path / "c")
    assert boot["time_to_first_verdict_s"] > 0 and boot["import_s"] > 0
    assert (tmp_path / "c" / "boot_salt").exists()


# ---------------------------------------------------------------------------
# the tiered warm
# ---------------------------------------------------------------------------


def test_tiered_partial_ladder_equals_reference_full_warm(tmp_path):
    """The fill held (it never runs): the ready set stays at the serving
    tier for the whole drain, only singles and the top rung dispatch,
    and stats, blacklist with untils and table equal the reference's
    engine warmed in full."""
    recs = _recs(24, seed=3)
    jcfg, tcfg = _cfgs(1 << 12, 256, 64, pps=200.0, readback_depth=4)
    jsink, tsink = JCollectSink(), CollectSink()
    je = JEngine(jcfg, JArraySource(recs.copy()), jsink, mega_n="auto",
                 readback_depth=4, sink_thread=False)
    je.warm()
    te = Engine(tcfg, ArraySource(recs.copy()), tsink, device="cpu",
                mega_n="auto", sink_thread=False,
                compile_cache=tmp_path / "cache")
    te._warm_worker = lambda: None
    te.warm(tiered=True)
    assert te.warm_fill_join(10.0)
    assert te._ready_sizes == te._mega_sizes[:1] == (8,)
    jr, tr = je.run(), te.run()
    _assert_same_result(je, jsink, jr, te, tsink, tr)
    hist = {int(g): n for g, n in tr.dispatch["group_hist"].items()}
    assert set(hist) <= {1, 8} and sum(g * n for g, n in hist.items()) == 24
    assert tr.boot["tiered"] is True
    assert tr.boot["fill_pending"] == ["mega4", "mega2"]


def test_background_fill_completes_ladder_and_ring(tmp_path):
    """Unheld: serving opens on the top rung, the fill makes every rung
    and the ring ready, and the boot block tells the whole story; a
    drain afterwards equals the reference's ring engine."""
    recs = _recs(38, seed=4)
    jcfg, tcfg = _cfgs(1 << 12, 256, 64, pps=200.0, readback_depth=4)
    te = Engine(tcfg, ArraySource(recs.copy()), CollectSink(),
                device="cpu", mega_n="auto", device_loop=2,
                sink_thread=False, compile_cache=tmp_path / "cache")
    gate = threading.Event()
    worker = te._warm_worker

    def held():
        gate.wait(10.0)
        worker()

    te._warm_worker = held
    te.warm(tiered=True)
    assert te._ready_sizes == (8,) and te._ring_ready is False
    assert te.warm_fill_active()
    gate.set()
    assert te.warm_fill_join(30.0)
    assert te._ready_sizes == te._mega_sizes and te._ring_ready is True
    tr = te.run()
    boot = tr.boot
    assert boot["fill_pending"] == [] and "fill_error" not in boot
    assert boot["fill_done_s"] >= boot["serving_ready_s"]
    assert boot["fill_active"] is False
    assert set(boot["variants"]) == {"mega4", "mega2", "ring"}
    jsink = JCollectSink()
    je = JEngine(jcfg, JArraySource(recs.copy()), jsink, mega_n="auto",
                 device_loop=2, sink_thread=False)
    jr = je.run()
    assert tr.stats == jr.stats and te.sink.blocked == jsink.blocked
    assert tr.dispatch["group_hist"] == jr.dispatch["group_hist"]


def test_warm_refused_while_filling():
    _, tcfg = _cfgs(1 << 12, 128, 64)
    e = Engine(tcfg, ArraySource(_recs(2, batch=128)), CollectSink(),
               device="cpu", mega_n="auto", sink_thread=False)
    gate = threading.Event()
    e._warm_worker = gate.wait      # a fill that never finishes
    e.warm(tiered=True)
    try:
        with pytest.raises(RuntimeError, match="warm fill"):
            e.warm()
    finally:
        gate.set()
        assert e.warm_fill_join(10.0)


def test_run_joins_background_fill():
    """``run()`` returns with the fill done: a short-lived serve never
    hands a capturing thread to interpreter teardown."""
    _, tcfg = _cfgs(1 << 12, 128, 64)
    e = Engine(tcfg, ArraySource(_recs(2, batch=128)), CollectSink(),
               device="cpu", mega_n="auto", sink_thread=False)
    gate = threading.Event()
    worker = e._warm_worker

    def slow():
        gate.wait(0.5)
        worker()

    e._warm_worker = slow
    e.warm(tiered=True)
    rep = e.run()
    assert not e.warm_fill_active()
    assert e._ready_sizes == e._mega_sizes
    assert rep.boot["fill_pending"] == []


def test_fill_error_is_recorded_and_rung_stays_unready():
    """A capture that fails on the fill thread is recorded as
    ``fill_error``; its rung stays unready and serving goes on through
    the ready ones, the same bytes."""
    recs = _recs(12, seed=6)
    _, tcfg = _cfgs(1 << 12, 256, 64, pps=200.0)
    e = Engine(tcfg, ArraySource(recs.copy()), CollectSink(), device="cpu",
               mega_n="auto", sink_thread=False)

    def broken(key, scratch):
        raise RuntimeError("capture failed")

    e._fill_one = broken
    e.warm(tiered=True)
    assert e.warm_fill_join(10.0)
    rep = e.run()
    assert "capture failed" in rep.boot["fill_error"]
    assert e._ready_sizes == (8,)
    e0 = Engine(tcfg, ArraySource(recs.copy()), CollectSink(),
                device="cpu", sink_thread=False)
    r0 = e0.run()
    assert rep.stats == r0.stats and e.sink.blocked == e0.sink.blocked


def test_first_verdict_and_boot_report():
    """``time_to_first_verdict_s`` is stamped by the first sink that
    carried records (the masked warm batches never stamp it);
    ``import_s`` is the caller's; no boot block before a warm."""
    _, tcfg = _cfgs(1 << 12, 128, 64)
    e = Engine(tcfg, ArraySource(_recs(3, batch=128)), CollectSink(),
               device="cpu", mega_n="auto", sink_thread=False)
    assert e.run().boot is None
    e = Engine(tcfg, ArraySource(_recs(3, batch=128)), CollectSink(),
               device="cpu", mega_n="auto", sink_thread=False)
    e.boot_import_s = 1.25
    e.warm()
    assert e._first_verdict_s is None
    boot = e.run().boot
    assert boot["import_s"] == 1.25 and boot["tiered"] is False
    assert 0 < boot["time_to_first_verdict_s"]
    assert boot["serving_ready_s"] <= boot["time_to_first_verdict_s"]
    assert boot["variants"] == {} and boot["fill_active"] is False
