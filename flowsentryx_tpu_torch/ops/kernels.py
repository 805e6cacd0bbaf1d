"""The port's hand-written CUDA kernels, their wrappers, their plain
PyTorch versions, and the build.

===================  ===============================================  ============================
kernel               replaces (Pallas TPU kernel)                     source
===================  ===============================================  ============================
``score_int8``       ``flowsentryx_tpu/ops/pallas_kernels.py:54-116``  ``csrc/score_int8.cu``
``table_summary``    ``flowsentryx_tpu/ops/pallas_kernels.py:126-262`` ``csrc/table_summary.cu``
``segment_sum_seq``  none (the reference's in-order scatter-add)       ``csrc/segment_sum_seq.cu``
``gemv_seq``         none (the reference's QAT weight-gradient dot)   ``csrc/gemv_seq.cu``
===================  ===============================================  ============================

``score_int8`` runs eight lanes per row and reads its parameters and a
256-entry output table from a device buffer whose address is fixed for
its owner's life (:class:`ScorePack`, :func:`repack_score_params`); its
input stage and its tail also run alone, elementwise, as check entries
(:func:`score_quant_u8`, :func:`score_tail`: the distill compiler's
chain on the card);
``table_summary`` reads keys as 16-byte words, four rows per lane, then
spreads the tracked bits across the warp with ballots so that its
predicated state loads are coalesced, all issued before any is consumed.
``segment_sum_seq`` sums each sorted segment left to right, the order the
reference's ``segment_sum`` adds in (the raw48 byte sums, ``ops/agg.py``),
a warp walking each segment of 32 lanes or more;
``gemv_seq`` sums ``g^T M`` row by row with one flushing FMA per row, the
order of the reference's compiled QAT backward (``train/qat.py``), one
block per shard of a ``[S, R]`` launch (:func:`gemv_seq_shards`).
Each source's header says what bounds it on the card and what its design
does about it.

Each wrapper takes the plain version for a tensor on the CPU and, for a
CUDA tensor, launches its kernel or raises — there is no fallback.  A
wrapper checks device, dtype, shape, contiguity and alignment, allocates
its output with ``torch.empty``/``torch.zeros``, launches on the current
stream, raises on a non-zero ``cudaGetLastError()``, and adds one to
:data:`LAUNCHES` where it launches (and nowhere else).  The ctypes entry
points are resolved once per process.

The kernels are built at first use with ``nvcc`` into a shared library
with a plain C interface per source (``build/kernels/`` of the checkout,
or the directory ``FSX_KERNEL_BUILD`` names; keyed by a hash of the
source), loaded with ``ctypes``.  :func:`build_all` starts one ``nvcc``
per source, all at once; given a compile cache
(:class:`~..engine.compile_cache.CompileCache`) it loads a library from
the cache instead of building it, and stores what it builds.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import f32, xla_log1p
from flowsentryx_tpu_torch.core.schema import NUM_TABLE_COLS, TableCol
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.ops import agg

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: Build output: ``build/kernels/`` at the repository root (listed in
#: .gitignore), or the directory ``FSX_KERNEL_BUILD`` names.
BUILD_DIR = Path(os.environ.get("FSX_KERNEL_BUILD")
                 or Path(__file__).resolve().parents[2] / "build" / "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: dict[str, int] = {"score_int8": 0, "table_summary": 0,
                            "segment_sum_seq": 0, "gemv_seq": 0}

_SOURCES = {"score_int8": "score_int8.cu", "table_summary": "table_summary.cu",
            "segment_sum_seq": "segment_sum_seq.cu", "gemv_seq": "gemv_seq.cu"}
_ARGTYPES = {
    # x, out, b, device ScoreArgs*, stream
    "score_int8": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p],
    # key, state, n, row_stride, now, stale_s, counts, newest_bits, stream
    "table_summary": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    # v, seg, b, out, n, stream
    "segment_sum_seq": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    # g, m, shards, rows, k, out, stream
    "gemv_seq": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p],
    # x, out, n, stream: score_int8.cu's log1p alone (a check entry)
    "fsx_xla_log1p": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p],
    # x or acc, out, n, device ScoreArgs*, stream: score_int8.cu's input
    # stage and its tail alone (check entries)
    "fsx_score_quant_u8": [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_void_p],
    "fsx_score_tail": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p],
}
_FNS: dict[str, ctypes._CFuncPtr] = {}

#: Per thread: the counts of a graph capture in progress on it
#: (:func:`counting_into`), so a capture on a background thread neither
#: adds its launches to :data:`LAUNCHES` nor loses the launches that
#: replays on another thread add meanwhile.
_TLS = threading.local()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count(name: str, out: torch.Tensor, *operands: torch.Tensor) -> None:
    """One launch of ``name`` writing ``out`` from ``operands``: into the
    capture in progress on this thread, else into :data:`LAUNCHES`; and
    to this thread's launch hook, if one is set (:func:`counting_into`)."""
    counts = getattr(_TLS, "counts", None)
    (LAUNCHES if counts is None else counts)[name] += 1
    hook = getattr(_TLS, "hook", None)
    if hook is not None:
        hook(name, out, operands)


@contextlib.contextmanager
def counting_into(counts: dict, on_launch=None):
    """Count this thread's launches into ``counts`` (a dict keyed like
    :data:`LAUNCHES`) instead of :data:`LAUNCHES` for the ``with`` body:
    a capture's launches are the graph's, added by each replay.
    ``on_launch(name, out, operands)`` is called at each launch (the
    audit's recorder makes a graph node of it)."""
    prev = getattr(_TLS, "counts", None), getattr(_TLS, "hook", None)
    _TLS.counts, _TLS.hook = counts, on_launch
    try:
        yield counts
    finally:
        _TLS.counts, _TLS.hook = prev


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or PATH): the CUDA "
                       "kernels are built from csrc/ at first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / _SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names=None, cache=None) -> dict[str, dict]:
    """Build every missing kernel library in parallel (one ``nvcc`` per
    source, started together).  With a ``cache`` a missing library is
    first looked up there (by its file name, which carries the source
    hash), and each one built is stored there.  Returns per kernel
    ``{"source": "present" | "cache" | "build", "seconds", "cached",
    "ptxas"}``; raises if any build fails.  A cache miss, drift or
    corrupt entry builds (counted by the cache); there is no fallback to
    a plain version."""
    names = list(names or _SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    info: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            info[name] = {"source": "present", "seconds": 0.0,
                          "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        blob = cache.load(out.stem) if cache is not None else None
        if blob is not None:
            tmp.write_bytes(blob)
            os.replace(tmp, out)
            info[name] = {"source": "cache",
                          "seconds": round(time.perf_counter() - t0, 3),
                          "cached": True, "ptxas": ""}
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / _SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        if cache is not None:
            cache.store(out.stem, out.read_bytes())
        info[name] = {"source": "build",
                      "seconds": round(time.perf_counter() - t0, 3),
                      "cached": False,
                      "ptxas": " ".join(
                          ln.split("ptxas info    : ")[-1]
                          for ln in log.splitlines() if "Used" in ln)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return info


def _fn(name: str, symbol: str | None = None):
    """The kernel's ctypes entry point (``fsx_<name>``, or ``symbol`` of
    the same library), built and loaded at first use."""
    key = symbol or name
    fn = _FNS.get(key)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, key if symbol else f"fsx_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[key]
        if name == "score_int8":
            size = lib.fsx_score_args_size()
            if size != ctypes.sizeof(_ScoreArgs):
                raise RuntimeError(f"score_int8: kernel argument struct is "
                                   f"{size} B, the wrapper's "
                                   f"{ctypes.sizeof(_ScoreArgs)} B")
        _FNS[key] = fn
    return fn


def _stream(t: torch.Tensor) -> int:
    # the raw handle of the current stream of t's device, without building
    # a torch.cuda.Stream object per call
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# score_int8
# ---------------------------------------------------------------------------

class _ScoreArgs(ctypes.Structure):
    """``ScoreArgs`` of ``csrc/score_int8.cu`` (1,060 B): the kernel
    reads it from a device buffer (:class:`ScorePack`)."""

    _fields_ = [("in_scale", ctypes.c_float), ("in_zp", ctypes.c_float),
                ("s", ctypes.c_float), ("bias", ctypes.c_float),
                ("out_scale", ctypes.c_float), ("out_zp", ctypes.c_float),
                ("log1p", ctypes.c_int), ("w_lo", ctypes.c_uint32),
                ("w_hi", ctypes.c_uint32), ("table", ctypes.c_float * 256)]


#: ``ScoreArgs`` in 32-bit words, and the word its output table starts at.
SCORE_ARGS_WORDS = ctypes.sizeof(_ScoreArgs) // 4
_TABLE_WORD = _ScoreArgs.table.offset // 4


class ScorePack:
    """:func:`score_int8`'s parameters in device memory, owned for the
    life of their user (the engine).

    :attr:`buf` is the ``ScoreArgs`` struct as ``[265]`` int32 words on
    the params' device; every launch passes its address
    (:attr:`args_ptr`), which never changes, so a captured graph reads
    whatever the buffer holds when it replays.  :func:`repack_score_params`
    rewrites the contents in place.  :attr:`args` is the host image of
    the last packing (a ctypes view of its staging words) and
    :attr:`table` the ``[256]`` f32 output table inside :attr:`buf`.  On
    the CPU (the plain path, which never reads it) the buffer is a host
    tensor.

    Why a buffer and not the launch: with the struct passed by value,
    every captured graph held the boot model in its kernel node, and a
    live swap would have to capture every graph again (the counterpart
    of the recompile the reference's swap avoids) or patch the nodes
    with ``cudaGraphExecKernelNodeSetParams`` (PyTorch's ``CUDAGraph``
    does not reliably hand out the nodes of its executable graph)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cuda = device.type == "cuda"
        self.buf = torch.zeros(SCORE_ARGS_WORDS, dtype=torch.int32,
                               device=device)
        self.args_ptr = self.buf.data_ptr()
        self.table = self.buf[_TABLE_WORD:].view(torch.float32)
        self.args: _ScoreArgs | None = None
        #: The last packing's host words, and the event of their copy.
        self._staging: torch.Tensor | None = None
        self.event = None


def _pack_words(params: logreg.LogRegParams, cuda: bool) -> torch.Tensor:
    """``ScoreArgs`` of ``params`` as ``[265]`` int32 host words (pinned
    for a copy to the card): the scalars, the eight int8 weights as two
    little-endian words, ``s = in_scale * w_scale`` in f32, and the
    output table — :func:`~..models.logreg.score_from_code` of every
    code 0..255 with the plain version's own arithmetic, on the host
    (the same bits as on the card: it is IEEE float32 and float64 ops
    only, each rounded once)."""
    h = logreg.params_to_numpy(params)
    host = logreg.params_from_numpy(h)
    table = logreg.score_from_code(host, torch.arange(256,
                                                      dtype=torch.float32))
    words = torch.zeros(SCORE_ARGS_WORDS, dtype=torch.int32,
                        pin_memory=cuda)
    a = _ScoreArgs.from_address(words.data_ptr())
    w = np.ascontiguousarray(h["w_int8"].astype(np.int8)).view("<u4")
    a.in_scale, a.in_zp = float(h["in_scale"]), float(h["in_zp"])
    a.s = float(np.float32(h["in_scale"]) * np.float32(h["w_scale"]))
    a.bias, a.out_scale = float(h["bias"]), float(h["out_scale"])
    a.out_zp, a.log1p = float(h["out_zp"]), int(h["log1p"] > 0)
    a.w_lo, a.w_hi = int(w[0]), int(w[1])
    words[_TABLE_WORD:].view(torch.float32).copy_(table)
    return words


def repack_score_params(pack: ScorePack, params: logreg.LogRegParams,
                        stream=None) -> None:
    """Write ``params`` into ``pack``'s buffer IN PLACE: packed on the
    host into fresh pinned staging, then ONE async copy on ``stream``
    (default: the current stream), so launches enqueued before it read
    the old contents and launches after it the new, by stream order, and
    the host waits for nothing.  The staging is kept (with the copy's
    event) until the next repack; the pinned allocator also holds it
    until the event fires.  :attr:`ScorePack.args_ptr` never changes."""
    words = _pack_words(params, pack._cuda)
    if pack._cuda:
        with torch.cuda.device(pack.device), torch.cuda.stream(
                stream or torch.cuda.current_stream(pack.device)):
            pack.buf.copy_(words, non_blocking=True)
            pack.event = torch.cuda.Event()
            pack.event.record()
    else:
        pack.buf.copy_(words)
    pack._staging = words
    pack.args = _ScoreArgs.from_address(words.data_ptr())


def pack_score_params(params: logreg.LogRegParams,
                      stream=None) -> ScorePack:
    """A new :class:`ScorePack` on the params' device holding ``params``
    (:func:`repack_score_params`).  Reads the params on the host (one
    copy); the owner of the params packs once (the engine, at
    construction) and passes the pack to :func:`score_int8`."""
    pack = ScorePack(params.out_scale.device)
    repack_score_params(pack, params, stream)
    return pack


def score_int8_plain(params: logreg.LogRegParams,
                     x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[B, 8] -> [B]`` f32."""
    return logreg.classify_batch_int8_matmul(params, x)


def score_int8(params: logreg.LogRegParams, x: torch.Tensor,
               packed: ScorePack | None = None) -> torch.Tensor:
    """Fused int8 scorer ``[B, 8]`` f32 -> ``[B]`` f32 on the 1/256 grid.
    ``packed`` is :func:`pack_score_params` of ``params``; without it the
    params are packed for this call."""
    dev = x.device
    if dev.type == "cpu":
        return score_int8_plain(params, x)
    # checks without building a message unless one fails
    if dev.type != "cuda":
        raise ValueError(f"score_int8: unsupported device {dev}")
    ptr = x.data_ptr()
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 8
            or not x.is_contiguous() or ptr % 16):
        raise ValueError(f"score_int8: x must be a contiguous, 16-byte "
                         f"aligned [B, 8] float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    p = pack_score_params(params) if packed is None else packed
    if p.device != dev:
        raise ValueError(f"score_int8: params on {p.device}, x on {dev}")
    b = x.shape[0]
    out = torch.empty(b, dtype=torch.float32, device=dev)
    fn = _FNS.get("score_int8") or _fn("score_int8")
    _count("score_int8", out, x)
    _check(fn(ptr, out.data_ptr(), b, p.args_ptr, _stream(x)),
           "score_int8")
    return out


def score_log1p(x: torch.Tensor) -> torch.Tensor:
    """The ``score_int8`` kernel's ``log1p`` alone, elementwise over a
    contiguous float32 tensor: XLA:CPU's ``log1p``, whose plain version
    is :func:`~..core.device.xla_log1p`.  A check entry (the serving path
    runs the same device function inside :func:`score_int8`), so it is
    not counted in :data:`LAUNCHES`."""
    if x.device.type == "cpu":
        return xla_log1p(x)
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError(f"score_log1p: want a contiguous float32 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    out = torch.empty_like(x)
    fn = _FNS.get("fsx_xla_log1p") or _fn("score_int8", "fsx_xla_log1p")
    _check(fn(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x)),
           "score_log1p")
    return out


def score_quant_u8_plain(params: logreg.LogRegParams,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's input stage: ``[n]`` f32 features
    -> ``[n]`` f32 quint8 codes (0..255)."""
    return logreg._quantize_u8(logreg._maybe_log1p(params, x.float()),
                               params.in_scale, params.in_zp)


def _stage(symbol: str, params, t: torch.Tensor, dtype: torch.dtype,
           packed: ScorePack | None) -> torch.Tensor:
    """Launch one of ``score_int8.cu``'s check entries elementwise over
    the contiguous 1-D ``t`` with ``params``' ``ScoreArgs``."""
    if (t.device.type != "cuda" or t.dtype != dtype or t.dim() != 1
            or not t.is_contiguous()):
        raise ValueError(f"{symbol}: want a contiguous 1-D {dtype} CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    p = pack_score_params(params) if packed is None else packed
    if p.device != t.device:
        raise ValueError(f"{symbol}: params on {p.device}, input on "
                         f"{t.device}")
    out = torch.empty(t.shape[0], dtype=torch.float32, device=t.device)
    fn = _FNS.get(symbol) or _fn("score_int8", symbol)
    _check(fn(t.data_ptr(), out.data_ptr(), t.shape[0], p.args_ptr,
              _stream(t)), symbol)
    return out


def score_quant_u8(params: logreg.LogRegParams, x: torch.Tensor,
                   packed: ScorePack | None = None) -> torch.Tensor:
    """The ``score_int8`` kernel's input stage alone (optional XLA
    ``log1p``, true division by ``in_scale``, rint, ``+ in_zp``, clip),
    elementwise: ``[n]`` f32 -> ``[n]`` f32 codes.  A check entry built
    from the device function the kernel runs, so not counted in
    :data:`LAUNCHES`; on the CPU its plain version."""
    if x.device.type == "cpu":
        return score_quant_u8_plain(params, x)
    return _stage("fsx_score_quant_u8", params, x, torch.float32, packed)


def score_tail(params: logreg.LogRegParams, acc: torch.Tensor,
               packed: ScorePack | None = None) -> torch.Tensor:
    """The ``score_int8`` kernel's tail alone (the FMA requant, division,
    rint, clip and output-table lookup), elementwise: ``[n]`` int32
    accumulators -> ``[n]`` f32 scores; its plain version is
    :func:`~..models.logreg.score_from_acc`.  A check entry, not counted
    in :data:`LAUNCHES`."""
    if acc.device.type == "cpu":
        return logreg.score_from_acc(params, acc)
    return _stage("fsx_score_tail", params, acc, torch.int32, packed)


# ---------------------------------------------------------------------------
# table_summary
# ---------------------------------------------------------------------------


def table_summary_plain(key: torch.Tensor, state: torch.Tensor, now: float,
                        stale_s: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``([3] int64 counts, [] f32 newest)``."""
    tracked = key != 0
    blocked_until = state[:, TableCol.BLOCKED_UNTIL]
    last_seen = state[:, TableCol.LAST_SEEN]
    now, stale_s = f32(now), f32(stale_s)
    counts = torch.stack([
        tracked.sum(),
        (tracked & (blocked_until > now)).sum(),
        (tracked & (now - last_seen > stale_s)).sum(),
    ])
    newest = torch.where(tracked, last_seen, 0.0).max()
    return counts, newest


def table_summary_counts(key: torch.Tensor, state: torch.Tensor, now: float,
                         stale_s: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Tracked/blocked/stale counts and the newest last_seen over a
    ``[N]`` int32 key column and its ``[N, 12]`` f32 state (row stride
    taken as it is; no column copy).  On the card the key column must
    start on a 16-byte boundary: the kernel reads it in 16-byte words."""
    if key.device.type == "cpu":
        return table_summary_plain(key, state, now, stale_s)
    if key.device.type != "cuda":
        raise ValueError(f"table_summary: unsupported device {key.device}")
    ptr = key.data_ptr()
    if (key.dtype != torch.int32 or state.dtype != torch.float32
            or key.dim() != 1
            or state.shape != (key.shape[0], NUM_TABLE_COLS)
            or not key.is_contiguous() or ptr % 16 or state.stride(1) != 1
            or state.device != key.device):
        raise ValueError(
            f"table_summary: want a contiguous, 16-byte aligned [N] int32 "
            f"key and [N, {NUM_TABLE_COLS}] float32 state with dense rows on "
            f"one device, got {key.dtype} {tuple(key.shape)} {key.stride()} "
            f"at byte {ptr % 16} mod 16 on {key.device} and {state.dtype} "
            f"{tuple(state.shape)} {state.stride()} on {state.device}")
    # one zero fill: three int64 counts, then the newest last_seen's bits
    # in the low (little-endian) int32 of the fourth word
    out = torch.zeros(4, dtype=torch.int64, device=key.device)
    o = out.data_ptr()
    fn = _FNS.get("table_summary") or _fn("table_summary")
    _count("table_summary", out, key, state)
    _check(fn(ptr, state.data_ptr(), key.shape[0], state.stride(0), f32(now),
              f32(stale_s), o, o + 24, _stream(key)), "table_summary")
    return out[:3], out[3:].view(torch.float32)[0]


def table_summary(table, now: float, stale_s: float = 30.0,
                  mesh=None) -> dict:
    """Operational counters over the live table, one device pass (the
    reference's ``pallas_kernels.table_summary`` report dict).  On a
    process mesh (``mesh``, :mod:`..parallel.mesh`) ``table`` is this
    rank's shard: one launch over its own rows, the counts folded by
    ``psum`` and the newest ``last_seen`` by ``pmax``, which is the one
    launch over the whole table (a sum of counts and a max of maxes);
    every rank calls it."""
    counts, newest = table_summary_counts(table.key, table.state, now,
                                          stale_s)
    if mesh is not None and mesh.is_process:
        from flowsentryx_tpu_torch.parallel import exchange

        counts = exchange.psum(mesh, counts)
        newest = exchange.pmax(mesh, newest)
    c = counts.cpu().numpy()
    return {
        "tracked": int(c[0]),
        "blocked": int(c[1]),
        "stale": int(c[2]),
        "newest_seen_s": float(np.float32(newest.cpu())),
    }


# ---------------------------------------------------------------------------
# segment_sum_seq
# ---------------------------------------------------------------------------


def segment_sum_seq(v: torch.Tensor, seg: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """``[n]`` f32 per-segment sums of a ``[B]`` f32 ``v``, each segment
    added left to right (:func:`~.agg.segment_sum_seq_plain`).  On the
    card ``seg`` must be contiguous int64, non-decreasing and dense from
    0 (the step's ``cumsum(run_heads) - 1``), and ``n >= seg[-1] + 1``;
    the kernel trusts that contract (checking it would read ``seg`` on
    the host)."""
    dev = v.device
    if dev.type == "cpu":
        return agg.segment_sum_seq_plain(v, seg, n)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_seq: unsupported device {dev}")
    if (v.dtype != torch.float32 or seg.dtype != torch.int64 or v.dim() != 1
            or seg.shape != v.shape or not v.is_contiguous()
            or not seg.is_contiguous() or seg.device != dev
            or n < min(v.shape[0], 1)):
        raise ValueError(
            f"segment_sum_seq: want contiguous [B] float32 v and [B] int64 "
            f"seg on one device and n >= 1, got {v.dtype} {tuple(v.shape)} "
            f"and {seg.dtype} {tuple(seg.shape)} on {seg.device}, n={n}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _FNS.get("segment_sum_seq") or _fn("segment_sum_seq")
    _count("segment_sum_seq", out, v, seg)
    _check(fn(v.data_ptr(), seg.data_ptr(), v.shape[0], out.data_ptr(), n,
              _stream(v)), "segment_sum_seq")
    return out


# ---------------------------------------------------------------------------
# gemv_seq
# ---------------------------------------------------------------------------

_TINY = 2.0 ** -126
_MID = 1 << 28                  # an f64 whose low 29 bits are this is an f32 tie
_LOW29 = (1 << 29) - 1
_UP = 2.0 ** 100                # lifts a sum near 2^-126 into f32's normal range


def _daz(x: torch.Tensor) -> np.ndarray:
    """``x`` as float64, a denormal value flushed to a sign-preserving
    zero (XLA:CPU's DAZ)."""
    a = x.detach().cpu().numpy().astype(np.float32)
    return np.where(np.abs(a) < np.float32(_TINY), a * np.float32(0), a
                    ).astype(np.float64)


def _round_ftz(exact_hi: np.ndarray, exact_lo: np.ndarray) -> np.ndarray:
    """One float32 FMA result from its exact value ``exact_hi +
    exact_lo`` (a float64 sum and its error): rounded once to nearest
    even, then flushed to a sign-preserving zero where that rounding, at
    an unbounded exponent, is below 2^-126 (XLA:CPU's FTZ, tininess after
    rounding).  Round to odd in float64 first, so the float32 rounding of
    the result is correct; near 2^-126 round at the exponent lifted by
    2^100, where float32 is normal."""
    odd = ((exact_hi.view(np.int64) - ((exact_lo * exact_hi) < 0))
           | (exact_lo != 0)).view(np.float64)
    near = np.abs(odd) < 2.0 ** -125
    y = np.where(near, odd * _UP, odd).astype(np.float32)
    return np.where(near, np.where(np.abs(y) < np.float32(_TINY * _UP),
                                   y * np.float32(0),
                                   y * np.float32(1 / _UP)), y
                    ).astype(np.float32)


def gemv_seq_plain(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemv_seq`: ``[K]`` float32, each
    ``sum_n g[n] * m[n, k]`` as a chain of float32 fused multiply-adds in
    row order, as XLA:CPU runs it: a denormal ``g[n]`` or ``m[n, k]``
    flushed to zero before its product, a result whose rounding is below
    2^-126 flushed to zero (ROADMAP queue 3, item 40).

    Row by row in numpy: each product is exact in float64 (24 x 24 bits)
    and each step's sum is rounded to float64 and then to float32.  That
    double rounding differs from one correct rounding only where the
    float64 sum lands exactly on a float32 midpoint and is inexact; those
    steps, and any whose float32 value is within 2^-126 (a flush, or a
    rounding to 2^-126 that is tiny at an unbounded exponent), are found
    after the pass and redone from there with the sum's exact error
    (:func:`_round_ftz`), so every step is one correct rounding.  Slow
    (~2 µs a row): the chain is serial."""
    gd, md = _daz(g), _daz(m)
    prods = gd[:, None] * md
    n, k = md.shape
    sums = np.empty((n, k), np.float64)
    acc = np.zeros(k, np.float32)
    i = 0
    while i < n:
        a = acc
        for j in range(i, n):
            np.add(a, prods[j], out=sums[j])
            a = sums[j].astype(np.float32)
        rounded = sums[i:].astype(np.float32)
        prev = np.concatenate([acc[None].astype(np.float64),
                               rounded[:-1].astype(np.float64)])
        s = sums[i:]
        bb = s - prev
        err = (prev - (s - bb)) + (prods[i:] - bb)
        tie = ((s.view(np.int64) & _LOW29) == _MID) & (err != 0)
        tiny = (np.abs(rounded) <= _TINY) & (rounded != 0)
        bad = np.nonzero((tie | tiny).any(axis=1))[0]
        if not len(bad):
            return torch.from_numpy(rounded[-1].copy())
        j = i + int(bad[0])
        r = j - i
        acc = _round_ftz(s[r], err[r])
        i = j + 1
    return torch.from_numpy(acc.copy())


def gemv_seq_shards_plain(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemv_seq_shards`: ``[S, K]``, shard ``i``
    :func:`gemv_seq_plain` of ``g[i]`` and ``m[i]``."""
    return torch.stack([gemv_seq_plain(g[i], m[i])
                        for i in range(g.shape[0])])


def gemv_seq(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``g^T m`` for a ``[N]`` float32 ``g`` and ``[N, K]`` float32 ``m``
    (``K <= 8``) -> ``[K]``, each output one float32 FMA chain in row
    order (the reference's QAT weight gradient, :func:`gemv_seq_plain`):
    :func:`gemv_seq_shards` of one shard."""
    if g.device.type == "cpu":
        return gemv_seq_plain(g, m)
    if g.dim() != 1 or m.dim() != 2:
        raise ValueError(
            f"gemv_seq: want [N] and [N, K], got {tuple(g.shape)} and "
            f"{tuple(m.shape)}")
    return gemv_seq_shards(g[None], m[None])[0]


def gemv_seq_shards(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``S`` independent :func:`gemv_seq` chains in one launch: ``[S, R]``
    and ``[S, R, K]`` float32 (``K <= 8``) -> ``[S, K]``, shard ``i``
    ``g[i]^T m[i]`` in row order (the data-parallel QAT epoch's shards;
    one block per shard on the card)."""
    dev = g.device
    if dev.type == "cpu":
        return gemv_seq_shards_plain(g, m)
    if dev.type != "cuda":
        raise ValueError(f"gemv_seq: unsupported device {dev}")
    if (g.dtype != torch.float32 or m.dtype != torch.float32
            or g.dim() != 2 or m.dim() != 3 or m.shape[:2] != g.shape
            or not 1 <= m.shape[2] <= 8 or not g.is_contiguous()
            or not m.is_contiguous() or m.device != dev):
        raise ValueError(
            f"gemv_seq: want contiguous [S, R] and [S, R, K<=8] float32 on "
            f"one device, got {g.dtype} {tuple(g.shape)} and {m.dtype} "
            f"{tuple(m.shape)} on {m.device}")
    out = torch.empty(g.shape[0], m.shape[2], dtype=torch.float32,
                      device=dev)
    fn = _FNS.get("gemv_seq") or _fn("gemv_seq")
    _count("gemv_seq", out, g, m)
    _check(fn(g.data_ptr(), m.data_ptr(), g.shape[0], g.shape[1],
              m.shape[2], out.data_ptr(), _stream(g)), "gemv_seq")
    return out
