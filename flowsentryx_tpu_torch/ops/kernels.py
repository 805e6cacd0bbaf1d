"""The port's two hand-written CUDA kernels, their wrappers, their plain
PyTorch versions, and the build.

=================  ===============================================  ==========================
kernel             replaces (Pallas TPU kernel)                     source
=================  ===============================================  ==========================
``score_int8``     ``flowsentryx_tpu/ops/pallas_kernels.py:54-116``  ``csrc/score_int8.cu``
``table_summary``  ``flowsentryx_tpu/ops/pallas_kernels.py:126-262`` ``csrc/table_summary.cu``
=================  ===============================================  ==========================

``score_int8`` runs eight lanes per row with its parameters and a
256-entry output table passed by value (:func:`pack_score_params`);
``table_summary`` reads keys as 16-byte words, four rows per lane, then
spreads the tracked bits across the warp with ballots so that its
predicated state loads are coalesced, all issued before any is consumed.
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
with a plain C interface per source (``build/kernels/``, keyed by a hash
of the source), loaded with ``ctypes``.  :func:`build_all` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import f32
from flowsentryx_tpu_torch.core.schema import NUM_TABLE_COLS, TableCol
from flowsentryx_tpu_torch.models import logreg

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: Build output, at the repository root (listed in .gitignore).
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: dict[str, int] = {"score_int8": 0, "table_summary": 0}

_SOURCES = {"score_int8": "score_int8.cu", "table_summary": "table_summary.cu"}
_ARGTYPES = {
    # x, out, b, &ScoreArgs, stream
    "score_int8": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p],
    # key, state, n, row_stride, now, stale_s, counts, newest_bits, stream
    "table_summary": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}
_FNS: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def build_all(names=None) -> dict[str, dict]:
    """Build every missing kernel library in parallel (one ``nvcc`` per
    source, started together).  Returns per-kernel ``{"seconds",
    "cached", "ptxas"}``; raises if any build fails."""
    names = list(names or _SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    info: dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
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
        info[name] = {"seconds": round(time.perf_counter() - t0, 3),
                      "cached": False,
                      "ptxas": " ".join(
                          ln.split("ptxas info    : ")[-1]
                          for ln in log.splitlines() if "Used" in ln)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return info


def _fn(name: str):
    """The kernel's ctypes entry point, built and loaded at first use."""
    fn = _FNS.get(name)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"fsx_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        if name == "score_int8":
            size = lib.fsx_score_args_size()
            if size != ctypes.sizeof(_ScoreArgs):
                raise RuntimeError(f"score_int8: kernel argument struct is "
                                   f"{size} B, the wrapper's "
                                   f"{ctypes.sizeof(_ScoreArgs)} B")
        _FNS[name] = fn
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
    """``ScoreArgs`` of ``csrc/score_int8.cu``, passed to the kernel by
    value (1,060 B, in the constant bank)."""

    _fields_ = [("in_scale", ctypes.c_float), ("in_zp", ctypes.c_float),
                ("s", ctypes.c_float), ("bias", ctypes.c_float),
                ("out_scale", ctypes.c_float), ("out_zp", ctypes.c_float),
                ("log1p", ctypes.c_int), ("w_lo", ctypes.c_uint32),
                ("w_hi", ctypes.c_uint32), ("table", ctypes.c_float * 256)]


class ScorePack(NamedTuple):
    """:func:`score_int8`'s parameters, packed once per params."""

    args: _ScoreArgs       # the kernel's argument struct (host memory)
    args_ptr: int          # its address, passed to every launch
    table: torch.Tensor    # [256] f32 score per output code q_y
    device: torch.device   # the params' device


def pack_score_params(params: logreg.LogRegParams) -> ScorePack:
    """Pack ``params`` for the kernel: the scalars, the eight int8
    weights as two little-endian words, ``s = in_scale * w_scale`` in
    f32, and the output table — :func:`~..models.logreg.score_from_code`
    of every code 0..255, computed on the params' device with the plain
    version's own arithmetic, so a lookup equals the plain output there.
    Reads the params on the host (one copy); the owner of the params
    packs once (the engine, at construction) and passes the pack to
    :func:`score_int8`."""
    device = params.out_scale.device
    table = logreg.score_from_code(
        params, torch.arange(256, dtype=torch.float32, device=device))
    h = logreg.params_to_numpy(params)
    words = np.ascontiguousarray(h["w_int8"].astype(np.int8)).view("<u4")
    args = _ScoreArgs(
        in_scale=float(h["in_scale"]), in_zp=float(h["in_zp"]),
        s=float(np.float32(h["in_scale"]) * np.float32(h["w_scale"])),
        bias=float(h["bias"]), out_scale=float(h["out_scale"]),
        out_zp=float(h["out_zp"]), log1p=int(h["log1p"] > 0),
        w_lo=int(words[0]), w_hi=int(words[1]))
    args.table[:] = table.cpu().tolist()
    return ScorePack(args=args, args_ptr=ctypes.addressof(args), table=table,
                     device=device)


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
    LAUNCHES["score_int8"] += 1
    _check(fn(ptr, out.data_ptr(), b, p.args_ptr, _stream(x)),
           "score_int8")
    return out


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
    LAUNCHES["table_summary"] += 1
    _check(fn(ptr, state.data_ptr(), key.shape[0], state.stride(0), f32(now),
              f32(stale_s), o, o + 24, _stream(key)), "table_summary")
    return out[:3], out[3:].view(torch.float32)[0]


def table_summary(table, now: float, stale_s: float = 30.0) -> dict:
    """Operational counters over the live table, one device pass (the
    reference's ``pallas_kernels.table_summary`` report dict)."""
    counts, newest = table_summary_counts(table.key, table.state, now,
                                          stale_s)
    c = counts.cpu().numpy()
    return {
        "tracked": int(c[0]),
        "blocked": int(c[1]),
        "stale": int(c[2]),
        "newest_seen_s": float(np.float32(newest.cpu())),
    }
