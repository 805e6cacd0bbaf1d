"""Variant staging + report assembly for ``fsx audit``.

Counterpart of ``flowsentryx_tpu/audit/runner.py``.  Stages every
serving-step variant the engine can build -- raw48 and compact16 single
shard (:mod:`..ops.fused`), the IP-hash-sharded step
(:mod:`..parallel.step`), the megastep ladder and the drain ring
(:mod:`..fused.device_loop`) -- runs the :mod:`.graph` contract checks on
each and folds the results into one JSON-able :class:`AuditReport`.

Staging a variant (:mod:`.graph` module docstring) runs its step once on
an all-masked input over scratch state: no live row and no counter
changes.  The aten graph is recorded once per distinct base step and
once per wrapper at its smallest group (a megastep rung or ring round
is the same base step N times over, in a Python loop): the megastep
ladder is traced at its smallest rung, the ring at its depth over
smallest-rung slots, and the other rungs' graph contracts are read off
that trace (``traced_as``).  Every variant, traced or not, is also run
once for its outputs (the wire budget, the output dtypes), its carried
state (the in-place contract) and its launches; on the card each is
captured as a CUDA graph, whose census is held to the transfer and
in-place contracts, and replayed twice, which must neither move the
table nor capture again.  :func:`boot_audit` is the engine's entry: it
caches by the staged-shape signature, so a boot audits each shape once
per process.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Any, Callable

import torch

from flowsentryx_tpu_torch.audit import graph
from flowsentryx_tpu_torch.audit.graph import AuditError, Finding
from flowsentryx_tpu_torch.core import schema
from flowsentryx_tpu_torch.core.config import FsxConfig
from flowsentryx_tpu_torch.core.device import resolve_device
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.registry import get_model
from flowsentryx_tpu_torch.ops import fused, kernels

#: Carried-state leaf names (table, then stats): the tensors every step
#: updates in place and returns.
CARRY_NAMES = ["table.key_rows", "table.state_rows"] + [
    f"stats.{f}" for f in schema.GlobalStats._fields]

#: The auditable variants, in report order (the reference's names).
ALL_VARIANTS = ("raw", "compact", "sharded", "megastep",
                "sharded_megastep", "device_loop",
                "sharded_device_loop")

#: The rule by which the aten graph is traced (in every report's notes).
TRACE_RULE = (
    "aten graph traced once per distinct base step and once per wrapper "
    "at its smallest group (megastep ladder: smallest rung; ring: its "
    "depth over smallest-rung slots); the other rungs read their graph "
    "contracts off that trace (traced_as) and are each run once for "
    "outputs, carry and launches, and on the card captured and censused")
WIRE_NOTE = ("verdict wire is int32 bit patterns (the reference's is "
             "uint32): the same bytes, decoded by the host as uint32")


@dataclasses.dataclass
class VariantReport:
    """One staged step variant's audit result."""

    name: str
    ok: bool
    findings: list[Finding]
    outputs: list[dict]            # name/shape/dtype/bytes per output
    n_eqns: int                    # nodes of its aten graph
    steady_state_d2h_bytes: int | None
    wire_words: int | None
    donation: dict                 # the in-place proof of the carry
    collectives: dict              # exchange site -> calls per step body
    dtypes: dict                   # dtype -> node-output count
    inplace: dict                  # table copy census
    launches: dict = dataclasses.field(default_factory=dict)
    trace_s: float = 0.0           # wall of the aten trace it reads
    traced_as: str = ""            # the variant whose trace it reads
    graph: dict | None = None      # the captured graph's census (card)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["findings"] = [f.to_json() for f in self.findings]
        return d


@dataclasses.dataclass
class AuditReport:
    """The full ``fsx audit`` result (one entry per staged variant)."""

    ok: bool
    variants: list[VariantReport]
    config: dict
    backend: str
    torch_version: str
    notes: list[str]
    registry_findings: list[Finding] = dataclasses.field(
        default_factory=list)
    seconds: float = 0.0

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "torch_version": self.torch_version,
            "backend": self.backend,
            "config": self.config,
            "notes": self.notes,
            "variants": [v.to_json() for v in self.variants],
            "f64_allowlist": [e.to_json() for e in graph.F64_OK],
            "registry_findings": [f.to_json()
                                  for f in self.registry_findings],
            "seconds": self.seconds,
        }

    def raise_if_failed(self) -> None:
        for v in self.variants:
            if not v.ok:
                raise AuditError(v.name, v.findings)


def _normalize_mega_sizes(mega_sizes: tuple[int, ...] | None,
                          mega_n: int) -> tuple[int, ...]:
    """THE one (dedup, sort-descending, validate) rule for the ladder,
    shared by :func:`run_audit` and :func:`boot_audit`'s cache key."""
    if mega_sizes is not None:
        sizes = tuple(sorted({int(s) for s in mega_sizes}, reverse=True))
        if not sizes or min(sizes) < 1:
            raise ValueError(f"mega_sizes must be >= 1, got {mega_sizes}")
        return sizes
    return (mega_n,) if mega_n >= 1 else ()


def serving_classify(spec, params):
    """The scorer a booting engine serves with: the int8 kernel with its
    parameters packed once (as ``Engine`` packs them), else the model's
    own."""
    if spec.classify_batch is kernels.score_int8:
        return functools.partial(kernels.score_int8,
                                 packed=kernels.pack_score_params(params))
    return spec.classify_batch


def _quant_for(params) -> dict:
    if isinstance(params, logreg.LogRegParams):
        return schema.wire_quant_for(logreg.LogRegParams(
            **logreg.params_to_numpy(params)))
    return {"feat_mode": "minifloat"}


@dataclasses.dataclass
class StagedVariant:
    """One stageable step variant plus what every static pass over it
    needs: the shared staging surface of ``fsx audit`` and ``fsx
    ranges`` (so the two legs can never stage different graphs)."""

    name: str
    fn: Callable
    make_args: Callable[[], tuple]
    verdict_k: int
    expect_sharded: bool
    quantized: bool
    n_bodies: int = 1              # step bodies one call runs
    ring_depth: int = 0
    n_shards: int = 1
    wire: str = schema.WIRE_COMPACT16
    in_shape: tuple = ()           # the static input a capture takes
    trace_key: str = ""            # the variant whose trace stands for it
    trace_fn: Callable | None = None
    trace_args: Callable[[], tuple] | None = None
    trace_bodies: int = 1


def stage_variants(
    cfg: FsxConfig,
    params: Any | None = None,
    mesh: Any | None = None,
    mega_n: int = 2,
    variants: tuple[str, ...] | None = None,
    mega_sizes: tuple[int, ...] | None = None,
    device_loop: int = 0,
    device: Any | None = None,
    classify: Callable | None = None,
) -> tuple[list[StagedVariant], list[str], Any]:
    """Build (without running) every requested step variant under
    ``cfg``; returns ``(staged, notes, params)``.  Argument semantics are
    :func:`run_audit`'s."""
    from flowsentryx_tpu_torch.fused import device_loop as dl
    from flowsentryx_tpu_torch.parallel import step as pstep

    dev = resolve_device(device)
    notes: list[str] = []
    spec = get_model(cfg.model.name)
    if params is None:
        params = spec.init(dev)
    params = type(params)(*(t.to(dev) for t in params))
    if classify is None:
        classify = serving_classify(spec, params)
    quantized = bool(cfg.model.quantized
                     and spec.classify_batch is kernels.score_int8)
    quant = _quant_for(params)
    shardable = mesh is not None and mesh.size > 1
    n_sh = mesh.size if shardable else 1
    sizes = _normalize_mega_sizes(mega_sizes, mega_n)
    mega_ok = bool(sizes)
    ring_ok = device_loop >= 1 and mega_ok
    if variants is None:
        variants = tuple(
            v for v in ALL_VARIANTS
            if (shardable or not v.startswith("sharded"))
            and (mega_ok or "megastep" not in v)
            and (ring_ok or "device_loop" not in v))
        if not shardable:
            notes.append("sharded variants skipped: need a >1-device "
                         "mesh (pass --mesh N: N shards of one device)")
        if not mega_ok:
            notes.append("megastep variants skipped: mega_n < 1")
        if device_loop >= 1 and not mega_ok:
            notes.append("device_loop variants skipped: the ring needs "
                         "mega group sizes (mega_n >= 1)")
    else:
        bad = [v for v in variants
               if ("megastep" in v and not mega_ok)
               or ("device_loop" in v and not ring_ok)
               or (v.startswith("sharded") and not shardable)]
        if bad:
            raise ValueError(
                f"variant(s) {bad} need "
                + ("device_loop >= 1 and mega_n >= 1"
                   if "device_loop" in bad[0]
                   else "mega_n >= 1" if "megastep" in bad[0]
                   else "a >1-device mesh"))
    if shardable and mesh.device.type != dev.type:
        raise ValueError(f"mesh shards lie on {mesh.device}, the audit "
                         f"stages on {dev}")
    b = cfg.batch.max_batch
    cw, rw = schema.COMPACT_RECORD_WORDS, schema.RECORD_WORDS

    def state(sharded: bool):
        table = (pstep.make_sharded_table(cfg, mesh) if sharded
                 else schema.make_table(cfg.table.capacity, dev))
        return table, schema.make_stats(dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def args_for(sharded: bool, *shape, slots: int = 0):
        def mk():
            if slots:
                return (*state(sharded), params,
                        *(zeros(*shape) for _ in range(slots)))
            return (*state(sharded), params, zeros(*shape))
        return mk

    staged: list[StagedVariant] = []
    common = dict(verdict_k=cfg.batch.verdict_k, quantized=quantized)
    for name in variants:
        if name == "raw":
            fn = fused.make_raw_step(cfg, classify)
            staged.append(StagedVariant(
                name, fn, args_for(False, b + 1, rw), expect_sharded=False,
                wire=schema.WIRE_RAW48, in_shape=(b + 1, rw),
                trace_key=name, **common))
        elif name == "compact":
            fn = fused.make_compact_step(cfg, classify, **quant)
            staged.append(StagedVariant(
                name, fn, args_for(False, b + 1, cw), expect_sharded=False,
                in_shape=(b + 1, cw), trace_key=name, **common))
        elif name == "sharded":
            fn = pstep.make_sharded_compact_step(cfg, classify, mesh,
                                                 **quant)
            staged.append(StagedVariant(
                name, fn, args_for(True, b + 1, cw), expect_sharded=True,
                n_shards=n_sh, in_shape=(b + 1, cw), trace_key=name,
                **common))
        elif name in ("megastep", "sharded_megastep"):
            is_sh = name == "sharded_megastep"
            fam = (pstep.make_sharded_compact_megastep_family(
                cfg, classify, mesh, sizes, **quant) if is_sh
                else fused.make_compact_megastep_family(
                    cfg, classify, sizes, **quant))
            small = min(sizes)
            key = name if len(sizes) == 1 else f"{name}@{small}"
            for n_sz in sizes:
                staged.append(StagedVariant(
                    name if len(sizes) == 1 else f"{name}@{n_sz}",
                    fam[n_sz], args_for(is_sh, n_sz, b + 1, cw),
                    expect_sharded=is_sh, n_bodies=n_sz,
                    n_shards=n_sh if is_sh else 1,
                    in_shape=(n_sz, b + 1, cw), trace_key=key, **common))
        elif name in ("device_loop", "sharded_device_loop"):
            is_sh = name == "sharded_device_loop"
            chunks, small = max(sizes), min(sizes)

            def ring(c, is_sh=is_sh):
                return (dl.make_sharded_compact_device_loop(
                    cfg, classify, mesh, device_loop, c, **quant) if is_sh
                    else dl.make_compact_device_loop(
                        cfg, classify, device_loop, c, **quant))
            fn = ring(chunks)
            sv = StagedVariant(
                f"{name}@{device_loop}x{chunks}", fn,
                args_for(is_sh, chunks, b + 1, cw, slots=device_loop),
                expect_sharded=is_sh, n_bodies=device_loop * chunks,
                ring_depth=device_loop, n_shards=n_sh if is_sh else 1,
                in_shape=(device_loop, chunks, b + 1, cw),
                trace_key=f"{name}@{device_loop}x{small}", **common)
            if small != chunks:
                sv.trace_fn = ring(small)
                sv.trace_args = args_for(is_sh, small, b + 1, cw,
                                         slots=device_loop)
                sv.trace_bodies = device_loop * small
            staged.append(sv)
        else:
            raise ValueError(f"unknown audit variant {name!r}")
    # a rung that is not its own trace key borrows the key's variant
    by_name = {sv.name: sv for sv in staged}
    for sv in staged:
        if sv.trace_key == sv.name:
            continue
        rep = by_name.get(sv.trace_key)
        if rep is not None and sv.trace_fn is None:
            sv.trace_fn, sv.trace_args = rep.fn, rep.make_args
            sv.trace_bodies = rep.n_bodies
    return staged, notes, params


def _outputs(result) -> list[tuple[str, Any]]:
    out = []
    for tree, prefix in zip(result, ("table", "stats", "out")):
        out += graph._leaves(prefix, tree)
    return out


def _carry(args) -> list[tuple[str, torch.Tensor]]:
    return graph._leaves("table", args[0]) + graph._leaves("stats", args[1])


def _table_sigs(cfg: FsxConfig) -> set[tuple]:
    cap, cols = cfg.table.capacity, schema.NUM_TABLE_COLS
    return {((r,), "int32") for r in (cap, cap + 1)} | {
        ((r, cols), "float32") for r in (cap, cap + 1)}


def _trace_checks(sv: StagedVariant, cfg: FsxConfig) -> dict:
    """Trace the variant's stand-in once and run the graph contracts."""
    fn = sv.trace_fn or sv.fn
    make = sv.trace_args or sv.make_args
    bodies = sv.trace_bodies if sv.trace_fn is not None else sv.n_bodies
    args = make()
    tr, _ = graph.trace_call(fn, args, ("table", "stats", "params"))
    findings: list[Finding] = []
    f, f64 = graph.check_dtypes(tr)
    findings += f
    findings += graph.check_host_sync(tr)
    f, inplace = graph.check_table_copies(
        tr, _table_sigs(cfg), cfg.table.capacity // sv.n_shards)
    findings += f
    f, coll = graph.check_collectives(tr, sv.verdict_k, sv.expect_sharded,
                                      bodies)
    findings += f
    dev = next(iter(tr.values.values())).device if tr.values else "cpu"
    if sv.quantized:
        findings += graph.check_quantized_lane(tr, dev,
                                               bodies * sv.n_shards)
    return {"findings": findings, "f64": f64,
            "inplace": inplace, "collectives": coll,
            "dtypes": graph.dtype_histogram(tr),
            "n_eqns": sum(1 for n in tr.nodes if n.op != "refresh"),
            "seconds": tr.seconds}


def _run_checks(sv: StagedVariant, cfg: FsxConfig) -> dict:
    """Run the variant once (all-masked input, scratch state) for its
    outputs, carried state and launches."""
    args = sv.make_args()
    before = _carry(args)
    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    with torch.no_grad(), kernels.counting_into(counts):
        result = sv.fn(*args)
    findings = graph.staging_check(sv.make_args)
    f, donation = graph.check_in_place(before, _outputs(result)[:len(before)])
    findings += f
    outputs, wire_words, wire_bytes = [], None, None
    k = sv.verdict_k
    for name, t in _outputs(result):
        if not isinstance(t, torch.Tensor):
            continue
        nbytes = t.numel() * t.element_size()
        outputs.append({"name": name, "shape": list(t.shape),
                        "dtype": graph._dtype_name(t.dtype),
                        "bytes": int(nbytes)})
        if name == "out.wire":
            shape = tuple(t.shape)
            if sv.ring_depth:
                if len(shape) != 2 or shape[0] != sv.ring_depth:
                    findings.append(Finding(
                        contract="transfer", where=name,
                        reason=(f"device-loop wire has shape {shape}, "
                                f"expected [{sv.ring_depth}, 2K+4]: one "
                                "merged verdict wire per ring slot")))
                wire_words = shape[-1]
            else:
                wire_words = t.numel()
            wire_bytes = wire_words * 4
            if t.dtype != torch.int32:
                findings.append(Finding(
                    contract="transfer", where=name,
                    reason=(f"verdict wire dtype {t.dtype}, expected "
                            "int32 bit patterns (the host decoder views "
                            "them as uint32 in place)")))
    expect = fused.verdict_wire_words(k) if k else 0
    if k <= 0:
        findings.append(Finding(
            contract="transfer",
            reason=("verdict_k == 0 disables the compact wire: "
                    "steady-state D2H is the full [B] block arrays; the "
                    "audited transfer budget requires verdict_k >= 1")))
    elif wire_words is None:
        findings.append(Finding(
            contract="transfer", where="out.wire",
            reason="no compact verdict wire in the step outputs"))
    elif wire_words != expect:
        findings.append(Finding(
            contract="transfer", where="out.wire",
            reason=(f"wire is {wire_words} words, expected 2*{k}+"
                    f"{fused.VERDICT_WIRE_SCALARS} = {expect}")))
    want = {"out.verdict": torch.uint8, "out.block_key": torch.int32,
            "out.block_until": torch.float32, "out.now": torch.float32}
    for name, t in _outputs(result):
        w = want.get(name)
        if w is not None and isinstance(t, torch.Tensor) and t.dtype != w:
            findings.append(Finding(
                contract="dtype", where=name,
                reason=(f"step output {name} is {graph._dtype_name(t.dtype)}"
                        f", contract says {graph._dtype_name(w)}")))
    if sv.quantized and args[0].key_rows.device.type == "cuda":
        want_n = sv.n_bodies * sv.n_shards
        if counts.get("score_int8", 0) != want_n:
            findings.append(Finding(
                contract="quantized", where="kernel:score_int8",
                reason=(f"{counts.get('score_int8', 0)} score_int8 launches "
                        f"in one call, expected {want_n} (one per step "
                        "body and shard)")))
    return {"findings": findings, "outputs": outputs, "donation": donation,
            "wire_words": wire_words, "wire_bytes": wire_bytes,
            "launches": {n: c for n, c in counts.items() if c},
            "args": args}


def _graph_checks(sv: StagedVariant, cfg: FsxConfig, args) -> tuple:
    """Card only: capture the variant over scratch state, census the
    captured graph, replay it twice: the table must not move and nothing
    may be captured again."""
    from flowsentryx_tpu_torch.ops import graph as cgraph

    table, stats, params = args[0], args[1], args[2]
    gr = cgraph.StepGraph(sv.fn, table, stats, params, sv.in_shape,
                          slots=bool(sv.ring_depth))
    findings = graph.check_graph_census(
        gr.census, (cfg.table.capacity // sv.n_shards) * 4)
    ptrs = [t.data_ptr() for _, t in _carry(args)]
    caps = cgraph.CAPTURES
    for _ in range(2):
        gr.graph.replay()   # the raw graph: audit replays serve no traffic
    torch.cuda.synchronize(table.key_rows.device)
    if [t.data_ptr() for _, t in _carry(args)] != ptrs:
        findings.append(Finding(
            contract="donation", where="table",
            reason="a replay moved the table or stats tensors"))
    if cgraph.CAPTURES != caps:
        findings.append(Finding(
            contract="retrace", where="cuda graph",
            reason="a replay captured a graph again"))
    census = dict(gr.census or {}, capture_s=round(gr.capture_s, 4))
    del gr
    return findings, census


def audit_variant(sv: StagedVariant, cfg: FsxConfig,
                  traces: dict | None = None) -> VariantReport:
    """Stage one variant and run every contract on it.  ``traces``
    caches the aten-graph checks by ``sv.trace_key`` across variants
    (a rung reads its smallest rung's)."""
    traces = {} if traces is None else traces
    tc = traces.get(sv.trace_key)
    if tc is None:
        tc = traces[sv.trace_key] = _trace_checks(sv, cfg)
    rc = _run_checks(sv, cfg)
    findings = list(tc["findings"]) + rc["findings"]
    census = None
    if rc["args"][0].key_rows.device.type == "cuda":
        f, census = _graph_checks(sv, cfg, rc["args"])
        findings += f
    return VariantReport(
        name=sv.name, ok=not findings, findings=findings,
        outputs=rc["outputs"], n_eqns=tc["n_eqns"],
        steady_state_d2h_bytes=rc["wire_bytes"],
        wire_words=rc["wire_words"], donation=rc["donation"],
        collectives=tc["collectives"], dtypes=tc["dtypes"],
        inplace=tc["inplace"], launches=rc["launches"],
        trace_s=round(tc["seconds"], 4),
        traced_as="" if sv.trace_key == sv.name else sv.trace_key,
        graph=census)


def run_audit(
    cfg: FsxConfig,
    params: Any | None = None,
    mesh: Any | None = None,
    mega_n: int = 2,
    variants: tuple[str, ...] | None = None,
    mega_sizes: tuple[int, ...] | None = None,
    device_loop: int = 0,
    device: Any | None = None,
    classify: Callable | None = None,
) -> AuditReport:
    """Stage and audit the requested step variants under ``cfg`` on
    ``device`` (None: the card; raises without one).

    ``variants`` defaults to everything stageable: raw + compact +
    megastep always, sharded when ``mesh`` has more than one shard, the
    ring with ``device_loop >= 1``.  ``mega_sizes`` audits the megastep
    once per group size (``megastep@<n>``).  ``classify`` is the scorer
    to stage (default: the model's, the int8 kernel packed as the
    engine packs it)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    staged, notes, params = stage_variants(
        cfg, params, mesh, mega_n, variants, mega_sizes, device_loop, dev,
        classify)
    notes = notes + [TRACE_RULE, WIRE_NOTE]
    if dev.type != "cuda":
        notes.append("captured-graph census skipped: CUDA graphs need "
                     "the card")
    traces: dict[str, dict] = {}
    reports = [audit_variant(sv, cfg, traces) for sv in staged]
    f64_total: dict[str, int] = {}
    for tc in traces.values():
        for k, v in tc["f64"].items():
            f64_total[k] = f64_total.get(k, 0) + v
    reg = graph.audit_f64_allowlist(graph.F64_OK, f64_total)
    return AuditReport(
        ok=all(v.ok for v in reports) and not reg,
        variants=reports,
        config={
            "max_batch": cfg.batch.max_batch,
            "verdict_k": cfg.batch.verdict_k,
            "capacity": cfg.table.capacity,
            "evict_ttl_s": cfg.table.evict_ttl_s,
            "evict_every": cfg.table.evict_every,
            "model": cfg.model.name,
            "mesh_devices": mesh.size if mesh is not None else 1,
            "mega_n": mega_n,
            "mega_sizes": list(_normalize_mega_sizes(mega_sizes, mega_n)),
            "device_loop": device_loop,
            "donate": True,   # in place: the port's donation
        },
        backend=dev.type,
        torch_version=torch.__version__,
        notes=notes,
        registry_findings=reg,
        seconds=round(time.perf_counter() - t0, 4),
    )


# -- engine boot hook -------------------------------------------------------

#: Completed boot audits, keyed by the staged-shape signature, the
#: staged variant set, the device kind and the scorer.
_BOOT_CACHE: dict[tuple, bool] = {}


def _classify_key(classify) -> str:
    f = getattr(classify, "func", classify)
    return f"{getattr(f, '__module__', '')}.{getattr(f, '__qualname__', f)}"


def boot_audit(
    cfg: FsxConfig,
    *,
    wire: str,
    mesh: Any | None,
    mega_n: int,
    params: Any | None = None,
    mega_sizes: tuple[int, ...] | None = None,
    device_loop: int = 0,
    device: Any | None = None,
    classify: Callable | None = None,
) -> AuditReport | None:
    """Audit exactly the variants a booting engine is about to serve
    (single or sharded, every rung of its ladder, its ring) and refuse
    the boot (raise :class:`AuditError`) on any violated contract.
    Returns None on a cache hit.  It never catches its own error."""
    from flowsentryx_tpu_torch.core.signature import (
        signature_digest, staging_signature,
    )

    dev = resolve_device(device)
    shardable = mesh is not None and mesh.size > 1
    variants: list[str] = []
    if shardable:
        variants.append("sharded")
    else:
        variants.append("compact" if wire == schema.WIRE_COMPACT16
                        else "raw")
    sizes = _normalize_mega_sizes(mega_sizes, mega_n)
    if sizes:
        variants.append("sharded_megastep" if shardable else "megastep")
    device_loop = int(device_loop)
    if device_loop >= 1 and sizes:
        variants.append("sharded_device_loop" if shardable
                        else "device_loop")
    sig = staging_signature(
        cfg, wire=wire, mesh_devices=mesh.size if shardable else 1,
        mega_sizes=sizes, device_loop=device_loop, params=params)
    key = (signature_digest(sig), tuple(variants), dev.type,
           _classify_key(classify) if classify is not None else "")
    if _BOOT_CACHE.get(key):
        return None
    rep = run_audit(cfg, params=params, mesh=mesh, mega_n=mega_n or 2,
                    variants=tuple(variants), mega_sizes=sizes or None,
                    device_loop=device_loop, device=dev, classify=classify)
    rep.raise_if_failed()
    _BOOT_CACHE[key] = True
    return rep


def audit_serving(*args: Any, **kw: Any) -> AuditReport | None:
    """Alias of :func:`boot_audit` (the engine-facing name)."""
    return boot_audit(*args, **kw)


def write_artifact(report: AuditReport, path: str) -> str:
    """Write the machine-readable audit artifact and return the path."""
    from pathlib import Path

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(report.to_json(), indent=2) + "\n")
    return str(p)
