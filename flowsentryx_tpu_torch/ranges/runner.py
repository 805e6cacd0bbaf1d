"""Variant staging + report assembly for ``fsx ranges``.

Counterpart of ``flowsentryx_tpu/ranges/runner.py``.  Stages every
serving-step variant through the audit's shared staging surface
(:func:`..audit.runner.stage_variants`: singles, sharded, every mega
rung, the ring, eviction via the caller's config), records each one's
aten graph once by the audit's tracing rule, seeds its inputs from the
declared range registry (:mod:`.seeds`), runs the interval prover
(:mod:`.prover`), audits the ``WRAP_OK`` registry and the float64
allowlist for staleness, and proves the three planted negative controls
still fire, and (when a distill artifact is available) runs the BPF
containment bridge (:mod:`.bridge`).  One JSON-able report, the ``fsx
audit`` idiom.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any

import torch

from flowsentryx_tpu_torch.audit import graph
from flowsentryx_tpu_torch.audit.graph import Finding
from flowsentryx_tpu_torch.audit.runner import stage_variants
from flowsentryx_tpu_torch.core import wire as W
from flowsentryx_tpu_torch.core.config import FsxConfig
from flowsentryx_tpu_torch.core.device import resolve_device
from flowsentryx_tpu_torch.ranges import prover, registry, seeds

#: The distill artifact the bridge proves when none is named.
DEFAULT_ARTIFACT = "artifacts/logreg_int8.npz"


@dataclasses.dataclass
class VariantRanges:
    """One staged variant's range-proof result."""

    name: str
    ok: bool
    findings: list[Finding]
    n_eqns: int
    n_checked: int
    wrap_ok_matches: dict
    unmodeled: dict
    traced_as: str = ""

    def to_json(self) -> dict:
        return {
            "name": self.name, "ok": self.ok,
            "findings": [f.to_json() for f in self.findings],
            "n_eqns": self.n_eqns, "n_checked": self.n_checked,
            "wrap_ok_matches": self.wrap_ok_matches,
            "unmodeled": self.unmodeled, "traced_as": self.traced_as,
        }


@dataclasses.dataclass
class RangesReport:
    """The full ``fsx ranges`` result."""

    ok: bool
    variants: list[VariantRanges]
    registry_findings: list[Finding]
    registry: list[dict]
    negatives: dict
    bridge: dict | None
    config: dict
    backend: str
    torch_version: str
    notes: list[str]
    seconds: float = 0.0

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "torch_version": self.torch_version,
            "backend": self.backend,
            "config": self.config,
            "notes": self.notes,
            "variants": [v.to_json() for v in self.variants],
            "wrap_ok_registry": self.registry,
            "reference_counterparts": registry.REFERENCE_COUNTERPARTS,
            "registry_findings": [f.to_json()
                                  for f in self.registry_findings],
            "negative_controls": self.negatives,
            "bridge": self.bridge,
            "seconds": self.seconds,
        }


# -- planted negative controls ----------------------------------------------


def _analyze_fn(fn, *args) -> prover.Analysis:
    tr, _ = graph.trace_call(fn, args, tuple(f"arg{i}"
                                             for i in range(len(args))))
    return prover.analyze(tr, {})


def negative_controls() -> dict:
    """Three deliberately broken inputs, each of whose finding class must
    fire with a node-level diagnostic: an unguarded full-range add, a
    narrowing convert, a stale ``WRAP_OK`` entry."""
    out: dict = {}

    # 1. two full-range int32 vectors summed with no guard
    def unguarded(a, b):
        return a + b
    an = _analyze_fn(unguarded, torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32))
    f = [x for x in an.findings if "add result" in x.reason]
    out["unguarded_full_range_add"] = {
        "fired": bool(f and f[0].where and f[0].eqn),
        "finding": f[0].to_json() if f else None,
    }

    # 2. a full-range int32 narrowed to uint8
    def narrowing(a):
        return a.to(torch.uint8)
    an = _analyze_fn(narrowing, torch.zeros(4, dtype=torch.int32))
    f = [x for x in an.findings if "narrowing convert" in x.reason]
    out["narrowing_convert"] = {
        "fired": bool(f and f[0].where and f[0].eqn),
        "finding": f[0].to_json() if f else None,
    }

    # 3. a WRAP_OK entry naming a function that does not exist
    stale = registry.WrapOk(
        "planted-stale", "flowsentryx_tpu_torch/ops/hashtable.py",
        "deleted_function_xyz", frozenset({"add"}), "planted control")
    f = registry.audit_registry((stale,), {"planted-stale": 1})
    out["stale_wrap_ok"] = {
        "fired": bool(f and "stale WRAP_OK" in f[0].reason),
        "finding": f[0].to_json() if f else None,
    }
    out["ok"] = all(v["fired"] for k, v in out.items() if k != "ok")
    return out


def _seeds_for(tr: graph.StepTrace, wire: str, max_batch: int) -> dict:
    return seeds.variant_seeds(
        {n: (prover.np_dtype(tr.values[v].dtype), tr.values[v].shape)
         for n, v in tr.inputs.items()}, wire, max_batch)


def run_ranges(
    cfg: FsxConfig,
    params: Any | None = None,
    mesh: Any | None = None,
    mega_n: int = 2,
    variants: tuple[str, ...] | None = None,
    mega_sizes: tuple[int, ...] | None = None,
    device_loop: int = 0,
    device: Any | None = None,
    artifact: str | None = DEFAULT_ARTIFACT,
) -> RangesReport:
    """Prove the no-silent-wrap property over every staged variant under
    ``cfg`` (staging exactly as :func:`~..audit.runner.run_audit`), plus
    the registry staleness audits, the planted negative controls and,
    when ``artifact`` names a loadable distill artifact, the BPF
    containment bridge (:func:`.bridge.containment_proof`)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    staged, notes, params = stage_variants(
        cfg, params=params, mesh=mesh, mega_n=mega_n, variants=variants,
        mega_sizes=mega_sizes, device_loop=device_loop, device=dev)
    done: dict[str, tuple] = {}
    reports: list[VariantRanges] = []
    match_totals: dict[str, int] = {}
    f64_totals: dict[str, int] = {}
    for sv in staged:
        got = done.get(sv.trace_key)
        if got is None:
            fn = sv.trace_fn or sv.fn
            make = sv.trace_args or sv.make_args
            tr, _ = graph.trace_call(fn, make(), ("table", "stats", "params"))
            an = prover.analyze(tr, _seeds_for(tr, sv.wire,
                                               cfg.batch.max_batch))
            _, f64 = graph.check_dtypes(tr)
            for k, v in an.wrap_matches.items():
                match_totals[k] = match_totals.get(k, 0) + v
            for k, v in f64.items():
                f64_totals[k] = f64_totals.get(k, 0) + v
            got = done[sv.trace_key] = (an,)
        an = got[0]
        reports.append(VariantRanges(
            name=sv.name, ok=an.ok, findings=an.findings,
            n_eqns=an.n_eqns, n_checked=an.n_checked,
            wrap_ok_matches=an.wrap_matches, unmodeled=an.unmodeled,
            traced_as="" if sv.trace_key == sv.name else sv.trace_key))
    reg_findings = (registry.audit_registry(registry.WRAP_OK, match_totals)
                    + graph.audit_f64_allowlist(graph.F64_OK, f64_totals))
    negatives = negative_controls()
    bridge_rep = None
    if artifact:
        apath = Path(artifact)
        if apath.is_file():
            from flowsentryx_tpu_torch.models import logreg
            from flowsentryx_tpu_torch.ranges import bridge

            try:
                art_params = logreg.load_params(str(apath))
                bridge_rep = bridge.containment_proof(art_params)
                bridge_rep["artifact"] = str(apath)
            except (ValueError, OSError, KeyError) as e:
                bridge_rep = {"ok": False, "artifact": str(apath),
                              "error": str(e)}
        else:
            notes = notes + [f"containment bridge skipped: no distill "
                             f"artifact at {artifact}"]
    ok = (all(v.ok for v in reports) and not reg_findings
          and negatives["ok"]
          and (bridge_rep is None or bridge_rep.get("ok", False)))
    return RangesReport(
        ok=ok,
        variants=reports,
        registry_findings=reg_findings,
        registry=[e.to_json() for e in registry.WRAP_OK]
        + [dict(e.to_json(), allowlist="float64") for e in graph.F64_OK],
        negatives=negatives,
        bridge=bridge_rep,
        config={
            "max_batch": cfg.batch.max_batch,
            "verdict_k": cfg.batch.verdict_k,
            "capacity": cfg.table.capacity,
            "evict_ttl_s": cfg.table.evict_ttl_s,
            "evict_every": cfg.table.evict_every,
            "model": cfg.model.name,
            "mesh_devices": mesh.size if mesh is not None else 1,
            "mega_n": mega_n,
            "device_loop": device_loop,
            "deploy_horizon_s": W.RANGE_DEPLOY_HORIZON_S,
            "stat_max": seeds.RANGE_STAT_MAX,
        },
        backend=dev.type,
        torch_version=torch.__version__,
        notes=notes,
        seconds=round(time.perf_counter() - t0, 4),
    )


def write_artifact(report: RangesReport, path: str) -> str:
    """Write the machine-readable ranges artifact and return the path."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(report.to_json(), indent=2) + "\n")
    return str(p)
