"""Configuration: typed, validated, frozen dataclasses.

Counterpart of ``flowsentryx_tpu/core/config.py``: the same sections,
defaults and validation, and the same JSON round trip
(:meth:`FsxConfig.from_json`, unknown keys refused), so every config
file the reference reads parses here.  The kernel-map packing
(``pack_kernel_config``) belongs to the BPF plane and is not copied.  A
value the port cannot serve yet is refused by name where an engine is
built (:func:`unsupported`), never dropped silently.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import typing
from dataclasses import dataclass, field
from typing import Any


class LimiterKind(enum.Enum):
    FIXED_WINDOW = "fixed_window"
    SLIDING_WINDOW = "sliding_window"
    TOKEN_BUCKET = "token_bucket"


@dataclass(frozen=True)
class LimiterConfig:
    kind: LimiterKind = LimiterKind.FIXED_WINDOW
    pps_threshold: float = 1000.0
    bps_threshold: float = 125_000_000.0
    window_s: float = 1.0
    bucket_rate_pps: float = 1000.0
    bucket_burst: float = 2000.0
    bucket_rate_bps: float = 125_000_000.0
    bucket_burst_bytes: float = 250_000_000.0
    block_s: float = 10.0

    def __post_init__(self) -> None:
        if self.window_s <= 0:
            raise ValueError("window_s must be positive")
        if self.block_s < 0:
            raise ValueError("block_s must be non-negative")
        if min(self.pps_threshold, self.bps_threshold,
               self.bucket_rate_pps, self.bucket_burst,
               self.bucket_rate_bps, self.bucket_burst_bytes) < 0:
            raise ValueError("thresholds must be non-negative")
        if (self.bucket_rate_bps == 0) != (self.bucket_burst_bytes == 0):
            raise ValueError(
                "bucket_rate_bps and bucket_burst_bytes must be both "
                "zero (byte dimension off) or both positive")


#: L4 protocol names accepted in rules (number literals also work).
_PROTO_CODES = {"any": 0, "icmp": 1, "tcp": 6, "udp": 17, "icmpv6": 58}
#: At most this many stateless rules (the kernel rule map's size).
MAX_RULES = 1024


@dataclass(frozen=True)
class RuleConfig:
    """One stateless-firewall drop rule of the kernel data plane:
    ``proto``/``dport`` of 0 (or ``"any"``) are wildcards, at least one
    must be concrete."""

    proto: str | int = "any"
    dport: int = 0
    action: str = "drop"

    def __post_init__(self) -> None:
        if self.action != "drop":
            raise ValueError(f"unknown rule action {self.action!r}")
        if not 0 <= self.dport <= 65535:
            raise ValueError("dport must be 0..65535")
        if self.proto_code() == 0 and self.dport == 0:
            raise ValueError("a rule needs a concrete proto or dport")

    def proto_code(self) -> int:
        if isinstance(self.proto, int):
            if not 0 <= self.proto <= 255:
                raise ValueError("proto number must be 0..255")
            return self.proto
        try:
            return _PROTO_CODES[self.proto.lower()]
        except KeyError:
            raise ValueError(f"unknown protocol {self.proto!r}") from None

    def key(self) -> int:
        """Rule-map key ``(l4_proto << 16) | dport``."""
        return ((self.proto_code() & 0xFF) << 16) | (self.dport & 0xFFFF)


@dataclass(frozen=True)
class ModelConfig:
    """Classifier selection and decision policy (young-flow vote:
    ``vote_k`` records before votes count, ``vote_m`` votes to block,
    ``vote_decay_s`` vote half-life)."""

    name: str = "logreg_int8"
    threshold: float = 0.5
    quantized: bool = True
    ml_block_s: float = 10.0
    vote_k: int = 4
    vote_m: int = 2
    vote_decay_s: float = 60.0

    def __post_init__(self) -> None:
        if self.vote_k < 0:
            raise ValueError("vote_k must be >= 0")
        if self.vote_m < 1:
            raise ValueError("vote_m must be >= 1")
        if self.vote_decay_s < 0:
            raise ValueError("vote_decay_s must be >= 0")


@dataclass(frozen=True)
class TableConfig:
    """State-table sizing; the default 2^20 rows is the reference's
    production size.  ``evict_ttl_s > 0`` turns on the in-step eviction
    sweep (:func:`~flowsentryx_tpu_torch.ops.fused.evict_idle_epoch`):
    each batch opens by freeing the rows idle longer than the ttl in one
    ``ceil(capacity / evict_every)``-row window, the window advancing
    with the batch counter; 0 leaves the step as it was without it."""

    capacity: int = 1 << 20
    probes: int = 8
    stale_s: float = 30.0
    salt: int = 0
    evict_ttl_s: float = 0.0
    evict_every: int = 64

    def __post_init__(self) -> None:
        if self.capacity & (self.capacity - 1) or self.capacity <= 0:
            raise ValueError("capacity must be a power of two")
        if self.capacity > 1 << 29:
            # slot_pri = slot*2 + bit, parked at 2*capacity, must stay
            # below 2^30 so the (slot_pri << 32 | key) sort key fits int64
            raise ValueError("capacity must be <= 2^29")
        if self.probes < 1:
            raise ValueError("probes must be >= 1")
        if not 0 <= self.salt < 1 << 32:
            raise ValueError("salt must fit in u32")
        if self.evict_ttl_s < 0:
            raise ValueError("evict_ttl_s must be >= 0 (0 disables)")
        if self.evict_every < 1:
            raise ValueError("evict_every must be >= 1")


@dataclass(frozen=True)
class BatchConfig:
    """Micro-batcher policy: flush at ``max_batch`` records or after
    ``deadline_us``; ``verdict_k`` compact-wire slots; ``readback_depth``
    batches in flight before the oldest is reaped."""

    max_batch: int = 2048
    deadline_us: int = 200
    verdict_k: int = 64
    readback_depth: int = 8

    def __post_init__(self) -> None:
        if self.max_batch <= 0 or self.deadline_us <= 0:
            raise ValueError("max_batch and deadline_us must be positive")
        if not isinstance(self.verdict_k, int):
            raise ValueError("verdict_k must be an int")
        if self.verdict_k < 0:
            raise ValueError("verdict_k must be >= 0 (0 disables compaction)")
        if self.verdict_k > self.max_batch:
            raise ValueError(
                f"verdict_k ({self.verdict_k}) must be <= max_batch "
                f"({self.max_batch}): a batch cannot block more flows "
                "than it has records")
        if self.readback_depth < 1:
            raise ValueError("readback_depth must be >= 1 (the pipe "
                             "needs at least one in-flight batch)")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: ``ip_axis`` devices shard the table rows by
    IP hash.  The port serves one device (:func:`unsupported`)."""

    ip_axis: int = 1
    axis_name: str = "ip"


@dataclass(frozen=True)
class FsxConfig:
    limiter: LimiterConfig = field(default_factory=LimiterConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    table: TableConfig = field(default_factory=TableConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    #: Stateless firewall rules (kernel plane; RuleConfig docstring)
    rules: tuple[RuleConfig, ...] = ()
    interface: str = "eth0"             # XDP attach point

    def __post_init__(self) -> None:
        if len(self.rules) > MAX_RULES:
            raise ValueError(f"at most {MAX_RULES} rules")
        keys = [r.key() for r in self.rules]
        if len(set(keys)) != len(keys):
            raise ValueError("duplicate (proto, dport) rule")

    # -- JSON round trip ----------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        def enc(obj: Any) -> Any:
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return {f.name: enc(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)}
            if isinstance(obj, enum.Enum):
                return obj.value
            if isinstance(obj, (list, tuple)):
                return [enc(x) for x in obj]
            return obj

        return enc(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FsxConfig":
        def dec(tp: type, v: Any) -> Any:
            origin = typing.get_origin(tp)
            if origin in (tuple, list):
                elem = typing.get_args(tp)[0]
                return tuple(dec(elem, x) for x in v)
            if dataclasses.is_dataclass(tp):
                hints = typing.get_type_hints(tp)
                names = {f.name for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, val in v.items():
                    if k not in names:
                        raise KeyError(
                            f"unknown config key {k!r} for {tp.__name__}")
                    kwargs[k] = dec(hints[k], val)
                return tp(**kwargs)
            if isinstance(tp, type) and issubclass(tp, enum.Enum):
                return tp(v)
            return v

        return dec(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "FsxConfig":
        return cls.from_dict(json.loads(s))


DEFAULT_CONFIG = FsxConfig()


def unsupported(cfg: FsxConfig) -> list[str]:
    """The settings of ``cfg`` this port cannot serve yet, by name (an
    engine refuses such a config rather than dropping the setting)."""
    out = []
    if cfg.mesh.ip_axis > 1:
        out.append(f"mesh.ip_axis={cfg.mesh.ip_axis}: the sharded "
                   "multi-device step is not ported (one device only)")
    return out

