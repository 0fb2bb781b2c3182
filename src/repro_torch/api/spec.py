"""``PartitionSpec``: a frozen, JSON-round-trippable partitioning request.

Port of ``repro.api.spec``. A spec fully determines a run (algorithm, K,
balance condition, stream order, seed, per-algorithm knobs) and is validated
at construction against the registry with the reference's rules and
messages, so an invalid request fails before any graph is streamed. The
JSON form is the reference's, so one spec file drives both packages.
``source`` takes the reference's grammar: ``rmat:<n>[:<avg_degree>]``,
``dataset:<name>`` or a path to an on-disk graph.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.api.registry import PartitionerInfo, get_info
from repro_torch.core.priority import BUFFER_STRATEGIES

__all__ = ["PartitionSpec", "STREAM_ORDERS"]

STREAM_ORDERS = ("natural", "random", "bfs", "dfs")
_BALANCE_MODES = ("vertex", "edge")
# cuttana-buffcut is *defined* as the prioritized variant (eq6 spells
# algo="cuttana"), and the preserved seed loop only implements Eq. 6.
_STRATEGY_CHOICES = {
    "cuttana-buffcut": ("completeness", "gain"),
    "cuttana-legacy": ("eq6",),
}


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """Declarative request: ``partition(graph, spec) -> PartitionResult``.

    ``params`` may be given as the algorithm's typed params dataclass, a
    plain dict of its fields, or None (defaults); it is normalized to the
    typed block at construction so equality and JSON round-trips are exact.
    """

    algo: str
    k: int
    epsilon: float = 0.05
    balance_mode: str = "edge"
    order: str = "natural"
    seed: int = 0
    params: Any = None
    # where the graph comes from when the caller does not pass one:
    # "rmat:<n>[:<avg_degree>]", "dataset:<name>" or a path to an on-disk
    # graph. None means the caller supplies the graph object.
    source: str | None = None
    # the serving layer's replica budget, carried so specs round-trip with
    # the reference; nothing in the port reads it yet
    replication_budget: float = 0.0

    def __post_init__(self) -> None:
        info = get_info(self.algo)
        if not isinstance(self.k, int) or isinstance(self.k, bool) or self.k < 1:
            raise ValueError(f"k must be a positive integer, got {self.k!r}")
        if (
            not isinstance(self.epsilon, (int, float))
            or isinstance(self.epsilon, bool)
            or self.epsilon < 0
        ):
            raise ValueError(f"epsilon must be a number >= 0, got {self.epsilon!r}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an integer, got {self.seed!r}")
        if self.balance_mode not in _BALANCE_MODES:
            raise ValueError(
                f"unknown balance_mode {self.balance_mode!r}; "
                f"expected one of {_BALANCE_MODES}"
            )
        if info.balance_modes and self.balance_mode not in info.balance_modes:
            raise ValueError(
                f"{self.algo!r} supports balance modes {info.balance_modes}, "
                f"got {self.balance_mode!r}"
            )
        if self.order not in STREAM_ORDERS:
            raise ValueError(
                f"unknown stream order {self.order!r}; expected one of "
                f"{STREAM_ORDERS}"
            )
        # a knob the algorithm does not consume must stay at its default -
        # otherwise two different specs would silently produce the same run
        # (seed is exempt: "may not matter" is its understood contract)
        for name in ("epsilon", "balance_mode", "order"):
            applicable = name in info.common or (
                name == "balance_mode" and bool(info.balance_modes)
            )
            if not applicable:
                default = type(self).__dataclass_fields__[name].default
                if getattr(self, name) != default:
                    raise ValueError(
                        f"{self.algo!r} does not use {name!r} "
                        f"(accepted spec fields: {info.common or ('none',)}); "
                        f"leave it at its default {default!r}"
                    )
        if (
            not isinstance(self.replication_budget, (int, float))
            or isinstance(self.replication_budget, bool)
            or self.replication_budget < 0
        ):
            raise ValueError(
                f"replication_budget must be a number >= 0, "
                f"got {self.replication_budget!r}"
            )
        if self.source is not None:
            from repro_torch.graph.external import validate_source

            validate_source(self.source)
        object.__setattr__(self, "params", _normalize_params(info, self.params))

    # ------------------------------------------------------------ properties
    @property
    def info(self) -> PartitionerInfo:
        return get_info(self.algo)

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d = {
            "algo": self.algo,
            "k": self.k,
            "epsilon": self.epsilon,
            "balance_mode": self.balance_mode,
            "order": self.order,
            "seed": self.seed,
        }
        if self.source is not None:
            d["source"] = self.source
        if self.replication_budget != 0:
            d["replication_budget"] = self.replication_budget
        if self.params is not None:
            d["params"] = dataclasses.asdict(self.params)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PartitionSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown PartitionSpec fields {sorted(unknown)}; "
                f"expected a subset of {sorted(known)}"
            )
        if "algo" not in d or "k" not in d:
            raise ValueError("PartitionSpec requires at least 'algo' and 'k'")
        return cls(**d)

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "PartitionSpec":
        d = json.loads(s)
        if not isinstance(d, dict):
            raise ValueError("PartitionSpec JSON must be an object")
        return cls.from_dict(d)

    def replace(self, **changes) -> "PartitionSpec":
        return dataclasses.replace(self, **changes)


def _normalize_params(info: PartitionerInfo, params: Any):
    cls = info.params_cls
    if cls is None:
        if params is None or params == {}:
            return None
        raise ValueError(f"{info.name!r} takes no per-algorithm params")
    if params is None:
        return cls()
    if isinstance(params, cls):
        return _check_param_types(info, params)
    if isinstance(params, dict):
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = set(params) - valid
        if unknown:
            raise ValueError(
                f"unknown {info.name!r} params {sorted(unknown)}; "
                f"valid fields: {sorted(valid)}"
            )
        if params.get("num_shards") == "auto":
            # spec sugar for the auto-tuned shard count; 0 is the canonical
            # (JSON-round-trippable, type-checked) encoding
            params = {**params, "num_shards": 0}
        return _check_param_types(info, cls(**params))
    raise ValueError(
        f"params for {info.name!r} must be a dict or {cls.__name__}, "
        f"got {type(params).__name__}"
    )


# field annotations in the params blocks (all from-__future__ strings)
_FIELD_TYPES = {
    "int": int,
    "float": (int, float),
    "bool": bool,
    "str": str,
}


def _check_param_types(info: PartitionerInfo, block: Any):
    """Field-by-field value typing, so a bad spec (e.g. ``d_max: "big"`` in a
    hand-edited JSON) fails at construction, not mid-stream."""
    for field in dataclasses.fields(block):
        value = getattr(block, field.name)
        ann = field.type
        allow_none = "None" in ann
        if value is None:
            if allow_none:
                continue
            raise ValueError(
                f"{info.name!r} param {field.name!r} must be {ann}, got None"
            )
        expected = _FIELD_TYPES.get(ann.split(" |")[0].strip())
        if expected is None:  # unmapped annotation: leave it to the callee
            continue
        ok = isinstance(value, expected)
        if expected is not bool and isinstance(value, bool):
            ok = False  # bool passes isinstance(int) but is never a knob value
        if not ok:
            raise ValueError(
                f"{info.name!r} param {field.name!r} must be {ann}, "
                f"got {type(value).__name__} {value!r}"
            )
        if field.name == "num_shards" and value < 0:
            # 0 (spec sugar: "auto") resolves through the tuning artifact at
            # run time; anything negative is always a caller error - fail at
            # spec construction, not mid-stream
            raise ValueError(
                f"{info.name!r} param 'num_shards' must be >= 1, "
                f"or 0/'auto' for the tuned shard count, got {value!r}"
            )
        if field.name == "max_workers" and value < 0:
            raise ValueError(
                f"{info.name!r} param 'max_workers' must be >= 0 "
                f"(0 = one thread per shard up to cpu_count), got {value!r}"
            )
        if field.name == "chunk":
            auto_ok = info.name in ("cuttana-parallel", "fennel-parallel")
            if value < (0 if auto_ok else 1):
                hint = " or 0 for the tuned chunk size" if auto_ok else ""
                raise ValueError(
                    f"{info.name!r} param 'chunk' must be >= 1{hint}, "
                    f"got {value!r}"
                )
        if field.name == "prefetch" and value not in ("auto", "on", "off"):
            raise ValueError(
                f"{info.name!r} param 'prefetch' must be one of "
                f"'auto', 'on', 'off', got {value!r}"
            )
        if field.name == "strategy":
            allowed = _STRATEGY_CHOICES.get(info.name, BUFFER_STRATEGIES)
            if value not in allowed:
                raise ValueError(
                    f"{info.name!r} param 'strategy' must be one of "
                    f"{allowed}, got {value!r}"
                )
        if field.name == "num_batches" and value < 1:
            raise ValueError(
                f"{info.name!r} param 'num_batches' must be >= 1, got {value!r}"
            )
        if field.name == "drift_threshold" and value < 0:
            raise ValueError(
                f"{info.name!r} param 'drift_threshold' must be >= 0, "
                f"got {value!r}"
            )
        if field.name == "window_frac" and not (0 < value <= 1):
            raise ValueError(
                f"{info.name!r} param 'window_frac' must be in (0, 1], "
                f"got {value!r}"
            )
        if field.name == "hub_degree" and value < 2:
            raise ValueError(
                f"{info.name!r} param 'hub_degree' must be >= 2, got {value!r}"
            )
        if field.name == "cluster_cap_frac" and not (0 < value <= 1):
            raise ValueError(
                f"{info.name!r} param 'cluster_cap_frac' must be in (0, 1], "
                f"got {value!r}"
            )
    return block
