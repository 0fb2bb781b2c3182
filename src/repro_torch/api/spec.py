"""``PartitionSpec``: a frozen, JSON-round-trippable partitioning request.

Port of ``repro.api.spec``. A spec fully determines a run (algorithm, K,
balance condition, stream order, seed, per-algorithm knobs) and is validated
at construction against the registry, so an invalid or not-yet-ported
request fails before any graph is streamed. The JSON form is the
reference's, so one spec file drives both packages.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.api.registry import PartitionerInfo, get_info

__all__ = ["PartitionSpec", "STREAM_ORDERS"]

STREAM_ORDERS = ("natural", "random", "bfs", "dfs")
_BALANCE_MODES = ("vertex", "edge")


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """Declarative request: ``partition(graph, spec) -> PartitionResult``.

    ``params`` may be the algorithm's typed params dataclass, a plain dict of
    its fields, or None (defaults); it is normalized to the typed block.
    ``source`` names the graph when the caller passes none:
    ``"rmat:<n>[:<avg_degree>]"`` or ``"dataset:<name>"``.
    ``replication_budget`` is the serving layer's knob, carried so specs
    round-trip with the reference; nothing in this slice reads it.
    """

    algo: str
    k: int
    epsilon: float = 0.05
    balance_mode: str = "edge"
    order: str = "natural"
    seed: int = 0
    params: Any = None
    source: str | None = None
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
        if self.order not in STREAM_ORDERS:
            raise ValueError(
                f"unknown stream order {self.order!r}; expected one of "
                f"{STREAM_ORDERS}"
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
            from repro_torch.graph.generators import validate_source

            validate_source(self.source)
        object.__setattr__(self, "params", _normalize_params(info, self.params))

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
        return _check_param_types(info, cls(**params))
    raise ValueError(
        f"params for {info.name!r} must be a dict or {cls.__name__}, "
        f"got {type(params).__name__}"
    )


# field annotations in the params blocks (all from-__future__ strings)
_FIELD_TYPES = {"int": int, "float": (int, float), "bool": bool, "str": str}


def _check_param_types(info: PartitionerInfo, block: Any):
    """Field-by-field value typing, so a bad spec fails at construction."""
    for field in dataclasses.fields(block):
        value = getattr(block, field.name)
        ann = field.type
        if value is None:
            if "None" in ann:
                continue
            raise ValueError(
                f"{info.name!r} param {field.name!r} must be {ann}, got None"
            )
        expected = _FIELD_TYPES[ann.split(" |")[0].strip()]
        ok = isinstance(value, expected)
        if expected is not bool and isinstance(value, bool):
            ok = False  # bool passes isinstance(int) but is never a knob value
        if not ok:
            raise ValueError(
                f"{info.name!r} param {field.name!r} must be {ann}, "
                f"got {type(value).__name__} {value!r}"
            )
    from repro_torch.core.engine import EngineConfig

    # every ported block has a chunk; EngineConfig raises for chunk < 1 and
    # for prefetch outside auto/on/off or "on" (not ported yet)
    EngineConfig(chunk=block.chunk, prefetch=getattr(block, "prefetch", "auto"))
    if hasattr(block, "strategy"):
        from repro_torch.core.priority import make_priority

        make_priority(block.strategy, 1)  # raises for unknown / unported names
    return block
