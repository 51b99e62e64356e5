"""Config dataclasses from a YAML file and ``KEY=VALUE`` overrides.

Counterpart of ``gym_formation_tpu/utils/config.py``: every learner config is
a frozen dataclass; :func:`load_config` merges a YAML file (optional, needs
PyYAML) and ``key=value`` strings onto its defaults, rejecting unknown keys;
:func:`save_config` writes one out as YAML, which :func:`load_config` reads
back to an equal config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_dict(cls: Type[T], d: Mapping[str, Any]) -> T:
    """Build a dataclass from a mapping, rejecting unknown keys (lists
    become tuples)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}; "
                         f"valid: {sorted(fields)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _parse_scalar(s: str) -> Any:
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


def load_config(cls: Type[T], yaml_path: Optional[str] = None, overrides: Sequence[str] = (),
                base: Optional[Mapping[str, Any]] = None) -> T:
    """Defaults ← ``base`` (e.g. a checkpoint's config) ← YAML file ←
    ``key=value`` override strings."""
    d: Dict[str, Any] = dict(base or {})
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            d.update(yaml.safe_load(f) or {})
    for ov in overrides:
        k, sep, v = ov.partition("=")
        if not sep:
            raise ValueError(f"override must be key=value: {ov!r}")
        d[k.strip()] = _parse_scalar(v.strip())
    return from_dict(cls, d)


def save_config(cfg: Any, yaml_path: str) -> None:
    """``cfg`` as a YAML mapping of its fields (tuples as lists)."""
    import yaml

    d = {k: list(v) if isinstance(v, tuple) else v for k, v in to_dict(cfg).items()}
    with open(yaml_path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=True)
