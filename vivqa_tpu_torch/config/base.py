"""Layered config system: CLI > YAML > dataclass defaults.

Copy of vivqa_tpu/config/base.py (the port imports nothing of the JAX
package): one mixin gives every config from_dict / from_yaml / to_dict /
to_yaml / replace, with nested dataclass fields handled recursively.
PyYAML is imported only by the YAML helpers (``utils/yaml_io.py``), so a
host without it runs everything but ``--config``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T", bound="ConfigBase")


def _coerce(value: Any, typ: Any) -> Any:
    """Best-effort coercion of YAML/CLI scalars into the annotated type.

    Mirrors the reference's defensive to_int/to_float handling
    (generative_vqa_pipeline.py:146-320) but generically.
    """
    if value is None:
        return None
    if typ is tuple and isinstance(value, list):
        return tuple(value)
    if typ is list and isinstance(value, tuple):
        return list(value)
    origin = get_origin(typ)
    if origin is not None:
        args = [a for a in get_args(typ) if a is not type(None)]
        if origin is list or origin is tuple:
            inner = args[0] if args else Any
            seq = [_coerce(v, inner) for v in value]
            return tuple(seq) if origin is tuple else seq
        if origin is dict:
            return dict(value)
        # Optional[X] / Union — try each arm.
        for a in args:
            try:
                return _coerce(value, a)
            except (TypeError, ValueError):
                continue
        return value
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return dataclass_from_dict(typ, value)
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str) and not isinstance(value, typ):
        return typ(value)
    return value


def dataclass_from_dict(cls: Type[T], data: dict[str, Any]) -> T:
    hints = get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    unknown = []
    for k, v in data.items():
        if k in names:
            kwargs[k] = _coerce(v, hints.get(k, Any))
        else:
            unknown.append(k)
    if unknown:
        import logging
        logging.getLogger("vivqa_tpu_torch.config").warning(
            "ignoring unknown config keys for %s: %s", cls.__name__, unknown)
    return cls(**kwargs)


def dataclass_to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: dataclass_to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [dataclass_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: dataclass_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, Path):
        return str(obj)
    return obj


class ConfigBase:
    """Mixin giving any dataclass from_dict / from_yaml / to_dict / to_yaml /
    replace, with recursive nested-dataclass support."""

    @classmethod
    def from_dict(cls: Type[T], data: dict[str, Any]) -> T:
        return dataclass_from_dict(cls, data)

    @classmethod
    def from_yaml(cls: Type[T], path: str | Path, section: str | None = None) -> T:
        from vivqa_tpu_torch.utils.yaml_io import load_yaml
        data = load_yaml(path)
        if section is not None:
            data = data.get(section, {})
        return cls.from_dict(data)

    def to_dict(self) -> dict[str, Any]:
        return dataclass_to_dict(self)

    def to_yaml(self, path: str | Path) -> None:
        from vivqa_tpu_torch.utils.yaml_io import save_yaml
        save_yaml(self.to_dict(), path)

    def replace(self: T, **changes: Any) -> T:
        return dataclasses.replace(self, **changes)


def merge_cli_overrides(config: T, overrides: dict[str, Any]) -> T:
    """Apply CLI overrides (highest precedence). Dotted keys reach into
    nested dataclass fields: ``fusion.fusion_type=mcan``. ``None`` values
    (unset argparse flags) are skipped."""
    updates: dict[str, Any] = {}
    for key, value in overrides.items():
        if value is None:
            continue
        parts = key.split(".")
        if len(parts) == 1:
            if hasattr(config, key):
                hints = get_type_hints(type(config))
                updates[key] = _coerce(value, hints.get(key, Any))
        else:
            head, rest = parts[0], ".".join(parts[1:])
            if hasattr(config, head):
                sub = updates.get(head, getattr(config, head))
                updates[head] = merge_cli_overrides(sub, {rest: value})
    return dataclasses.replace(config, **updates) if updates else config
